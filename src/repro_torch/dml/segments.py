"""Append-segment slot allocator + wear-leveling model.

The counterpart of ``repro.dml.segments``, equal to it apart from this note
and its import lines.

One record slot is one crossbar row (paper Table 3 geometry): every
cell write a mutation performs lands on the row holding that slot, so
*which free slot an INSERT picks* decides the per-row write profile —
the quantity the paper's endurance analysis (§7) bounds.

Two policies:

``first_fit``
    Always the lowest free slot. Under churn (a streaming staging
    buffer: insert a batch, expire the previous batch) the same few
    just-freed rows are re-programmed every round — the busiest row
    absorbs the whole stream's write pressure.

``rotate``
    A rotation cursor walks the capacity and wraps; freed slots are not
    reused until the cursor comes around again. Inserts spread across
    every row of the append segment, flattening the profile by roughly
    ``capacity / working-set`` — the wear-leveling model this package
    ships (and the ``htap_stream`` bench gates at <= 0.5x first-fit).

The allocator keeps per-slot cell-write counters and a *logical* event
log (slot-free, so it can be replayed through a fresh allocator of the
other policy: :func:`replay` yields the counterfactual write profile on
the identical mutation trace).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core import bitslice

#: Slots added per capacity growth — one tile, so plane arrays grow in
#: whole ``TILE_WORDS`` multiples and the layout signature changes once
#: per growth, not per insert.
GROWTH_SLOTS = bitslice.TILE_RECORDS


@dataclasses.dataclass(frozen=True)
class SlotEvent:
    """One logical allocator transition. ``op`` is ``insert`` /
    ``delete`` / ``compact``; ``ids`` are logical row ids;
    ``cells_per_row`` is the cell writes each touched row absorbs."""
    op: str
    ids: Tuple[int, ...]
    cells_per_row: float


class AppendSegments:
    """Slot allocator over ``capacity`` crossbar-row slots.

    ``n_packed`` initial slots are pre-occupied by the bulk load (which
    is formatting, not DML — it does not count toward wear).
    """

    def __init__(self, capacity: int, n_packed: int = 0,
                 policy: str = "rotate") -> None:
        if policy not in ("rotate", "first_fit"):
            raise ValueError(f"unknown wear policy: {policy!r}")
        self.policy = policy
        self.capacity = int(capacity)
        self.writes = np.zeros(self.capacity, dtype=np.float64)
        self._used = np.zeros(self.capacity, dtype=bool)
        self._used[:n_packed] = True
        # Retired slots (endurance-dead or stuck rows, quarantined by the
        # fault-recovery layer): permanently marked used so ``alloc``
        # never hands them out again, and ``repack`` routes around them.
        self._retired = np.zeros(self.capacity, dtype=bool)
        self._cursor = n_packed % max(1, self.capacity)
        self.events: List[SlotEvent] = []
        self.grown_tiles = 0

    # -- capacity ---------------------------------------------------------
    @property
    def n_free(self) -> int:
        return int(self.capacity - self._used.sum())

    def grow(self, slots: int = GROWTH_SLOTS) -> None:
        self.writes = np.concatenate(
            [self.writes, np.zeros(slots, dtype=np.float64)])
        self._used = np.concatenate(
            [self._used, np.zeros(slots, dtype=bool)])
        self._retired = np.concatenate(
            [self._retired, np.zeros(slots, dtype=bool)])
        self.capacity += slots
        self.grown_tiles += slots // bitslice.TILE_RECORDS

    # -- policy -----------------------------------------------------------
    def alloc(self, k: int) -> np.ndarray:
        """Pick ``k`` free slots by policy. Grows capacity (in tile
        multiples) when fewer than ``k`` slots are free."""
        while self.n_free < k:
            self.grow()
        free = np.flatnonzero(~self._used)
        if self.policy == "first_fit":
            slots = free[:k]
        else:  # rotate: first free slots at/after the cursor, wrapping
            pos = np.searchsorted(free, self._cursor)
            slots = np.concatenate([free[pos:], free[:pos]])[:k]
            self._cursor = (int(slots[-1]) + 1) % self.capacity if k else \
                self._cursor
        self._used[slots] = True
        return np.sort(slots)

    def free(self, slots: Sequence[int]) -> None:
        idx = np.asarray(slots, dtype=np.int64)
        self._used[idx] = self._retired[idx]   # retired slots stay occupied

    def retire(self, slots: Sequence[int]) -> None:
        """Permanently quarantine slots (dead/stuck rows): marked both
        retired and used, so neither ``alloc`` nor ``repack`` ever
        places a record on them again."""
        idx = np.asarray(slots, dtype=np.int64)
        self._retired[idx] = True
        self._used[idx] = True

    @property
    def n_retired(self) -> int:
        return int(self._retired.sum())

    def record_writes(self, slots: Sequence[int], cells_per_row: float) -> None:
        self.writes[np.asarray(slots, dtype=np.int64)] += cells_per_row

    def repack(self, n_live: int) -> np.ndarray:
        """Compaction occupancy: live rows fill the ``n_live`` lowest
        NON-retired slots (identical to ``[0, n_live)`` while nothing is
        retired).  Returns the chosen slots in ascending order."""
        slots = np.flatnonzero(~self._retired)[:n_live]
        self._used[:] = self._retired
        self._used[slots] = True
        return slots

    # -- profile ----------------------------------------------------------
    def busiest_row_ops(self) -> float:
        """Max accumulated cell writes on any single row (slot)."""
        return float(self.writes.max()) if self.capacity else 0.0

    def total_cell_writes(self) -> float:
        return float(self.writes.sum())

    def log(self, op: str, ids: Sequence[int], cells_per_row: float) -> None:
        self.events.append(SlotEvent(op, tuple(int(i) for i in ids),
                                     float(cells_per_row)))


def replay(events: Sequence[SlotEvent], capacity: int, n_packed: int,
           policy: str) -> AppendSegments:
    """Re-run a logical mutation trace through a fresh allocator.

    Logical row ids are stable across policies, so the same trace maps
    rows to *different* slots under a different policy — this is the
    counterfactual the wear-leveling claim is measured against:

        leveled.busiest_row_ops() <= 0.5 * replay(..., "first_fit").busiest_row_ops()
    """
    seg = AppendSegments(capacity, n_packed, policy)
    slot_of: Dict[int, int] = {i: i for i in range(n_packed)}
    for ev in events:
        if ev.op == "insert":
            slots = seg.alloc(len(ev.ids))
            for lid, s in zip(ev.ids, slots):
                slot_of[lid] = int(s)
            seg.record_writes(slots, ev.cells_per_row)
        elif ev.op == "delete":
            slots = [slot_of.pop(lid) for lid in ev.ids]
            seg.free(slots)
            seg.record_writes(slots, ev.cells_per_row)
        elif ev.op == "update":
            slots = [slot_of[lid] for lid in ev.ids]
            seg.record_writes(slots, ev.cells_per_row)
        elif ev.op == "compact":
            # Live rows (in logical order) repack into the lowest slots
            # (replayed traces never contain repairs, so no slot of a
            # replay allocator is ever retired).
            live = sorted(slot_of)
            slots = seg.repack(len(live))
            for lid, s in zip(live, slots):
                slot_of[lid] = int(s)
            seg.record_writes(slots, ev.cells_per_row)
        else:  # pragma: no cover - log is produced by this module only
            raise ValueError(f"unknown slot event {ev.op!r}")
    return seg
