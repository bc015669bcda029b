"""DML over a bit-plane relation: mutation -> ISA write program -> apply.

The counterpart of ``repro.dml.apply``. The planes stay on the
relation's device: growth and widening append zero words there, and
every write program runs through the port's eager
:class:`~repro_torch.core.engine.Engine`, whose ``PlaneWrite`` /
``ValidClear`` merge host-built row masks into the planes as torch ops
on that device.

:class:`RelationDml` owns the mutable state of one resident relation:

* the :class:`~repro_torch.core.engine.PimRelation` snapshot (planes span the
  reserved capacity; ``layout.n_records`` is the record *watermark* —
  highest occupied slot + 1 — so query readback covers every live row);
* slot-aligned shadow columns + a live bitmap (the encoded values the
  planes hold, kept host-side so predicates and re-packs never need a
  device readback);
* a logical-id -> slot map (ids are stable; slots move on update-by-move
  and compaction);
* the :class:`~repro_torch.dml.segments.AppendSegments` allocator, which picks
  slots, meters per-row wear, and logs the replayable event trace.

Every mutation is *emitted* as ``isa.PlaneWrite`` / ``isa.ValidClear``
instructions first and then *executed* through the eager
:class:`~repro_torch.core.engine.Engine` — the same executor the query
side uses — so the cost model and the ``analysis`` endurance pass see
real per-cell write pressure, not a side-channel estimate. Emitted
programs are retained (``self.programs``) for the lint sweep.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bitslice, cost_model, isa
from repro_torch.core.engine import Engine, PimRelation
from repro_torch.db import queries as Q

from .mutations import Compact, Delete, Insert, Update
from .segments import AppendSegments


def _check_width(attr: str, values: np.ndarray, n_bits: int) -> None:
    if values.size and int(values.max()) >= (1 << n_bits):
        raise ValueError(
            f"value {int(values.max())} for {attr!r} exceeds its "
            f"{n_bits}-bit plane stack")
    if values.size and int(values.min()) < 0:
        raise ValueError(f"negative value for {attr!r}: encode offset first")


@dataclasses.dataclass
class MutationStats:
    """Per-mutation accounting surfaced by ``PimDatabase.apply``."""
    op: str
    n_rows: int
    n_instructions: int
    cycles: int
    cells_written: int

    @classmethod
    def from_program(cls, op: str, n_rows: int,
                     instrs: Sequence[isa.PimInstruction]) -> "MutationStats":
        cost = cost_model.classify_program(instrs)
        return cls(op, n_rows, len(list(instrs)), cost.cycles_total,
                   cost.cells_written)


class RelationDml:
    """Mutable view over one resident relation (see module docstring)."""

    def __init__(self, rel: PimRelation, columns: Mapping[str, np.ndarray],
                 policy: str = "rotate") -> None:
        n = rel.n_records
        layout = rel.layout
        if layout.capacity_words is None:
            layout = dataclasses.replace(layout,
                                         capacity_words=layout.n_words)
            rel = dataclasses.replace(rel, layout=layout)
        self.rel = rel
        cap = layout.capacity_records
        self.shadow: Dict[str, np.ndarray] = {}
        for name in layout.attributes:
            col = np.asarray(columns[name], dtype=np.int64)
            if col.shape[0] != n:
                raise ValueError(f"column {name} length != n_records")
            buf = np.zeros(cap, dtype=np.int64)
            buf[:n] = col
            self.shadow[name] = buf
        self.live = np.zeros(cap, dtype=bool)
        self.live[:n] = True
        self.slot_of: Dict[int, int] = {i: i for i in range(n)}
        self.next_id = n
        self.n_packed = n                    # bulk-load size, for replay
        self.segments = AppendSegments(cap, n_packed=n, policy=policy)
        self.trace: List[isa.PimInstruction] = []
        self.programs: List[Tuple[str, Tuple[isa.PimInstruction, ...]]] = []
        self.stats: List[MutationStats] = []
        # Integrity observer (``faults.FaultManager``): when set, every
        # executed write program is verified against its intended values.
        self.integrity = None

    # -- storage ----------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.rel.layout.capacity_records

    def live_ids(self) -> List[int]:
        return sorted(self.slot_of)

    def live_columns(self) -> Dict[str, np.ndarray]:
        """Live rows in logical-id order — the ``db.tables`` view."""
        slots = np.asarray([self.slot_of[i] for i in self.live_ids()],
                           dtype=np.int64)
        return {a: buf[slots] for a, buf in self.shadow.items()}

    def _grow_storage(self, words: int = bitslice.TILE_WORDS) -> None:
        """Extend every plane (and the host shadow) by whole tiles. This
        changes ``layout.n_words`` — the one DML event that invalidates
        compiled executables, by design confined to tile granularity."""
        rel = self.rel
        planes = {a: torch.cat([p, torch.zeros((p.shape[0], words),
                                               dtype=torch.int32,
                                               device=p.device)], dim=1)
                  for a, p in rel.planes.items()}
        valid = torch.cat([rel.valid, torch.zeros(
            (words,), dtype=torch.int32, device=rel.valid.device)])
        layout = dataclasses.replace(
            rel.layout, capacity_words=rel.layout.n_words + words)
        self.rel = dataclasses.replace(rel, layout=layout, planes=planes,
                                       valid=valid)
        add = words * bitslice.WORD_BITS
        for a in self.shadow:
            self.shadow[a] = np.concatenate(
                [self.shadow[a], np.zeros(add, dtype=np.int64)])
        self.live = np.concatenate([self.live, np.zeros(add, dtype=bool)])

    def _alloc(self, k: int) -> np.ndarray:
        while self.segments.n_free < k:
            self.segments.grow()
            self._grow_storage()
        return self.segments.alloc(k)

    def _set_watermark(self, wm: int) -> None:
        if wm != self.rel.layout.n_records:
            layout = dataclasses.replace(self.rel.layout, n_records=wm)
            self.rel = dataclasses.replace(self.rel, layout=layout,
                                           n_records=wm)

    def _run(self, op: str, n_rows: int,
             instrs: Sequence[isa.PimInstruction]) -> None:
        eng = Engine(self.rel)
        for ins in instrs:
            eng.execute(ins)
        self.rel = eng.rel
        self.trace.extend(instrs)
        self.programs.append((op, tuple(instrs)))
        self.stats.append(MutationStats.from_program(op, n_rows, instrs))
        if self.integrity is not None:
            self.integrity.after_write(self, op, instrs)

    # -- selection --------------------------------------------------------
    def _resolve(self, pred=None, row_ids: Optional[Sequence[int]] = None
                 ) -> Tuple[List[int], np.ndarray]:
        """Selected (ascending logical ids, their slots). Per-row
        assignment sequences align with this order — the same convention
        as the NumPy oracle."""
        if row_ids is not None:
            ids = sorted({int(i) for i in row_ids})
            missing = [i for i in ids if i not in self.slot_of]
            if missing:
                raise KeyError(f"unknown/deleted row ids: {missing[:5]}")
        elif pred is not None:
            mask = np.asarray(Q.eval_pred(self.live_columns(), pred),
                              dtype=bool)
            ids = [lid for lid, m in zip(self.live_ids(), mask) if m]
        else:
            ids = []
        slots = np.asarray([self.slot_of[i] for i in ids], dtype=np.int64)
        return ids, slots

    # -- mutations --------------------------------------------------------
    def insert(self, rows: Mapping[str, Sequence[int]]) -> List[int]:
        attrs = self.rel.layout.attributes
        if set(rows) != set(attrs):
            raise ValueError(
                f"insert columns {sorted(rows)} != relation attributes "
                f"{sorted(attrs)}")
        vals = {a: np.asarray(rows[a], dtype=np.int64) for a in attrs}
        k = next(iter(vals.values())).shape[0]
        for a, v in vals.items():
            if v.shape[0] != k:
                raise ValueError(f"insert column {a} length mismatch")
            _check_width(a, v, attrs[a].n_bits)
        if k == 0:
            return []
        slots = self._alloc(k)
        ids = list(range(self.next_id, self.next_id + k))
        self.next_id += k
        instrs: List[isa.PimInstruction] = [
            isa.PlaneWrite(dest=a, rows=tuple(int(s) for s in slots),
                           values=tuple(int(x) for x in vals[a]),
                           n_bits=attrs[a].n_bits)
            for a in attrs]
        instrs.append(isa.PlaneWrite(
            dest="__valid__", rows=tuple(int(s) for s in slots),
            values=(1,) * k, n_bits=1))
        self._run("insert", k, instrs)
        for a in attrs:
            self.shadow[a][slots] = vals[a]
        self.live[slots] = True
        for lid, s in zip(ids, slots):
            self.slot_of[lid] = int(s)
        self._set_watermark(max(self.rel.layout.n_records,
                                int(slots.max()) + 1))
        rb = self.rel.layout.row_bits
        self.segments.record_writes(slots, rb)
        self.segments.log("insert", ids, rb)
        return ids

    def delete(self, pred=None, row_ids: Optional[Sequence[int]] = None
               ) -> List[int]:
        ids, slots = self._resolve(pred, row_ids)
        if not ids:
            return []
        self._run("delete", len(ids), [
            isa.ValidClear(dest="__valid__",
                           rows=tuple(int(s) for s in slots))])
        self.live[slots] = False
        for lid in ids:
            del self.slot_of[lid]
        self.segments.free(slots)
        self.segments.record_writes(slots, 1.0)
        self.segments.log("delete", ids, 1.0)
        return ids

    def update(self, assignments: Mapping[str, object], pred=None,
               row_ids: Optional[Sequence[int]] = None) -> int:
        ids, slots = self._resolve(pred, row_ids)
        k = len(ids)
        if k == 0:
            return 0
        attrs = self.rel.layout.attributes
        new_vals: Dict[str, np.ndarray] = {}
        for a, val in assignments.items():
            if a not in attrs:
                raise KeyError(f"unknown attribute {a!r}")
            v = np.asarray(val, dtype=np.int64)
            new_vals[a] = np.full(k, int(v), dtype=np.int64) if v.ndim == 0 \
                else v[:k].copy()
            if new_vals[a].size and int(new_vals[a].min()) < 0:
                raise ValueError(f"negative value for {a!r}")
        fits = all(int(v.max()) < (1 << attrs[a].n_bits)
                   for a, v in new_vals.items() if v.size)
        if fits:
            # In-place plane rewrite: widths permit, rows stay put.
            instrs = [
                isa.PlaneWrite(dest=a, rows=tuple(int(s) for s in slots),
                               values=tuple(int(x) for x in new_vals[a]),
                               n_bits=attrs[a].n_bits)
                for a in new_vals]
            self._run("update", k, instrs)
            for a, v in new_vals.items():
                self.shadow[a][slots] = v
            cells = float(sum(attrs[a].n_bits for a in new_vals))
            self.segments.record_writes(slots, cells)
            self.segments.log("update", ids, cells)
            return k
        # Widths do not permit: widen the overflowing plane stacks (a
        # deliberate layout change — dependent programs recompile), then
        # move the rows delete+insert style through the allocator.
        for a, v in new_vals.items():
            need = int(v.max()).bit_length()
            if need > attrs[a].n_bits:
                self._widen(a, need)
        attrs = self.rel.layout.attributes
        old_slots = slots
        self._run("update.delete", k, [
            isa.ValidClear(dest="__valid__",
                           rows=tuple(int(s) for s in old_slots))])
        self.live[old_slots] = False
        self.segments.free(old_slots)
        self.segments.record_writes(old_slots, 1.0)
        self.segments.log("delete", ids, 1.0)
        merged = {a: self.shadow[a][old_slots].copy() for a in attrs}
        for a, v in new_vals.items():
            merged[a] = v
        slots = self._alloc(k)
        instrs = [
            isa.PlaneWrite(dest=a, rows=tuple(int(s) for s in slots),
                           values=tuple(int(x) for x in merged[a]),
                           n_bits=attrs[a].n_bits)
            for a in attrs]
        instrs.append(isa.PlaneWrite(
            dest="__valid__", rows=tuple(int(s) for s in slots),
            values=(1,) * k, n_bits=1))
        self._run("update.insert", k, instrs)
        for a in attrs:
            self.shadow[a][slots] = merged[a]
        self.live[slots] = True
        for lid, s in zip(ids, slots):
            self.slot_of[lid] = int(s)
        self._set_watermark(max(self.rel.layout.n_records,
                                int(slots.max()) + 1))
        rb = self.rel.layout.row_bits
        self.segments.record_writes(slots, rb)
        self.segments.log("insert", ids, rb)
        return k

    def _widen(self, attr: str, n_bits: int) -> None:
        rel = self.rel
        old = rel.layout.attributes[attr]
        p = rel.planes[attr]
        pad = torch.zeros((n_bits - old.n_bits, rel.layout.n_words),
                          dtype=torch.int32, device=p.device)
        planes = dict(rel.planes)
        planes[attr] = torch.cat([p, pad], dim=0)
        attrs = dict(rel.layout.attributes)
        attrs[attr] = bitslice.AttributeLayout(attr, n_bits, old.encoding)
        layout = dataclasses.replace(rel.layout, attributes=attrs)
        self.rel = dataclasses.replace(rel, layout=layout, planes=planes)

    def compact(self) -> int:
        """GC deleted rows: repack live rows (logical order) into the
        lowest non-retired slots, clear every stale valid bit above,
        reset the watermark.  Wear counters persist — compaction is real
        write pressure.  (Without retired slots the targets are exactly
        ``[0, k)``, the pre-fault-tolerance behaviour.)"""
        ids = self.live_ids()
        k = len(ids)
        cols = self.live_columns()
        attrs = self.rel.layout.attributes
        old_slots = {int(self.slot_of[i]) for i in ids}
        slot_arr = self.segments.repack(k)
        new_slots = tuple(int(s) for s in slot_arr)
        stale = sorted(old_slots - set(new_slots))
        instrs: List[isa.PimInstruction] = [
            isa.PlaneWrite(dest=a, rows=new_slots,
                           values=tuple(int(x) for x in cols[a]),
                           n_bits=attrs[a].n_bits)
            for a in attrs]
        instrs.append(isa.PlaneWrite(dest="__valid__", rows=new_slots,
                                     values=(1,) * k, n_bits=1))
        if stale:
            instrs.append(isa.ValidClear(dest="__valid__",
                                         rows=tuple(stale)))
        self._run("compact", k, instrs)
        for a in attrs:
            self.shadow[a][slot_arr] = cols[a]
        self.live[:] = False
        self.live[slot_arr] = True
        self.slot_of = {lid: int(s) for lid, s in zip(ids, slot_arr)}
        self.segments.record_writes(slot_arr, self.rel.layout.row_bits)
        self.segments.log("compact", (), self.rel.layout.row_bits)
        self._set_watermark(int(slot_arr.max()) + 1 if k else 0)
        return k

    # -- fault recovery (``faults``) ----------------------------------------
    def rewrite_rows(self, slots: Sequence[int]) -> int:
        """Repair soft (transient) corruption in place: re-program every
        listed slot from the host shadow — live slots get their full
        attribute row plus a valid set, non-live slots are zeroed and
        valid-cleared (a ghost row made visible by a flipped valid bit
        goes back to invisible).  Not logged to the allocator event
        trace: repairs are maintenance writes, not workload, so the
        wear-policy replay counterfactual stays an apples-to-apples
        comparison (wear counters still accrue — repair is real write
        pressure)."""
        slots = sorted({int(s) for s in slots})
        if not slots:
            return 0
        attrs = self.rel.layout.attributes
        rows = tuple(slots)
        live_rows = tuple(s for s in slots if self.live[s])
        ghost_rows = tuple(s for s in slots if not self.live[s])
        instrs: List[isa.PimInstruction] = [
            isa.PlaneWrite(
                dest=a,
                rows=rows,
                values=tuple(int(self.shadow[a][s]) if self.live[s] else 0
                             for s in slots),
                n_bits=attrs[a].n_bits)
            for a in attrs]
        if live_rows:
            instrs.append(isa.PlaneWrite(
                dest="__valid__", rows=live_rows,
                values=(1,) * len(live_rows), n_bits=1))
        if ghost_rows:
            instrs.append(isa.ValidClear(dest="__valid__",
                                         rows=ghost_rows))
        self._run("repair.rewrite", len(slots), instrs)
        self.segments.record_writes(np.asarray(slots, dtype=np.int64),
                                    self.rel.layout.row_bits)
        return len(slots)

    def remap_rows(self, slots: Sequence[int]) -> int:
        """Repair hard faults (endurance-dead or stuck rows): move every
        live record off the listed slots into freshly allocated spare
        capacity — the update-by-move machinery under stable logical ids
        — and permanently retire the faulty slots so the allocator never
        places a record there again.  Returns the number of rows moved.
        Like :meth:`rewrite_rows`, excluded from the replayable event
        trace."""
        slots = sorted({int(s) for s in slots})
        if not slots:
            return 0
        attrs = self.rel.layout.attributes
        moving = [lid for lid in self.live_ids()
                  if int(self.slot_of[lid]) in set(slots)]
        old_slots = np.asarray([self.slot_of[lid] for lid in moving],
                               dtype=np.int64)
        saved = {a: self.shadow[a][old_slots].copy() for a in attrs}
        # Quarantine first: every faulty slot goes invisible (the valid
        # plane always programs, in the reference's fault model too), then
        # gets retired so _alloc below cannot hand it back.
        self._run("repair.remap.clear", len(slots), [
            isa.ValidClear(dest="__valid__", rows=tuple(slots))])
        self.live[slots] = False
        self.segments.retire(slots)
        self.segments.record_writes(np.asarray(slots, dtype=np.int64), 1.0)
        k = len(moving)
        if k:
            new_slots = self._alloc(k)
            attrs = self.rel.layout.attributes
            instrs = [
                isa.PlaneWrite(dest=a,
                               rows=tuple(int(s) for s in new_slots),
                               values=tuple(int(x) for x in saved[a]),
                               n_bits=attrs[a].n_bits)
                for a in attrs]
            instrs.append(isa.PlaneWrite(
                dest="__valid__", rows=tuple(int(s) for s in new_slots),
                values=(1,) * k, n_bits=1))
            self._run("repair.remap.insert", k, instrs)
            for a in attrs:
                self.shadow[a][new_slots] = saved[a]
            self.live[new_slots] = True
            for lid, s in zip(moving, new_slots):
                self.slot_of[lid] = int(s)
            self._set_watermark(max(self.rel.layout.n_records,
                                    int(new_slots.max()) + 1))
            self.segments.record_writes(new_slots,
                                        self.rel.layout.row_bits)
        return k

    # -- dispatch ---------------------------------------------------------
    def apply(self, mutation) -> MutationStats:
        n_before = len(self.stats)
        if isinstance(mutation, Insert):
            self.insert(mutation.rows)
        elif isinstance(mutation, Delete):
            self.delete(mutation.pred, mutation.row_ids)
        elif isinstance(mutation, Update):
            self.update(mutation.assignments, mutation.pred,
                        mutation.row_ids)
        elif isinstance(mutation, Compact):
            self.compact()
        else:
            raise TypeError(f"not a DML mutation: {mutation!r}")
        if len(self.stats) == n_before:
            # Zero-row mutation (empty insert, selection matched nothing):
            # no program ran, so report zeros — never a stale entry.
            return MutationStats(type(mutation).__name__.lower(), 0, 0, 0, 0)
        return self.stats[-1]
