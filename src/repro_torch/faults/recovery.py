"""Fault recovery: verify-after-write, scrubbing, remap, retry, breaker.

The counterpart of ``repro.faults.recovery``. Three recovery mechanisms,
one per fault class in ``model``:

``FaultManager``
    The integrity/repair brain. Guards relations with
    :class:`repro_torch.faults.guard.RelationGuard` parity planes,
    observes every DML write program (``RelationDml`` calls
    ``after_write``), verifies each data ``PlaneWrite`` by reading the
    written slots back (only their words: gathered on the device, decoded
    on the host by ``bitslice.unpack_rows``) against the intended values,
    and on ``scrub()`` diffs parity, classifies corruption as *soft*
    (in-place ``rewrite_rows`` from the host shadow) or *hard*
    (``remap_rows`` into spare append-segment capacity + permanent slot
    retirement + guard quarantine), then republishes repaired relations
    through ``PimDatabase.publish`` — the version bump means every cached
    result computed against corrupt contents misses by construction.

``RetryPolicy``
    Capped exponential backoff for transient dispatch faults (the
    dispatch raised cleanly; nothing was corrupted; try again).

``CircuitBreaker``
    closed -> open -> half_open. When FUSED dispatch keeps failing past
    retries, the breaker opens and the serving layer degrades those
    windows to the EAGER engine (slower, but the query is answered, on
    the same device); after a cooldown a half-open probe re-attempts
    FUSED and a success closes the breaker.  Single-threaded on the
    serving layer's 1-wide dispatch pool, so no locking.

While a ``torch.profiler`` session runs, a scrub is recorded as a
``faults.scrub`` span, each repaired relation inside it as
``faults.repair``, and each verify-after-write read-back as
``faults.verify`` (``core.spans``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core import bitslice, engine, isa, spans

from . import guard
from .guard import VALID, RelationGuard
from .model import DeviceFaultModel


@dataclasses.dataclass
class RetryPolicy:
    """Capped exponential backoff for transient dispatch faults."""
    max_retries: int = 2
    base_delay_s: float = 0.001
    max_delay_s: float = 0.050

    def delay(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (0-based)."""
        return min(self.base_delay_s * (2.0 ** attempt), self.max_delay_s)


class CircuitBreaker:
    """FUSED-dispatch circuit breaker (closed / open / half_open).

    ``record_failure`` counts *post-retry* window failures; at
    ``failure_threshold`` consecutive failures the breaker opens and
    ``allow_fused`` answers False for ``cooldown_windows`` windows
    (those run degraded on EAGER).  The next window after cooldown is a
    half-open probe: its success closes the breaker, its failure
    re-opens immediately.
    """

    def __init__(self, failure_threshold: int = 2,
                 cooldown_windows: int = 2) -> None:
        self.failure_threshold = int(failure_threshold)
        self.cooldown_windows = int(cooldown_windows)
        self.state = "closed"
        self._failures = 0
        self._cooldown = 0
        self.n_trips = 0
        self.n_recoveries = 0

    def allow_fused(self) -> bool:
        if self.state == "closed":
            return True
        if self.state == "open":
            self._cooldown -= 1
            if self._cooldown > 0:
                return False
            self.state = "half_open"
        return True                      # half-open probe

    def record_success(self) -> None:
        if self.state != "closed":
            self.n_recoveries += 1
        self.state = "closed"
        self._failures = 0

    def record_failure(self) -> None:
        self._failures += 1
        if self.state == "half_open" or \
                self._failures >= self.failure_threshold:
            self.state = "open"
            self._cooldown = self.cooldown_windows
            self._failures = 0
            self.n_trips += 1


def _to_int32(word: int) -> int:
    """A uint32 word as the int32 of the same bits (bit 31 -> negative)."""
    word &= 0xFFFFFFFF
    return word - (1 << 32) if word >> 31 else word


class FaultManager:
    """Integrity + repair controller over one
    :class:`~repro_torch.db.database.PimDatabase`.

    Also the ``RelationDml.integrity`` observer: ``after_write`` runs
    on every DML program (including its own repair programs, which is
    what keeps the parity expectation exact across repairs).

    ``scrub_log`` holds ``(wall_s, bytes copied off the device)`` of each
    :meth:`scrub`, ``write_check_bytes`` the bytes each :meth:`after_write`
    read back.
    """

    def __init__(self, db, model: DeviceFaultModel | None = None,
                 retry: RetryPolicy | None = None,
                 breaker: CircuitBreaker | None = None,
                 endurance_budget: float = float("inf")) -> None:
        self.db = db
        self.model = model or DeviceFaultModel()
        self.retry = retry or RetryPolicy()
        self.breaker = breaker or CircuitBreaker()
        self.endurance_budget = float(endurance_budget)
        self.guards: Dict[str, RelationGuard] = {}
        # rel -> {(plane_name, slot)} flagged by verify-after-write,
        # repaired at the next scrub.
        self._pending: Dict[str, Set[Tuple[str, int]]] = {}
        self.injected: Set[Tuple[str, str, int]] = set()
        self.detected: Set[Tuple[str, str, int]] = set()
        self._prev_hook = None
        self._armed = False
        self.n_injected = 0
        self.n_detected = 0
        self.n_write_faults = 0
        self.n_repaired_rows = 0
        self.n_remapped_rows = 0
        self.n_worn_dead = 0
        self.n_scrubs = 0
        self.scrub_log: List[Tuple[float, int]] = []
        self.write_check_bytes: List[int] = []

    # -- lifecycle ---------------------------------------------------------
    def arm(self) -> None:
        """Install the device-fault model as the engine write hook."""
        if not self._armed:
            self._prev_hook = engine.install_write_fault_hook(self.model)
            self._armed = True

    def disarm(self) -> None:
        if self._armed:
            engine.install_write_fault_hook(self._prev_hook)
            self._prev_hook = None
            self._armed = False

    def guard_relation(self, rel_name: str) -> RelationGuard:
        """Attach parity guard planes to a relation (pack-time planes
        are trusted) and start observing its DML write programs."""
        d = self.db.dml_state(rel_name)
        g = RelationGuard(d.rel)
        self.guards[rel_name] = g
        d.integrity = self
        return g

    # -- DML observer (RelationDml.integrity protocol) ---------------------
    def after_write(self, d, op: str, instrs: Sequence[object]) -> None:
        """Fold a just-executed write program into the parity
        expectation, then verify every data ``PlaneWrite`` by reading
        the written slots back.  Verification is after the *whole*
        program because a program never writes one slot twice (the DML
        layer dedupes; repair programs target disjoint slot sets).

        Only the words holding the written slots leave the device: the
        ``(n_bits, k)`` block ``planes[:, rows // 32]``."""
        g = self.guards.get(d.rel.name)
        if g is None:
            return
        before = guard.readback_bytes
        n_words = d.rel.layout.n_words
        pend = self._pending.setdefault(d.rel.name, set())
        for instr in instrs:
            g.observe(instr, n_words)
        with spans.span("faults.verify") as sp:
            for instr in instrs:
                if not isinstance(instr, isa.PlaneWrite) \
                        or instr.dest == VALID or not instr.rows:
                    continue   # the valid plane always programs (SLC)
                rows = np.asarray(instr.rows, np.int64)
                planes = d.rel.planes[instr.dest]
                words = torch.as_tensor(rows // bitslice.WORD_BITS,
                                        device=planes.device)
                block = guard.to_host(planes[:, words])
                local = (np.arange(rows.shape[0], dtype=np.int64)
                         * bitslice.WORD_BITS + rows % bitslice.WORD_BITS)
                got = bitslice.unpack_rows(block, local)
                want = np.asarray(instr.values, np.uint64)
                for i in np.flatnonzero(got != want):
                    pend.add((instr.dest, int(rows[i])))
                    self.n_write_faults += 1
            sp.set(bytes=guard.readback_bytes - before)
        self.write_check_bytes.append(guard.readback_bytes - before)

    # -- fault injection (chaos harness / tests) ---------------------------
    def _mutate_word(self, rel_name: str, attr: str, plane: int, word: int,
                     fn: Callable[[int], int]) -> None:
        """Replace one stored word by ``fn(old word)`` (uint32 Python ints)
        on the relation's device, in a copy of the plane stack, and
        republish the relation WITHOUT a version bump — silent device
        corruption must not invalidate caches by itself; only detection
        + repair may."""
        d = self.db.dml_state(rel_name)
        if attr == VALID:
            v = d.rel.valid.clone()
            v[word] = _to_int32(fn(int(v[word]) & 0xFFFFFFFF))
            d.rel = dataclasses.replace(d.rel, valid=v)
        else:
            planes = dict(d.rel.planes)
            p = planes[attr].clone()
            p[plane, word] = _to_int32(fn(int(p[plane, word]) & 0xFFFFFFFF))
            planes[attr] = p
            d.rel = dataclasses.replace(d.rel, planes=planes)
        self.db.relations[rel_name] = d.rel

    def inject_flip(self, rel_name: str, attr: str, slot: int,
                    plane: int = 0) -> None:
        """Flip one stored cell (soft/transient corruption)."""
        word, bit = divmod(int(slot), bitslice.WORD_BITS)
        self._mutate_word(rel_name, attr, plane, word,
                          lambda w: w ^ (1 << bit))
        self.injected.add((rel_name, attr, int(slot)))
        self.n_injected += 1

    def inject_stuck(self, rel_name: str, attr: str, slot: int,
                     plane: int, value: int) -> None:
        """Make one cell stuck-at-``value`` (hard fault) and force the
        stored bit to that value now.  Callers should pick a cell whose
        stored bit differs from ``value`` so the fault is immediately
        observable (a stuck cell matching its content is latent until
        the next write, which verify-after-write then catches)."""
        d = self.db.dml_state(rel_name)
        n_bits = d.rel.planes[attr].shape[0]
        self.model.add_stuck(rel_name, attr, int(slot), int(plane),
                             int(value), n_bits, d.rel.layout.n_words)
        word, bit = divmod(int(slot), bitslice.WORD_BITS)
        mask = 1 << bit
        changed = []

        def force(w):
            changed.append(bool(w & mask) != bool(value))
            return (w | mask) if value else (w & ~mask)
        self._mutate_word(rel_name, attr, plane, word, force)
        if changed[0]:
            self.injected.add((rel_name, attr, int(slot)))
            self.n_injected += 1

    def update_wear(self, rel_name: str) -> List[int]:
        """Endurance model: slots whose accumulated cell-write counter
        (the real ``dml/segments`` wear counters) crossed the budget
        die — the row stops programming.  Death is *latent*: intact
        contents keep reading correctly; the next write to the row is
        dropped by the hardware and verify-after-write flags it."""
        d = self.db.dml_state(rel_name)
        worn = np.flatnonzero(
            (d.segments.writes >= self.endurance_budget)
            & ~d.segments._retired)
        died = [int(s) for s in worn
                if self.model.add_dead_row(rel_name, int(s))]
        self.n_worn_dead += len(died)
        return died

    # -- scrub + repair ----------------------------------------------------
    def scrub(self) -> Dict[str, Dict[str, object]]:
        """One integrity pass over every guarded relation.

        parity diff + pending write-fault flags -> classify (hard =
        dead row or stuck cell, else soft) -> repair (soft: in-place
        rewrite from host shadow; hard: remap live rows to spare
        capacity, retire + quarantine the slots) -> republish repaired
        relations (version bump => cache invalidation by construction).
        """
        t0 = time.perf_counter()
        before = guard.readback_bytes
        self.n_scrubs += 1
        report: Dict[str, Dict[str, object]] = {}
        repaired: List[str] = []
        with spans.span("faults.scrub", relations=len(self.guards)) as sp:
            for name, g in self.guards.items():
                d = self.db.dml_state(name)
                bad = set(g.scrub(d.rel)) | self._pending.pop(name, set())
                if not bad:
                    continue
                self.n_detected += len(bad)
                for a, s in bad:
                    if (name, a, s) in self.injected:
                        self.detected.add((name, a, s))
                hard = sorted({s for a, s in bad
                               if self.model.is_hard(name, a, s)})
                soft = sorted({s for a, s in bad} - set(hard))
                n_rewritten = n_moved = 0
                with spans.span("faults.repair", relation=name,
                                soft=len(soft), hard=len(hard)) as rp:
                    if soft:
                        n_rewritten = d.rewrite_rows(soft)
                        self.n_repaired_rows += n_rewritten
                    if hard:
                        n_moved = d.remap_rows(hard)
                        g.quarantine(hard)
                        self.n_remapped_rows += n_moved
                    rp.set(rows=n_rewritten + n_moved)
                repaired.append(name)
                report[name] = {
                    "corrupt": sorted(bad), "soft": soft, "hard": hard,
                    "rewritten": n_rewritten, "remapped": n_moved}
            if repaired:
                versions = self.db.publish(repaired)
                for name in repaired:
                    report[name]["version"] = versions[name]
            sp.set(corrupt=sum(len(r["corrupt"]) for r in report.values()),
                   bytes=guard.readback_bytes - before)
        self.scrub_log.append((time.perf_counter() - t0,
                               guard.readback_bytes - before))
        return report

    def undetected(self) -> Set[Tuple[str, str, int]]:
        """Injected-and-observable faults no scrub has caught yet."""
        return self.injected - self.detected
