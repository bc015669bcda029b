"""Per-relation XOR-parity guard planes (integrity layer).

The counterpart of ``repro.faults.guard``. Every guarded relation
carries, for each attribute (and for the valid plane), one extra (W,)
uint32 *guard plane* holding the XOR of that attribute's bit planes —
the per-tile parity column the paper's valid attribute hints at (§5.1):
one extra crossbar column per attribute, and checking it is itself a
bulk-bitwise XOR-reduce, exactly the operation the substrate is good at.

The crucial design decision: the **expected** parity is maintained
*incrementally from the write-instruction stream*, never recomputed
from the (possibly already corrupted) stored planes.  The initial
parity comes from the pack-time planes (trusted: bulk load is
formatting, verified by construction); from then on every
``PlaneWrite`` / ``ValidClear`` updates the expectation from the
instruction's own touch/value masks:

    data PlaneWrite:  parity  = (parity  & ~touch) | (xor-reduce(vals) & touch)
    valid PlaneWrite: parity_v = (parity_v & ~touch) | vals[0]
    ValidClear:       parity_v &= ~touch

(Slots inside ``touch`` are fully re-programmed, so their old parity
contribution is replaced wholesale; slots outside are untouched.)

``scrub(rel)`` then recomputes the *actual* parity from the stored
planes and diffs: any single-cell flip in a column of ``2k+1`` planes
changes the stored XOR, so a single flip is detected with zero false
negatives, and because the expectation tracks the instruction stream
exactly, legitimate writes produce zero false positives.  Retired
(quarantined) slots are excluded from the diff forever — their cells
are allowed to rot.

The stored planes stay where they are: the XOR-reduce runs on the
planes' device and only its (W,) parity word row comes to the host
(counted in :data:`readback_bytes`); the expectation is numpy.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bitslice, engine, isa

U32 = np.uint32
VALID = "__valid__"

#: Bytes the integrity layer has copied from a device to the host (parity
#: rows of scrubs, written words read back after writes).
readback_bytes = 0


def to_host(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> numpy uint32 words, counted in
    :data:`readback_bytes` when the tensor is not on the host."""
    global readback_bytes
    if t.device.type != "cpu":
        readback_bytes += t.numel() * t.element_size()
    return engine.to_words(t)


def xor_reduce(planes: torch.Tensor) -> np.ndarray:
    """(n_bits, W) plane stack -> (W,) uint32 columnwise XOR, reduced on
    the planes' device."""
    acc = torch.zeros(planes.shape[-1], dtype=planes.dtype,
                      device=planes.device)
    for b in range(planes.shape[0]):
        acc = acc ^ planes[b]
    return to_host(acc)


def _xor_reduce_words(planes: np.ndarray) -> np.ndarray:
    """(n_bits, W) uint32 host masks -> (W,) columnwise XOR."""
    out = np.zeros(planes.shape[-1], U32)
    for b in range(planes.shape[0]):
        out ^= planes[b]
    return out


def _diff_slots(name: str, diff: np.ndarray) -> List[Tuple[str, int]]:
    bad: List[Tuple[str, int]] = []
    for w in np.flatnonzero(diff):
        d = int(diff[w])
        for bit in range(bitslice.WORD_BITS):
            if (d >> bit) & 1:
                bad.append((name, int(w) * bitslice.WORD_BITS + bit))
    return bad


class RelationGuard:
    """Incremental expected-parity state for one guarded relation."""

    def __init__(self, rel) -> None:
        self.name = rel.name
        # plane-name -> expected (W,) uint32 parity. Built from the
        # pack-time planes, which are trusted.
        self.parity: Dict[str, np.ndarray] = {
            a: xor_reduce(p) for a, p in rel.planes.items()}
        self.parity[VALID] = to_host(rel.valid).copy()
        # (W,) bitmask of quarantined slots, excluded from diffs.
        self.quarantined = np.zeros(rel.layout.n_words, U32)

    # -- capacity ---------------------------------------------------------
    def _ensure_words(self, n_words: int) -> None:
        for a, p in self.parity.items():
            if p.shape[0] < n_words:
                self.parity[a] = np.concatenate(
                    [p, np.zeros(n_words - p.shape[0], U32)])
        if self.quarantined.shape[0] < n_words:
            self.quarantined = np.concatenate(
                [self.quarantined,
                 np.zeros(n_words - self.quarantined.shape[0], U32)])

    def ensure_attr(self, attr: str, n_words: int) -> None:
        """A widened attribute replaces its plane stack with extra zero
        planes on top — XOR with zeros is identity, so the existing
        parity stays valid; only brand-new attributes need an entry."""
        if attr not in self.parity:
            self.parity[attr] = np.zeros(n_words, U32)

    # -- incremental expectation ------------------------------------------
    def observe(self, instr, n_words: int) -> None:
        """Fold one write instruction into the expected parity."""
        self._ensure_words(n_words)
        if isinstance(instr, isa.PlaneWrite):
            if instr.dest == VALID:
                touch, vals = engine.plane_write_masks(
                    instr.rows, instr.values, 1, n_words)
                self.parity[VALID] = \
                    (self.parity[VALID] & ~touch) | vals[0]
            else:
                touch, vals = engine.plane_write_masks(
                    instr.rows, instr.values, instr.n_bits, n_words)
                self.ensure_attr(instr.dest, n_words)
                p = self.parity[instr.dest]
                self.parity[instr.dest] = \
                    (p & ~touch) | (_xor_reduce_words(vals) & touch)
        elif isinstance(instr, isa.ValidClear):
            touch = engine.write_touch_mask(
                np.asarray(instr.rows, np.int64), n_words)
            self.parity[VALID] = self.parity[VALID] & ~touch

    # -- scrub ------------------------------------------------------------
    def scrub(self, rel) -> List[Tuple[str, int]]:
        """Diff expected parity against the stored planes.

        Returns corrupt ``(plane_name, slot)`` coordinates (plane_name
        is an attribute or ``"__valid__"``), excluding quarantined
        slots.  A diff localizes corruption to a 32-slot word; the bit
        position inside the word pins the exact slot.
        """
        n_words = rel.layout.n_words
        self._ensure_words(n_words)
        keep = ~self.quarantined[:n_words]
        bad: List[Tuple[str, int]] = []
        for a, planes in rel.planes.items():
            actual = xor_reduce(planes)
            bad += _diff_slots(a, (actual ^ self.parity[a][:n_words]) & keep)
        actual_v = to_host(rel.valid)
        bad += _diff_slots(
            VALID, (actual_v ^ self.parity[VALID][:n_words]) & keep)
        return bad

    def quarantine(self, slots: Sequence[int]) -> None:
        """Permanently exclude slots from future scrub diffs (their
        rows are retired; the cells may rot freely)."""
        if not len(slots):
            return
        word_max = max(int(s) for s in slots) // bitslice.WORD_BITS + 1
        self._ensure_words(word_max)
        for s in slots:
            w, b = divmod(int(s), bitslice.WORD_BITS)
            self.quarantined[w] |= U32(1) << U32(b)
