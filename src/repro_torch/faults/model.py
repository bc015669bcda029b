"""Deterministic, seeded device-fault model for the PIM substrate.

The counterpart of ``repro.faults.model``. The paper's PIMDB runs on
memristive RRAM whose practical viability hinges on cell endurance
(§6.4); this module models the three fault classes that analysis
surfaces as the ones a deployed bulk-bitwise engine must survive:

``stuck-at cells``
    A cell whose resistive state no longer switches: reads always
    return 0 (stuck-at-0) or 1 (stuck-at-1) regardless of what was
    programmed.  Modeled as per-(relation, attribute) OR/AND masks
    applied after every plane write ("the write happened, the cell
    didn't take it").

``dead rows``
    Endurance-exhausted crossbar rows: once a slot's accumulated
    cell-write counter (the real ``dml/segments.py`` wear counters)
    crosses the endurance budget, the whole row stops programming —
    every subsequent data-plane write to that slot is silently dropped.
    The valid plane is exempt by model choice: it lives in an SLC-style
    healthier region the controller can always program, so quarantining
    a dead row via ``ValidClear`` always succeeds.

``transient dispatch faults``
    A whole fused dispatch fails cleanly (controller timeout, link
    error) without corrupting state — the retryable class.  Modeled as
    a queue of pending failures consumed by ``check_dispatch()``.

The masks are numpy uint32 words, as the engine's write masks are; the
stuck-cell merge runs as torch ops on the planes' own device, the masks
going up as int32 views of the same bits.

Everything is deterministic: fault *placement* is chosen by the caller
(chaos harness / tests), never sampled internally, so every chaos run
is exactly replayable.
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple

import numpy as np
import torch

from repro_torch.core import bitslice
from repro_torch.core.engine import to_planes

U32 = np.uint32


class TransientDispatchError(RuntimeError):
    """A fused PIM dispatch failed transiently (retryable, no state
    corruption)."""


class DeviceFaultModel:
    """Registry of injected device faults + the engine write-fault hook.

    Instances implement the ``core.engine`` hook protocol
    (``filter_plane_write`` / ``force_stuck``) — install via
    ``repro_torch.faults.FaultManager.arm()``.
    """

    def __init__(self, seed: int = 0) -> None:
        self.seed = int(seed)
        # (rel, attr) -> [and_mask, or_mask], each (n_bits, W) uint32;
        # or_mask forces stuck-at-1 cells, and_mask clears stuck-at-0.
        self._stuck: Dict[Tuple[str, str], List[np.ndarray]] = {}
        # rel -> set of endurance-dead slots, plus the cached (W,) touch
        # mask of those slots (rebuilt on change).
        self._dead: Dict[str, Set[int]] = {}
        self._dead_touch: Dict[str, np.ndarray] = {}
        self._dispatch_faults = 0
        self.n_stuck_cells = 0
        self.n_dead_rows = 0
        self.n_dispatch_faults_raised = 0

    # -- fault registration ------------------------------------------------
    def _stuck_masks(self, rel: str, attr: str, n_bits: int,
                     n_words: int) -> List[np.ndarray]:
        key = (rel, attr)
        masks = self._stuck.get(key)
        if masks is None:
            masks = [np.zeros((n_bits, n_words), U32),
                     np.zeros((n_bits, n_words), U32)]
            self._stuck[key] = masks
        for i in (0, 1):
            m = masks[i]
            if m.shape[0] < n_bits or m.shape[1] < n_words:
                grown = np.zeros((max(n_bits, m.shape[0]),
                                  max(n_words, m.shape[1])), U32)
                grown[:m.shape[0], :m.shape[1]] = m
                masks[i] = grown
        return masks

    def add_stuck(self, rel: str, attr: str, slot: int, plane: int,
                  value: int, n_bits: int, n_words: int) -> None:
        """Register one stuck-at-``value`` cell at (slot, bit-plane)."""
        masks = self._stuck_masks(rel, attr, n_bits, n_words)
        word, bit = divmod(int(slot), bitslice.WORD_BITS)
        m = masks[1] if value else masks[0]   # or_mask / and_mask
        m[plane, word] |= U32(1) << U32(bit)
        self.n_stuck_cells += 1

    def add_dead_row(self, rel: str, slot: int) -> bool:
        """Mark a slot endurance-dead. Returns False if already dead."""
        dead = self._dead.setdefault(rel, set())
        if int(slot) in dead:
            return False
        dead.add(int(slot))
        self._dead_touch.pop(rel, None)
        self.n_dead_rows += 1
        return True

    def is_hard(self, rel: str, attr: str, slot: int) -> bool:
        """Does (rel, slot) host a permanent fault (dead row or any
        stuck cell on ``attr``)?  Hard faults need remap; soft
        corruption only needs an in-place rewrite."""
        if int(slot) in self._dead.get(rel, ()):
            return True
        masks = self._stuck.get((rel, attr))
        if masks is None:
            return False
        word, bit = divmod(int(slot), bitslice.WORD_BITS)
        for m in masks:
            if word < m.shape[1] and \
                    bool(((m[:, word] >> U32(bit)) & U32(1)).any()):
                return True
        return False

    def inject_dispatch_faults(self, n: int = 1) -> None:
        """Queue ``n`` transient failures for upcoming dispatches."""
        self._dispatch_faults += int(n)

    @property
    def dispatch_faults_queued(self) -> int:
        """Transient failures queued and not yet raised."""
        return self._dispatch_faults

    # -- engine hook protocol ----------------------------------------------
    def _dead_mask(self, rel: str, n_words: int) -> np.ndarray | None:
        dead = self._dead.get(rel)
        if not dead:
            return None
        m = self._dead_touch.get(rel)
        if m is None or m.shape[0] < n_words:
            m = bitslice.pack_mask(
                np.isin(np.arange(n_words * bitslice.WORD_BITS),
                        sorted(dead)), n_words)
            self._dead_touch[rel] = m
        return m[:n_words]

    def filter_plane_write(self, rel: str, attr: str, touch: np.ndarray,
                           vals: np.ndarray):
        """Dead rows never program: drop their bits from the write (the
        host masks, before they go up)."""
        dead = self._dead_mask(rel, touch.shape[0])
        if dead is None:
            return touch, vals
        keep = ~dead
        return touch & keep, vals & keep[None, :]

    def force_stuck(self, rel: str, attr: str,
                    planes: torch.Tensor) -> torch.Tensor:
        """Stuck cells reassert their value after every write: a merge on
        the planes' device."""
        masks = self._stuck.get((rel, attr))
        if masks is None:
            return planes
        n_bits, n_words = planes.shape
        and_m, or_m = masks[0][:n_bits, :n_words], masks[1][:n_bits, :n_words]
        return ((planes | to_planes(or_m, planes.device))
                & ~to_planes(and_m, planes.device))

    # -- dispatch-level faults ---------------------------------------------
    def check_dispatch(self) -> None:
        """Consume one queued transient fault, if any, by raising."""
        if self._dispatch_faults > 0:
            self._dispatch_faults -= 1
            self.n_dispatch_faults_raised += 1
            raise TransientDispatchError(
                "injected transient PIM dispatch fault "
                f"({self._dispatch_faults} still queued)")
