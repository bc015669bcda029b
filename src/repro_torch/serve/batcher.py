"""Admission-window batcher: turns a stream of submissions into windows.

The counterpart of ``repro.serve.batcher``, equal to it apart from this
docstring (pure asyncio; nothing here touches a device).

The serving thesis (the paper's, and linked batches'): bulk-bitwise PIM
wins by amortizing plane reads over many consumers, so the frontend
should hold each arriving query *briefly* and dispatch an admission
window of them as one cross-query linked program per relation.  Two
knobs bound the tradeoff:

* ``max_window`` — flush as soon as this many requests are pending
  (throughput bound: one dispatch serves the whole window);
* ``max_wait_s`` — flush whatever is pending this long after the FIRST
  request of the window arrived (tail-latency bound: an isolated query
  never waits longer than this for company).

Event-loop discipline: ``add`` must be called on the owning asyncio
loop; ``flush_cb`` fires on that loop too and must not block (the
service hands the window straight to its dispatch worker).
"""
from __future__ import annotations

import asyncio
from typing import Callable, Dict, List, Optional


class AdmissionBatcher:
    def __init__(self, flush_cb: Callable[[List[object]], None],
                 max_window: int = 8, max_wait_s: float = 0.002):
        if max_window < 1:
            raise ValueError("max_window must be >= 1")
        self.flush_cb = flush_cb
        self.max_window = int(max_window)
        self.max_wait_s = float(max_wait_s)
        self._pending: List[object] = []
        self._timer: Optional[asyncio.TimerHandle] = None
        self.n_items = 0
        self.n_windows = 0
        self.n_flush_size = 0
        self.n_flush_timeout = 0
        self.n_flush_forced = 0
        self.max_window_seen = 0

    def add(self, item: object) -> None:
        """Admit one request; flush if the window is full, else (first
        item of a fresh window) arm the max-wait timer."""
        self._pending.append(item)
        self.n_items += 1
        if len(self._pending) >= self.max_window:
            self._flush("size")
        elif self._timer is None:
            loop = asyncio.get_running_loop()
            self._timer = loop.call_later(
                self.max_wait_s, self._flush, "timeout")

    def flush_now(self) -> None:
        """Force out whatever is pending (drain/shutdown path)."""
        if self._pending:
            self._flush("forced")

    def _flush(self, why: str) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        window, self._pending = self._pending, []
        if not window:
            return
        self.n_windows += 1
        self.max_window_seen = max(self.max_window_seen, len(window))
        if why == "size":
            self.n_flush_size += 1
        elif why == "timeout":
            self.n_flush_timeout += 1
        else:
            self.n_flush_forced += 1
        self.flush_cb(window)

    @property
    def pending(self) -> int:
        return len(self._pending)

    def stats(self) -> Dict[str, int]:
        return {"items": self.n_items, "windows": self.n_windows,
                "flush_size": self.n_flush_size,
                "flush_timeout": self.n_flush_timeout,
                "flush_forced": self.n_flush_forced,
                "max_window_seen": self.max_window_seen,
                "pending": len(self._pending)}
