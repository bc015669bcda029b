"""The traced window: the card's activity from ``torch.profiler`` and what
the host's dispatch thread was doing, sampled from the benchmark's side.

``DeviceTrace`` wraps the window in a profiler (CPU and CUDA activity)
and a ``pimbench.window`` annotation whose start ties the profiler's
clock to ``time.perf_counter``. Every device event (kernels, copies,
fills) of the window is kept as ``(name, start, end)`` in perf-counter
seconds.

``Sampler`` is a thread that reads, every ``interval`` seconds, the stack
of the program's one dispatch thread (the thread that launches every
kernel and copies every result back) and keeps the innermost frame inside
the program's package, as ``"path/module.py:function"``: no span has to
exist inside the program for the idle gaps to be named.
"""
from __future__ import annotations

import bisect
import sys
import threading
import time
from collections import Counter
from typing import Dict, List, Optional, Tuple

IDLE_LABEL = "dispatch thread waiting for work"


def _label(frame, package: str) -> str:
    f = frame
    while f is not None:
        path = f.f_code.co_filename.replace("\\", "/")
        i = path.rfind(f"/{package}/")
        if i >= 0:
            return f"{path[i + len(package) + 2:]}:{f.f_code.co_name}"
        f = f.f_back
    return IDLE_LABEL


class Sampler(threading.Thread):
    PREFIX = "pim-dispatch"        # QueryService's dispatch thread
    PACKAGE = "repro_torch"
    INTERVAL_S = 0.002

    def __init__(self):
        super().__init__(name="pimbench-sampler", daemon=True)
        self.samples: List[Tuple[float, str]] = []
        self._stop_evt = threading.Event()

    def _target_ident(self) -> Optional[int]:
        for t in threading.enumerate():
            if t.name.startswith(self.PREFIX):
                return t.ident
        return None

    def run(self) -> None:
        ident = None
        while not self._stop_evt.wait(self.INTERVAL_S):
            if ident is None:
                ident = self._target_ident()
                if ident is None:
                    continue
            frame = sys._current_frames().get(ident)
            if frame is None:
                ident = None
                continue
            self.samples.append((time.perf_counter(),
                                 _label(frame, self.PACKAGE)))

    def stop(self) -> None:
        self._stop_evt.set()
        self.join(timeout=10)


class DeviceTrace:
    """Context manager around the window; see the module docstring."""

    MARK = "pimbench.window"

    def __init__(self):
        self.events: List[Tuple[str, float, float]] = []
        self.t0 = self.t1 = 0.0
        self.marked = False

    def __enter__(self) -> "DeviceTrace":
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._mark = record_function(self.MARK)
        self._mark.__enter__()
        self._torch = torch
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self._torch.cuda.is_available():
            self._torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        from torch.autograd import DeviceType
        events = self._prof.events()
        mark = [e for e in events if e.name == self.MARK]
        if not mark:
            return
        self.marked = True
        m0 = mark[0].time_range.start
        for e in events:
            if e.device_type == DeviceType.CUDA:
                s = self.t0 + (e.time_range.start - m0) / 1e6
                t = self.t0 + (e.time_range.end - m0) / 1e6
                if t > self.t0 and s < self.t1:
                    self.events.append((e.name, max(s, self.t0),
                                        min(t, self.t1)))

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        spans = sorted((s, t) for _, s, t in self.events if t > s)
        merged: List[Tuple[float, float]] = []
        for s, t in spans:
            if merged and s <= merged[-1][1]:
                if t > merged[-1][1]:
                    merged[-1] = (merged[-1][0], t)
            else:
                merged.append((s, t))
        return merged

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals())

    def kernel_s(self, needle: str) -> float:
        return sum(t - s for name, s, t in self.events if needle in name)

    def kernel_count(self, needle: str) -> int:
        return sum(1 for name, _, _ in self.events if needle in name)

    def top_ops(self, n: int = 10) -> List[List[object]]:
        by: Dict[str, float] = {}
        for name, s, t in self.events:
            short = name.split("(")[0]
            by[short] = by.get(short, 0.0) + (t - s)
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, samples: List[Tuple[float, str]],
                     n: int = 10) -> List[List[object]]:
        """Idle seconds of the card, shared out over what the dispatch
        thread was sampled doing inside each gap."""
        gaps: List[Tuple[float, float]] = []
        prev = self.t0
        for s, t in self.busy_intervals():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, t)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        times = [t for t, _ in samples]
        by: Dict[str, float] = {}
        for s, t in gaps:
            lo, hi = bisect.bisect_left(times, s), bisect.bisect_right(times, t)
            labels = Counter(lbl for _, lbl in samples[lo:hi])
            total = sum(labels.values())
            if not total:
                by["unsampled"] = by.get("unsampled", 0.0) + (t - s)
                continue
            for lbl, c in labels.items():
                by[lbl] = by.get(lbl, 0.0) + (t - s) * c / total
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]
