"""Spans of the query path on the host's clock, recorded while a
``torch.profiler`` session runs.

A span is one interval of work or waiting at a layer boundary: its name,
start and end (``time.perf_counter()`` seconds), the thread that recorded
it, its own id, the id of the span it ran inside (the innermost span open
on that thread), the request it belongs to (one id a ``QueryService``
request, the same on every thread), the admission window it ran in, and a
few attributes (``relation``, ``n_queries``, ``bytes``, ...). A wait that
crosses threads (a request queued on the event loop and picked up by the
dispatch thread) is recorded where it ends, with explicit start and end,
no parent, and ``origin`` naming where it started.

The switch is the profiler itself: spans are recorded only while a
``torch.profiler`` session is active (``torch.autograd.profiler.
_is_profiler_enabled``, a module flag every thread sees). Off, a span
site costs that one flag check and returns a shared no-op context. On,
each span is also entered as a ``record_function`` range of the same name
on its thread, so a chrome trace of the session shows the spans beside the
kernels (a ``torch.profiler`` session records other threads' ranges with
``experimental_config=_ExperimentalConfig(profile_all_threads=True)``);
a wait that crosses threads appears there as an empty range where it ends.

Spans stay in memory in one process-wide bounded buffer (:data:`RECORDER`;
``dropped`` counts what did not fit) until :func:`clear`.
:func:`clip` cuts spans to an interval, and :func:`idle_by_span` shares a
device's idle time out over the innermost span open on each thread.

Spans recorded by the port and what reads them (``pimbench/metrics``):

  svc.queue          ``QueryService``: a request from the batcher's ``add``
                     to its window's start on the dispatch thread
  dispatch.window    ``QueryService._run_window`` (``n_queries``,
                     ``degraded``)
  db.compile         ``PimDatabase.dispatch_batch``: compile, link and
                     lower a window's programs (``n_queries``)
  db.compile.verify  ``core.program.compile_program`` on a tape-cache
                     miss: ``verify_compile`` and the tape's recording
  db.launch          ``core.program.run_program`` of one relation, from
                     the clock reads of ``QueryResult.pim_s``
  db.readback        a query's mask or materialized values copied to the
                     host (``bytes``)
  db.unpack          a query's mask unpacked to booleans
  db.selectivity     a relation's selectivity and per-conjunct pass
                     fractions
  host.queue         a query's host stage from its hand-off to a host
                     worker to its start there
  host.stage         ``PimDatabase.finish_query``'s host stage, from the
                     clock reads of ``QueryResult.host_s``
  dml.apply          ``PimDatabase.apply``
  dml.publish        ``PimDatabase.publish`` (``live_columns`` included)
  dispatch.retry     ``QueryService``: the backoff sleep before a retry of
                     a window's dispatch after a transient fault
                     (``attempt``)
  dispatch.eager     ``QueryService``: a degraded window's run on the
                     EAGER engine (``reason``: ``exhausted``, its retries
                     ran out; ``open``, the breaker was open)
  faults.inject      ``QueryService.scrub(inject=...)``: the injection
                     that runs just before the scrub, in the same job on
                     the dispatch thread (``n_faults``: cells made corrupt
                     and dispatch faults queued)
  faults.scrub       ``FaultManager.scrub``: the parity diff of every
                     guarded relation, its repairs and the republish
                     (``relations`` guarded, ``corrupt`` coordinates
                     found, ``bytes`` copied off the device)
  faults.repair      one repaired relation's rewrites and remaps inside
                     ``faults.scrub`` (``relation``, ``soft`` and ``hard``
                     slots, ``rows`` rewritten or moved); the republish's
                     ``dml.publish`` follows it inside ``faults.scrub``
  faults.verify      ``FaultManager.after_write``: the written slots' words
                     read back and checked (``bytes``)
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch.autograd.profiler as _profiler

CAPACITY = 200_000
DISPATCH = "pim-dispatch"     # QueryService's dispatch thread's name prefix


class Span(NamedTuple):
    name: str
    start: float
    end: float
    thread: str
    id: int
    parent: Optional[int]
    request: Optional[int]
    window: Optional[int]
    origin: Optional[str]
    attrs: Dict[str, object]

    @property
    def seconds(self) -> float:
        return self.end - self.start


class SpanRecorder:
    """A bounded, thread-safe buffer of finished spans; spans past
    ``capacity`` are counted in ``dropped`` and not kept."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = int(capacity)
        self.dropped = 0
        self._spans: List[Span] = []
        self._lock = threading.Lock()

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) < self.capacity:
                self._spans.append(span)
            else:
                self.dropped += 1

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0


RECORDER = SpanRecorder()
_ids = itertools.count(1)
_local = threading.local()


def on() -> bool:
    """Whether spans are being recorded (a profiler session is active)."""
    return _profiler._is_profiler_enabled


def next_id() -> int:
    """A fresh id for a request, a window or a span (one sequence)."""
    return next(_ids)


def _state() -> Tuple[list, dict]:
    try:
        return _local.stack, _local.ctx
    except AttributeError:
        _local.stack, _local.ctx = [], {}
        return _local.stack, _local.ctx


def _ids_of(ctx: dict, attrs: dict) -> Tuple[Optional[int], Optional[int]]:
    """(request, window) of a span: its own ``request``/``window``
    attributes, else the thread's context (``request``, or ``requests``
    indexed by ``query``)."""
    request = attrs.pop("request", None)
    window = attrs.pop("window", None)
    if request is None:
        request = ctx.get("request")
        requests, q = ctx.get("requests"), ctx.get("query")
        if request is None and requests is not None and q is not None:
            request = requests[q]
    return request, ctx.get("window") if window is None else window


class _Null:
    """The span and the context of a site while spans are off."""

    def __enter__(self) -> "_Null":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def set(self, **attrs) -> None:
        pass

    def at(self, start: float, end: float) -> None:
        pass


_NULL = _Null()


class _Open:
    """A span being recorded: pushed on the thread's stack for its
    duration, mirrored as a ``record_function`` range."""

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.times: Optional[Tuple[float, float]] = None

    def __enter__(self) -> "_Open":
        stack, _ = _state()
        self.parent = stack[-1] if stack else None
        self.id = next_id()
        stack.append(self.id)
        self._rf = _profiler.record_function(self.name)
        self._rf.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter()
        self._rf.__exit__(None, None, None)
        stack, ctx = _state()
        stack.pop()
        start, end = self.times or (self.start, end)
        request, window = _ids_of(ctx, self.attrs)
        RECORDER.add(Span(self.name, start, end,
                          threading.current_thread().name, self.id,
                          self.parent, request, window, None, self.attrs))

    def set(self, **attrs) -> None:
        """Add attributes before the span ends."""
        self.attrs.update(attrs)

    def at(self, start: float, end: float) -> None:
        """Give the span the site's own clock reads (inside the span)."""
        self.times = (start, end)


def span(name: str, **attrs):
    """``with span(name, **attrs) as sp:`` records the block as a span
    (``sp.set(...)`` adds attributes, ``sp.at(t0, t1)`` takes the site's
    own clock reads); a no-op while spans are off. ``request=`` and
    ``window=`` override the thread's context."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Open(name, attrs)


def record(name: str, start: float, end: float, *,
           origin: Optional[str] = None, **attrs) -> None:
    """Record a finished span with explicit times on this thread (a wait
    that began on ``origin``'s thread has no parent)."""
    if not _profiler._is_profiler_enabled:
        return
    stack, ctx = _state()
    parent = stack[-1] if stack and origin is None else None
    request, window = _ids_of(ctx, attrs)
    with _profiler.record_function(name, f"{1e3 * (end - start):.3f} ms"):
        pass
    RECORDER.add(Span(name, start, end, threading.current_thread().name,
                      next_id(), parent, request, window, origin, attrs))


class _Context:
    def __init__(self, ids: dict):
        self.ids = ids

    def __enter__(self) -> "_Context":
        _, ctx = _state()
        self.saved = dict(ctx)
        ctx.update(self.ids)
        return self

    def __exit__(self, *exc) -> None:
        _, ctx = _state()
        ctx.clear()
        ctx.update(self.saved)


def context(**ids):
    """``with context(window=w, requests=(r0, r1, ...))``, ``query=i`` or
    ``request=r``: the ids the spans opened inside it on this thread
    carry; a no-op while spans are off."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Context(ids)


def spans() -> List[Span]:
    """Every span recorded since the last :func:`clear`, in the order
    they ended."""
    return RECORDER.spans()


def clear() -> None:
    RECORDER.clear()


def clip(spans: Iterable[Span], t0: float, t1: float) -> List[Span]:
    """The spans that overlap ``[t0, t1)``, cut to it."""
    return [s._replace(start=max(s.start, t0), end=min(s.end, t1))
            for s in spans if s.end > t0 and s.start < t1]


def _merge(intervals: Iterable[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, t in sorted(iv for iv in intervals if iv[1] > iv[0]):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


def _innermost(thread_spans: List[Span]) -> List[Tuple[float, float, str]]:
    """One thread's timeline as ``(start, end, name)`` pieces, each named
    after the innermost span open in it (spans of one thread nest)."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Span] = []
    t = 0.0
    for s in sorted(thread_spans, key=lambda s: (s.start, -s.end)):
        while stack and stack[-1].end <= s.start:
            top = stack.pop()
            out.append((t, top.end, top.name))
            t = top.end
        if stack:
            out.append((t, s.start, stack[-1].name))
        stack.append(s)
        t = s.start
    while stack:
        top = stack.pop()
        out.append((t, top.end, top.name))
        t = max(t, top.end)
    return [p for p in out if p[1] > p[0]]


def _overlap(pieces, gaps) -> float:
    """Seconds where two sorted lists of disjoint intervals overlap."""
    total, i, j = 0.0, 0, 0
    while i < len(pieces) and j < len(gaps):
        lo = max(pieces[i][0], gaps[j][0])
        hi = min(pieces[i][1], gaps[j][1])
        if hi > lo:
            total += hi - lo
        if pieces[i][1] < gaps[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_by_span(busy: Iterable[Tuple[float, float]], spans: Iterable[Span],
                 t0: float, t1: float) -> Dict[str, object]:
    """Share a device's idle time in ``[t0, t1)`` out over the spans.

    ``busy`` is the device's busy intervals on the ``perf_counter`` clock
    (any profiler's device events). Returns ``window_s``, ``idle_s``,
    ``idle_by_span`` ({thread: {innermost span: idle seconds}}; waits that
    cross threads are left out, and ``"(no span)"`` is idle time in which
    the thread had no span open) and ``dispatch_busy_share``: the share of
    the window in which the dispatch thread (the thread whose name starts
    with :data:`DISPATCH`) had a span open."""
    gaps, prev = [], t0
    for s, t in _merge((max(s, t0), min(t, t1)) for s, t in busy):
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if t1 > prev:
        gaps.append((prev, t1))
    idle = sum(t - s for s, t in gaps)
    by_thread: Dict[str, List[Span]] = {}
    for s in clip(spans, t0, t1):
        if s.origin is None:
            by_thread.setdefault(s.thread, []).append(s)
    out: Dict[str, Dict[str, float]] = {}
    dispatch_busy = 0.0
    for thread, ss in sorted(by_thread.items()):
        pieces = _innermost(ss)
        names: Dict[str, float] = {}
        for name in sorted({p[2] for p in pieces}):
            names[name] = _overlap([p[:2] for p in pieces if p[2] == name],
                                   gaps)
        covered = _merge(p[:2] for p in pieces)
        names["(no span)"] = idle - _overlap(covered, gaps)
        out[thread] = names
        if thread.startswith(DISPATCH):
            dispatch_busy += sum(t - s for s, t in covered)
    window = t1 - t0
    return {"window_s": window, "idle_s": idle, "idle_by_span": out,
            "dispatch_busy_share": dispatch_busy / window if window > 0
            else 0.0}
