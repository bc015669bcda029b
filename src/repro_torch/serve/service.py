"""Async query service: concurrent QuerySpec submissions -> fused dispatches.

The counterpart of ``repro.serve.service``. ``QueryService.submit(spec)``
is an awaitable that resolves to the same
:class:`repro_torch.db.QueryResult` a direct ``PimDatabase.execute`` call
would produce (bit-identical — the batch path is the linked-program
executor proven in the fusion tests).  Between the caller and the
database sit three mechanisms, in order:

1. **Result cache** (``cache.ResultCache``): keyed on the canonical
   program hash + relation versions, so repeated or re-spelled queries
   over unchanged relations are answered without touching the arrays.
2. **In-flight coalescing**: a submission whose key matches a query
   already admitted (but unresolved) awaits that query's future instead
   of dispatching again.
3. **Admission window** (``batcher.AdmissionBatcher``): cache-missing
   submissions are held up to ``max_wait_s`` / ``max_window`` and
   dispatched as ONE cross-query linked program per relation
   (``PimDatabase.dispatch_batch``).

Execution is split-phase: the device stage runs on a single dispatch
worker (one PIM; dispatches serialize): every launch, every read-back
from the card, ``apply`` and ``scrub`` happen on that one thread. Host
stages (``PimDatabase.finish_query``: numpy joins over records already
on the host, no launch and no device sync) fan out on a
``host_workers``-wide pool so a slow join never blocks the next
window's dispatch.  ``max_pending`` bounds admitted-but-unresolved
queries (an ``asyncio.Semaphore`` — further ``submit`` calls simply
wait, which is the backpressure signal).

While a ``torch.profiler`` session runs, the service records spans
(``core.spans``): each request's wait from admission to its window's
start (``svc.queue``), each window on the dispatch thread
(``dispatch.window``) and each host stage's wait for a worker
(``host.queue``), every span of a request under its id; with a fault
manager also each backoff sleep before a retry (``dispatch.retry``), each
degraded window's EAGER run (``dispatch.eager``) and a scrub's injected
faults (``faults.inject``).
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import program as prog
from repro_torch.core import spans
from repro_torch.db.database import Engine, PimDatabase, QueryResult
from repro_torch.faults.model import TransientDispatchError

from .batcher import AdmissionBatcher
from .cache import ResultCache, spec_cache_key


@dataclasses.dataclass
class _Request:
    spec: object
    key: Tuple
    future: asyncio.Future
    t_submit: float
    rid: int = dataclasses.field(default_factory=spans.next_id)
    t_admit: float = dataclasses.field(default_factory=time.perf_counter)


class QueryService:
    def __init__(self, db: PimDatabase, *,
                 engine: Engine = Engine.FUSED,
                 max_window: int = 8, max_wait_s: float = 0.002,
                 cache_capacity: int = 256,
                 host_workers: int = 4, max_pending: int = 64,
                 fault_manager=None):
        self.db = db
        self.engine = Engine.coerce(engine)
        #: Optional repro_torch.faults.FaultManager: enables transient-fault
        #: retry, the FUSED->EAGER circuit breaker, and ``scrub()``.
        self.faults = fault_manager
        self.cache = ResultCache(cache_capacity)
        self.batcher = AdmissionBatcher(self._on_window,
                                        max_window=max_window,
                                        max_wait_s=max_wait_s)
        self.max_pending = int(max_pending)
        self._sem: Optional[asyncio.Semaphore] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._inflight: Dict[Tuple, asyncio.Future] = {}
        self._dispatch_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="pim-dispatch")
        self._host_pool = ThreadPoolExecutor(
            max_workers=host_workers, thread_name_prefix="host-stage")
        self._lat_s: List[float] = []
        self.n_submitted = 0
        self.n_completed = 0
        self.n_coalesced = 0
        self.n_dispatches = 0
        self.n_plane_reads = 0
        self.n_mutations = 0
        self.n_errors = 0
        self.n_transient_faults = 0
        self.n_retries = 0
        self.n_degraded_windows = 0
        self.n_fault_recovered = 0

    # -- submission (event-loop side) ---------------------------------------
    async def submit(self, spec) -> QueryResult:
        """Submit one query; resolves to its QueryResult.  Cache hits
        return immediately (``result.cached`` set); key-equal in-flight
        submissions coalesce onto one dispatch."""
        loop = self._bind_loop()
        t0 = time.perf_counter()
        self.n_submitted += 1

        key = spec_cache_key(self.db, spec, self.engine)
        hit = self.cache.get(key)
        if hit is not None:
            self._lat_s.append(time.perf_counter() - t0)
            self.n_completed += 1
            return dataclasses.replace(hit, cached=True)

        inflight = self._inflight.get(key)
        if inflight is not None:
            self.n_coalesced += 1
            # shield: cancelling THIS awaiter must not cancel the shared
            # dispatch other awaiters are parked on.
            res = await asyncio.shield(inflight)
            self._lat_s.append(time.perf_counter() - t0)
            self.n_completed += 1
            return res

        async with self._sem:
            fut: asyncio.Future = loop.create_future()
            self._inflight[key] = fut
            self.batcher.add(_Request(spec, key, fut, t0))
            res = await asyncio.shield(fut)
        self._lat_s.append(time.perf_counter() - t0)
        self.n_completed += 1
        return res

    async def apply(self, mutations) -> Dict[str, Dict[str, object]]:
        """Apply a DML batch (``repro_torch.dml`` mutation specs) through the
        service, interleaved with query traffic.

        The open admission window is flushed first, then the batch runs
        on the single dispatch worker — the same 1-wide pool the array
        stage uses — so mutations are strictly ordered with query
        windows: already-admitted queries execute against pre-mutation
        contents, later submissions see the new versions (and miss the
        result cache by construction, since ``PimDatabase.apply`` bumps
        every mutated relation's version on publish).
        """
        loop = self._bind_loop()
        self.batcher.flush_now()
        stats = await loop.run_in_executor(
            self._dispatch_pool, self.db.apply, list(mutations))
        self.n_mutations += sum(s["n_mutations"] for s in stats.values())
        return stats

    async def scrub(self, inject: Optional[Callable[[], None]] = None
                    ) -> Dict[str, Dict[str, object]]:
        """Run one fault-manager integrity scrub, ordered with query
        traffic exactly like :meth:`apply`: the open admission window
        flushes first, then the scrub (parity diff + repair + version
        republish) runs on the single dispatch worker.  Queries admitted
        before the scrub execute against pre-repair contents; later
        submissions see the repaired (re-versioned) relations and miss
        the result cache by construction.

        ``inject``, a callable of no arguments, runs on the dispatch
        worker immediately before the scrub, in the same job (faults
        injected through the fault manager): windows admitted before the
        call see the planes before the injection, and no window runs
        between the injection and the scrub."""
        if self.faults is None:
            raise RuntimeError("QueryService has no fault_manager")
        loop = self._bind_loop()
        self.batcher.flush_now()
        return await loop.run_in_executor(
            self._dispatch_pool, self._scrub_job, inject)

    def _scrub_job(self, inject) -> Dict[str, Dict[str, object]]:
        fm = self.faults
        try:
            if inject is not None:
                with spans.span("faults.inject") as sp:
                    n0 = fm.n_injected + fm.model.dispatch_faults_queued
                    inject()
                    sp.set(n_faults=fm.n_injected
                           + fm.model.dispatch_faults_queued - n0)
        finally:
            # What an injection that raised left corrupt is still repaired
            # before the next window; its error reaches the caller.
            report = fm.scrub()
        return report

    def _bind_loop(self) -> asyncio.AbstractEventLoop:
        loop = asyncio.get_running_loop()
        if self._loop is None:
            self._loop = loop
            self._sem = asyncio.Semaphore(self.max_pending)
        elif loop is not self._loop:
            raise RuntimeError("QueryService is bound to one event loop")
        return loop

    async def drain(self) -> None:
        """Flush the admission window and wait until nothing is in
        flight."""
        self.batcher.flush_now()
        while self._inflight:
            await asyncio.gather(*list(self._inflight.values()),
                                 return_exceptions=True)

    def close(self) -> None:
        self._dispatch_pool.shutdown(wait=True)
        self._host_pool.shutdown(wait=True)

    async def __aenter__(self) -> "QueryService":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.drain()
        self.close()

    # -- window execution (worker side) -------------------------------------
    def _on_window(self, window: List[_Request]) -> None:
        # Batcher flush fires on the event loop; hand straight off so the
        # loop never blocks on compilation or dispatch.  A failed handoff
        # (pool already shut down) must still reject every request — a
        # window whose futures never resolve wedges all its awaiters.
        try:
            self._dispatch_pool.submit(self._run_window, window)
        except Exception as e:                   # noqa: BLE001
            for r in window:
                self._reject(r, e)

    def _run_window(self, window: List[_Request]) -> None:
        wid = spans.next_id()
        if spans.on():
            t = time.perf_counter()
            for r in window:
                spans.record("svc.queue", r.t_admit, t, origin="event loop",
                             request=r.rid, window=wid)
        with spans.context(window=wid,
                           requests=tuple(r.rid for r in window)), \
                spans.span("dispatch.window", n_queries=len(window),
                           degraded=False) as sp:
            self._dispatch_window(window, wid, sp)

    def _dispatch_window(self, window: List[_Request], wid: int,
                         sp) -> None:
        try:
            fm = self.faults
            if self.engine is not Engine.FUSED:
                self._run_window_eager(window, self.engine)
                return
            if fm is not None and not fm.breaker.allow_fused():
                # Breaker open: degrade the window to the EAGER engine
                # (slower, still correct) instead of failing queries.
                self._degrade(window, sp, "open")
                return
            attempt = 0
            while True:
                try:
                    if fm is not None:
                        fm.model.check_dispatch()
                    pendings, stats = self.db.dispatch_batch(
                        [r.spec for r in window])
                    break
                except TransientDispatchError:
                    self.n_transient_faults += 1
                    if fm is None or attempt >= fm.retry.max_retries:
                        if fm is not None:
                            fm.breaker.record_failure()
                        # Retries exhausted: degrade this window too.
                        self._degrade(window, sp, "exhausted")
                        return
                    with spans.span("dispatch.retry", attempt=attempt):
                        time.sleep(fm.retry.delay(attempt))
                    attempt += 1
                    self.n_retries += 1
            if fm is not None:
                fm.breaker.record_success()
                if attempt:
                    self.n_fault_recovered += len(window)
            if len(pendings) != len(window):
                raise RuntimeError(
                    f"dispatch_batch returned {len(pendings)} pendings "
                    f"for a {len(window)}-request window")
            self.n_dispatches += int(stats["n_dispatches"])
            self.n_plane_reads += sum(
                rs["plane_reads"] for rs in stats["relations"].values())
            for r, p in zip(window, pendings):
                if p.needs_host:
                    self._host_pool.submit(self._finish_host, r, p, wid,
                                           time.perf_counter())
                else:
                    self._resolve(r, p.result)
        except Exception as e:                   # noqa: BLE001
            for r in window:
                self._reject(r, e)

    def _degrade(self, window: List[_Request], sp, reason: str) -> None:
        """Answer a window on the EAGER engine (slower, still correct):
        the breaker is open (``reason`` ``"open"``) or its retries ran
        out (``"exhausted"``)."""
        sp.set(degraded=True)
        self.n_degraded_windows += 1
        self.n_fault_recovered += len(window)
        with spans.span("dispatch.eager", reason=reason):
            self._run_window_eager(window, Engine.EAGER)

    def _run_window_eager(self, window: List[_Request],
                          engine: Engine) -> None:
        for r in window:
            try:
                with spans.context(request=r.rid):
                    self._resolve(r, self.db._execute_one(r.spec, engine))
            except Exception as e:              # noqa: BLE001
                self._reject(r, e)

    def _finish_host(self, req: _Request, pending, wid: int,
                     t_handoff: float) -> None:
        spans.record("host.queue", t_handoff, time.perf_counter(),
                     origin="dispatch thread", request=req.rid, window=wid)
        try:
            with spans.context(request=req.rid, window=wid):
                self._resolve(req, self.db.finish_query(pending))
        except Exception as e:                   # noqa: BLE001
            self._reject(req, e)

    def _resolve(self, req: _Request, res: QueryResult) -> None:
        self.cache.put(req.key, res)
        self._loop.call_soon_threadsafe(self._complete, req, res, None)

    def _reject(self, req: _Request, exc: BaseException) -> None:
        self.n_errors += 1
        self._loop.call_soon_threadsafe(self._complete, req, None, exc)

    def _complete(self, req: _Request, res, exc) -> None:
        self._inflight.pop(req.key, None)
        if req.future.done():
            return
        if exc is not None:
            req.future.set_exception(exc)
        else:
            req.future.set_result(res)

    # -- observability -------------------------------------------------------
    def latency_ms(self) -> Dict[str, float]:
        lat = sorted(self._lat_s)
        if not lat:
            return {"n": 0, "p50": 0.0, "p99": 0.0, "mean": 0.0}
        return {"n": len(lat),
                "p50": 1e3 * _pct(lat, 0.50),
                "p99": 1e3 * _pct(lat, 0.99),
                "mean": 1e3 * sum(lat) / len(lat)}

    def stats(self) -> Dict[str, object]:
        out = {
            "submitted": self.n_submitted,
            "completed": self.n_completed,
            "coalesced": self.n_coalesced,
            "errors": self.n_errors,
            "dispatches": self.n_dispatches,
            "plane_reads": self.n_plane_reads,
            "mutations": self.n_mutations,
            "inflight": len(self._inflight),
            "cache": self.cache.stats(),
            "batcher": self.batcher.stats(),
            "program_cache": prog.program_cache_stats(),
            "latency_ms": self.latency_ms(),
            "transient_faults": self.n_transient_faults,
            "retries": self.n_retries,
            "degraded_windows": self.n_degraded_windows,
            "fault_recovered": self.n_fault_recovered,
        }
        if self.faults is not None:
            out["breaker"] = {
                "state": self.faults.breaker.state,
                "trips": self.faults.breaker.n_trips,
                "recoveries": self.faults.breaker.n_recoveries,
            }
        return out


def _pct(sorted_vals: List[float], q: float) -> float:
    i = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]
