"""One run of one cell: set-up, the measured window, the comparison.

The cell's configuration (``configs/<config>.json``) fixes the data and
the guarantees, its traffic mix (``traffic/<mix>.json``) the clients, the
templates and the refresh stream. The configuration's deployment module
(``deployments/<name>.py``, named by its ``"deployment"`` key, ``tpch``
where it has none) generates the tables from the seed and loads them into
the program's ``PimDatabase``; set-up then warms up every template of the
mix (and, with a refresh stream, one RF1 and one RF2) through a
``QueryService``. The window then runs the mix's traffic (and refresh
stream), and the deployment's own tasks, against a fresh ``QueryService``
for ``seconds``: an open loop of requests at the mix's
fixed rate, or closed-loop clients; either walks a seeded permutation of
the templates, pass after pass, with fresh parameters each submission
from a stream that every seed shares. An open loop keeps at most the
service's ``max_pending`` requests submitted; the rest wait in the
benchmark's own queue, and those still there at the close are dropped,
never having reached the program, so the backlog of a rate above capacity
never reaches the comparison. Queries submitted to the service are
awaited (at most 60 s past the close) and judged, but only those that
finished inside the window count towards a rate. Afterwards the card's
peak memory is read, the mutable relations' stored rows are read back
from the card, the program is released and every answer is compared with
the reference (``compare.py``); the deployment's own checks come after.
"""
from __future__ import annotations

import asyncio
import dataclasses
import gc
import importlib
import importlib.util
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from . import adapter, compare, reference, roofline, templates
from .refresh import MUTABLE, VersionedTables

LATE_S = 60.0
THREADS = 4          # the reference's threads, after the window
DEPLOYMENT = "tpch"  # the deployment of a configuration that names none


@dataclasses.dataclass
class QueryRecord:
    q: templates.BoundQuery
    t_submit: float
    state_lo: int
    t_done: Optional[float] = None
    state_hi: Optional[int] = None
    result: object = None
    error: Optional[str] = None
    dropped: bool = False       # still in the benchmark's queue at the close

    @property
    def answered(self) -> bool:
        return self.result is not None and self.error is None

    @property
    def states(self) -> range:
        return range(self.state_lo, max(self.state_lo, self.state_hi) + 1)


@dataclasses.dataclass
class RefreshRecord:
    k: int
    kind: str
    n_rows: int
    t_call: float
    t_ack: Optional[float] = None
    stats: Optional[Dict] = None
    error: Optional[str] = None


@dataclasses.dataclass
class Run:
    """Everything a metric reader may read of one run."""
    cell: str
    seconds: float
    setup_s: float
    t_start: float
    t_end: float
    queries: List[QueryRecord]
    refreshes: List[RefreshRecord]
    service: Dict
    tape: Dict[str, int]
    widths: Dict[str, Dict[str, int]]
    n_rows_at: Callable[[int], Dict[str, int]]
    selected: Dict[tuple, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    trace: object = None
    samples: List = dataclasses.field(default_factory=list)
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    controls: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    # What the deployment's window tasks recorded, and the limits of the
    # checks it adds (run.py's LIMITS hold the base checks' limits).
    deployment: Dict = dataclasses.field(default_factory=dict)
    limits: Dict[str, float] = dataclasses.field(default_factory=dict)

    def in_window(self) -> List[QueryRecord]:
        """Queries due in the window that reached the program."""
        return [r for r in self.queries
                if r.t_submit < self.t_end and not r.dropped]

    def dispatched(self) -> List[QueryRecord]:
        """One record a result the program computed (no cache hit, no
        coalesced duplicate)."""
        seen, out = set(), []
        for r in self.queries:
            if r.answered and not r.result.cached and id(r.result) not in seen:
                seen.add(id(r.result))
                out.append(r)
        return out

    def batches(self) -> List[List[QueryRecord]]:
        """The dispatched records grouped by the admission window (one
        linked dispatch) that computed them."""
        groups: Dict[int, List[QueryRecord]] = {}
        for r in self.dispatched():
            groups.setdefault(id(r.result.batch_stats), []).append(r)
        return list(groups.values())

    def fused_bound_s(self) -> float:
        return sum(roofline.fused_bound_s(
            [r.q for r in b], self.n_rows_at(b[0].state_lo), self.widths)
            for b in self.batches())

    def materialize_bound_s(self) -> float:
        return sum(roofline.materialize_bound_s(
            r.q, self.selected[(r.q.key, r.state_lo)],
            self.n_rows_at(r.state_lo), self.widths)
            for r in self.dispatched() if r.q.scope == "end_to_end")


def load_plan(traffic: Dict) -> List[tuple]:
    """[(template, scope)] of the mix, in the mix's order."""
    return [(templates.load_template(e["query"]), e["scope"])
            for e in traffic["templates"]]


# The parameter stream is the same for every seed: each client's k-th pass
# over the mix's templates binds them with parameters drawn from
# (PARAMS, 1, client, k) alone, so every seed runs the same queries and
# the seed orders them (and generates the tables). Parameters drawn from
# the seed made one seed's run up to a fifth faster than another's.
PARAMS = 20260427


def pass_queries(plan, *key: int) -> List[templates.BoundQuery]:
    """One bound query a template of ``plan``, in the plan's order, with
    parameters drawn from ``(PARAMS, *key)``."""
    rng = np.random.default_rng([PARAMS, *key])
    out = []
    for t, scope in plan:
        out.append(templates.bind(t, scope, templates.draw_params(t, rng)))
    return out


def deployment_of(config: Dict):
    """The deployment module the configuration names: ``deployments/<name>.py``
    (dashes in the name read as underscores)."""
    name = config.get("deployment", DEPLOYMENT).replace("-", "_")
    return importlib.import_module("pimbench.deployments." + name)


async def _warmup(db, plan, stream, svc_kwargs: Optional[Dict] = None) -> int:
    from repro_torch.serve import QueryService

    qs = pass_queries(plan, 0)
    async with QueryService(db, **(svc_kwargs or {})) as svc:
        await asyncio.gather(*[svc.submit(adapter.query_spec(q)) for q in qs])
        k = 0
        if stream is not None:
            for k in (1, 2):
                await svc.apply(adapter.refresh_mutations(stream.make(k)))
    return k


async def _window(db, plan, traffic: Dict, seed: int, seconds: float,
                  stream, k0: int, svc_kwargs: Optional[Dict] = None,
                  own_tasks: Optional[Callable] = None):
    """``own_tasks(svc, t_end)`` gives the deployment's coroutines, run
    beside the clients and awaited and cancelled with them."""
    from repro_torch.serve import QueryService

    svc = QueryService(db, **(svc_kwargs or {}))
    queries: List[QueryRecord] = []
    refreshes: List[RefreshRecord] = []
    state = {"acked": k0, "called": k0}
    t_start = time.perf_counter()
    t_end = t_start + seconds

    async def submit(rec: QueryRecord, spec) -> None:
        try:
            rec.result = await svc.submit(spec)
        except Exception as e:                   # noqa: BLE001
            rec.error = f"{type(e).__name__}: {e}"
        rec.t_done = time.perf_counter()
        rec.state_hi = state["called"]

    async def client(c: int) -> None:
        """Closed loop: the next query once the last one is answered."""
        order = np.random.default_rng([seed, 101, c]).permutation(len(plan))
        i = 0
        while time.perf_counter() < t_end:
            if i % len(plan) == 0:
                this_pass = pass_queries(plan, 1, c, i // len(plan))
            q = this_pass[int(order[i % len(plan)])]
            i += 1
            spec = adapter.query_spec(q)
            rec = QueryRecord(q, time.perf_counter(), state["acked"])
            queries.append(rec)
            await submit(rec, spec)

    async def arrivals() -> None:
        """Open loop: a request at each due time of a Poisson stream of
        ``rate_qps`` (the same gaps for every seed), whatever is in flight;
        its latency runs from the due time. At most ``svc.max_pending``
        are submitted at once; at the close the rest are dropped."""
        gaps = np.random.default_rng([PARAMS, 2])
        order = np.random.default_rng([seed, 101]).permutation(len(plan))
        rate = float(traffic["rate_qps"])
        gate = asyncio.Semaphore(svc.max_pending)
        due, i, sent, waiting = t_start, 0, [], {}

        async def send(rec: QueryRecord, spec) -> None:
            async with gate:
                del waiting[id(rec)]
                await submit(rec, spec)

        while True:
            due += float(gaps.exponential(1.0 / rate))
            if due >= t_end:
                break
            delay = due - time.perf_counter()
            if delay > 0:
                await asyncio.sleep(delay)
            if i % len(plan) == 0:
                this_pass = pass_queries(plan, 1, 0, i // len(plan))
            q = this_pass[int(order[i % len(plan)])]
            i += 1
            rec = QueryRecord(q, due, state["acked"])
            queries.append(rec)
            late.append(time.perf_counter() - due)
            task = asyncio.ensure_future(send(rec, adapter.query_spec(q)))
            waiting[id(rec)] = (rec, task)
            sent.append(task)
        await asyncio.sleep(max(0.0, t_end - time.perf_counter()))
        for rec, task in list(waiting.values()):
            rec.dropped = True
            task.cancel()
        await asyncio.gather(*sent, return_exceptions=True)

    async def refresher() -> None:
        k = k0
        while time.perf_counter() < t_end:
            k += 1
            rf = stream.make(k)
            muts = adapter.refresh_mutations(rf)
            state["called"] = k
            rec = RefreshRecord(k, rf["kind"], rf["n_rows"],
                                time.perf_counter())
            refreshes.append(rec)
            try:
                rec.stats = await svc.apply(muts)
            except Exception as e:               # noqa: BLE001
                rec.error = f"{type(e).__name__}: {e}"
                return
            rec.t_ack = time.perf_counter()
            state["acked"] = k

    late: List[float] = []
    if traffic["loop"] == "open":
        tasks = [asyncio.ensure_future(arrivals())]
    else:
        tasks = [asyncio.ensure_future(client(c))
                 for c in range(int(traffic["clients"]))]
    if stream is not None:
        tasks.append(asyncio.ensure_future(refresher()))
    if own_tasks is not None:
        tasks += [asyncio.ensure_future(c) for c in own_tasks(svc, t_end)]
    _, pending = await asyncio.wait(tasks, timeout=seconds + LATE_S)
    for t in pending:
        t.cancel()
    if pending:
        await asyncio.gather(*pending, return_exceptions=True)
    for t in tasks:
        if not t.cancelled():
            t.result()
    try:
        await asyncio.wait_for(svc.drain(), timeout=LATE_S)
    except asyncio.TimeoutError:
        pass
    stats = svc.stats()
    svc.close()
    return queries, refreshes, t_start, t_end, stats, max(late, default=0.0)


def run_cell(cell: Dict, config: Dict, traffic: Dict, seed: int,
             seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None,
             program_hook: Optional[Callable] = None,
             controls: Optional[Dict[str, Callable]] = None):
    """Run one cell; returns ``(run, checks, attempted, failed, device)``.

    ``program_hook(db)``, when given, is called on the loaded database
    before the warm-up (the tests plant faults through it).
    ``controls`` ({name: answer(record, view)}) are judged as the program
    is, each in the program's place (``control.py``); their numbers land
    in ``run.controls``. The deployment's checks are added to ``checks``,
    their limits land in ``run.limits`` (``run.limits_of`` refuses one
    that names a base check)."""
    import torch
    from repro_torch.core import program as prog

    dep = deployment_of(config)
    t0 = time.perf_counter() if t_start is None else t_start
    phases = {"start": time.perf_counter() - t0}
    tables = dep.generate(config, seed)
    phases["generate"] = time.perf_counter() - t0
    for cols in tables.values():
        for v in cols.values():
            v.flags.writeable = False
    db = dep.load(tables, config, device)
    phases["load"] = time.perf_counter() - t0
    if program_hook is not None:
        program_hook(db)
    plan = load_plan(traffic)
    rf = traffic.get("refresh")
    stream = None
    if rf is not None:
        stream = VersionedTables(tables, float(config["scale_factor"]), seed,
                                 rf["orders_per_sf"],
                                 rf["lineitems_per_order"])
    svc_kwargs = dep.service_kwargs(db, config)
    k0 = asyncio.run(_warmup(db, plan, stream, svc_kwargs))
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    record: Dict = {}

    def own_tasks(svc, t_end):
        return dep.window_tasks(svc, db, config, t_end, record)

    tape0 = prog.program_cache_stats()
    dev_trace, sampler = None, None
    if trace:
        from .trace import DeviceTrace, Sampler
        sampler = Sampler()
        sampler.start()
        dev_trace = DeviceTrace()
        with dev_trace:
            out = asyncio.run(_window(db, plan, traffic, seed, seconds,
                                      stream, k0, svc_kwargs, own_tasks))
        sampler.stop()
    else:
        out = asyncio.run(_window(db, plan, traffic, seed, seconds, stream,
                                  k0, svc_kwargs, own_tasks))
    queries, refreshes, w0, w1, svc_stats, late_max = out
    phases["drained"] = time.perf_counter() - w0
    phases["generator_late_max"] = late_max
    tape1 = prog.program_cache_stats()
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell.get("chips", 1)),
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                 if on_card else 0)}
    if dev_trace is not None:
        dev["busy_s"] = dev_trace.busy_s()
        dev["window_s"] = dev_trace.window_s

    # The program's answers and the rows it stores, then the program
    # itself is let go.
    answers = {id(r): adapter.answer(r.q, r.result)
               for r in queries if r.answered}
    stored = ({rel: adapter.stored_rows(db, rel) for rel in MUTABLE}
              if stream is not None else {})
    for r in refreshes:
        if r.stats is not None:
            r.stats = {rel: {k: v for k, v in st.items()
                             if k in ("n_rows", "cells_written")}
                       for rel, st in r.stats.items()}
    del db, svc_kwargs, own_tasks
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    views: Dict[int, tuple] = {}

    def view(s: int):
        if s not in views:
            views[s] = stream.view(s) if stream is not None else (tables, None)
        return views[s]

    def reference_at(q, s):
        tb, live = view(s)
        return reference.evaluate(q, tb, live)

    def n_rows_at(s: int) -> Dict[str, int]:
        tb, live = view(s)
        out = {r: len(next(iter(c.values()))) for r, c in tb.items()}
        for r, m in (live or {}).items():
            out[r] = int(np.count_nonzero(m))
        return out

    in_window = [r for r in queries if r.t_submit < w1 and not r.dropped]
    for r in in_window:
        if r.state_hi is None:
            r.state_hi = r.state_lo
    slots, storage_wrong = {}, 0
    if stream is not None:
        tb, live = view(stream.state)
        for rel in MUTABLE:
            slots[rel], wrong = compare.locate(
                tb[rel], len(next(iter(tables[rel].values()))), live[rel],
                *stored[rel])
            storage_wrong += wrong
        del stored
    t_ref = time.perf_counter()
    numbers, n_wrong, refs = compare.judge(
        in_window, lambda r: answers[id(r)], reference_at, slots,
        threads=THREADS)
    phases["reference"] = time.perf_counter() - t_ref
    control_numbers = {}
    for name, fn in (controls or {}).items():
        nums, wrong, _ = compare.judge(
            in_window,
            lambda r, fn=fn: compare.answer_in_slots(fn(r, view), slots),
            reference_at, slots, threads=THREADS)
        control_numbers[name] = dict(nums, records_wrong=wrong,
                                     judged=sum(1 for r in in_window
                                                if r.answered))
    unanswered = sum(1 for r in in_window if not r.answered)
    rf_window = [r for r in refreshes if r.t_call < w1]
    unanswered += sum(1 for r in rf_window if r.t_ack is None)
    rows_gap = sum(abs(sum(st["n_rows"] for st in r.stats.values())
                       - r.n_rows) for r in rf_window if r.stats is not None)
    done_in_window = sum(1 for r in in_window
                         if r.answered and r.t_done <= w1)
    checks = {"unanswered": unanswered, **numbers}
    if stream is not None:
        checks.update(storage_rows_wrong=storage_wrong,
                      refresh_rows_gap=rows_gap)
    checks["empty_window"] = 0 if done_in_window else 1
    phases["dropped_at_close"] = sum(1 for r in queries if r.dropped)
    attempted = len(in_window) + len(rf_window)
    failed = n_wrong + unanswered + sum(
        1 for r in rf_window if r.stats is not None and sum(
            st["n_rows"] for st in r.stats.values()) != r.n_rows)

    selected = {k: v["selected"] for k, v in refs.items() if "selected" in v}
    run = Run(cell=cell["name"], seconds=seconds, setup_s=setup_s,
              t_start=w0, t_end=w1, queries=queries, refreshes=refreshes,
              service=svc_stats,
              tape={k: tape1[k] - tape0[k] for k in ("hits", "misses")},
              widths=roofline.widths(tables), n_rows_at=n_rows_at,
              selected=selected, trace=dev_trace,
              samples=sampler.samples if sampler is not None else [],
              phases=phases, controls=control_numbers, deployment=record)
    for name, (value, limit) in dep.checks(run).items():
        checks[name] = value
        run.limits[name] = limit
    return run, checks, attempted, failed, dev


def read_metrics(run: Run, metrics: List[Dict]) -> Dict[str, Dict]:
    """Each metric of ``metrics`` (``BENCHMARK.json`` entries) from its
    reader: ``metrics/<name>.py`` (dots and dashes in the name read as
    underscores), or where there is none, the reader of the name's part
    before its first dot (``p95_ms.<cell>`` is read by ``p95_ms.py``). A
    reader that finds nothing returns None and the metric is left out."""
    out = {}
    for m in metrics:
        name = m["name"]
        mod = importlib.import_module("pimbench.metrics." + reader_of(name))
        v = mod.read(run)
        if v is not None:
            out[name] = {"value": float(v), "unit": m["unit"]}
    return out


def reader_of(name: str) -> str:
    """The module under ``metrics/`` that reads the metric ``name``."""
    own = name.replace(".", "_").replace("-", "_")
    if importlib.util.find_spec("pimbench.metrics." + own) is not None:
        return own
    return name.split(".")[0].replace("-", "_")
