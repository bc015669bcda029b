"""The port's spans (``repro_torch.core.spans``) on the CPU.

Off (no profiler session) nothing is recorded and ``record_function`` is
never entered. Under ``torch.profiler`` a ``QueryService`` window of
linked filter queries, one end-to-end query and one DML batch record
every span of the query path: children inside their parents, per-query
spans under their request's and window's ids, one ``db.compile.verify``
a tape-cache miss, ``db.launch`` and ``host.stage`` from the clock reads
of ``pim_s`` and ``host_s``, and every span mirrored as a profiler range.
Answers are the same with tracing on and off. A fault round through a
``QueryService`` with a ``FaultManager`` (an injection and its scrub in
one job, then windows that retry, degrade to EAGER and recover) records
the fault path's spans with their attributes, each the innermost span on
the dispatch thread somewhere, and nothing with tracing off.
"""
import asyncio
import math

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from repro_torch import dml
from repro_torch.core import program as prog
from repro_torch.core import spans
from repro_torch.db import queries, tpch
from repro_torch.db.database import PimDatabase
from repro_torch.faults import FaultManager
from repro_torch.serve import QueryService

SF, SEED = 0.002, 20260418
TIMEOUT_S = 60
FILTERS = ("Q1", "Q6", "Q12", "Q19")
E2E = "Q14"
PER_QUERY = ("svc.queue", "db.readback", "db.unpack", "db.selectivity",
             "host.queue", "host.stage")
ALL = PER_QUERY + ("dispatch.window", "db.compile", "db.compile.verify",
                   "db.launch", "dml.apply", "dml.publish")
_CACHE: dict = {}


def _tables():
    if "tables" not in _CACHE:
        _CACHE["tables"] = tpch.generate(sf=SF, seed=SEED)
    return _CACHE["tables"]


def _traffic(db):
    """A linked window of filter queries, one end-to-end query, one DML
    batch, then the filter queries again over the new contents."""
    filters = [queries.get_query(n).filter_only() for n in FILTERS]
    rows = {a: c[:16] for a, c in db.tables["lineitem"].items()}

    async def run():
        async with QueryService(db, max_window=8, max_wait_s=0.05) as svc:
            first = await asyncio.gather(*[svc.submit(s) for s in filters])
            e2e = await svc.submit(queries.get_query(E2E))
            stats = await svc.apply([dml.Insert("lineitem", rows)])
            after = await asyncio.gather(*[svc.submit(s) for s in filters])
            return first, e2e, stats, after

    return asyncio.run(asyncio.wait_for(run(), timeout=TIMEOUT_S))


def _answers(out):
    first, e2e, stats, after = out
    masks = [{r: rr.mask for r, rr in res.relations.items()}
             for res in first + after]
    return ([res.aggregates for res in first + after], e2e.rows,
            {r: st["n_rows"] for r, st in stats.items()}, masks)


@pytest.fixture(scope="module")
def traced():
    """The traffic under a profiler: (results, spans, profiler events'
    names, tape-cache misses during the session)."""
    db = PimDatabase(_tables(), device="cpu")
    spans.clear()
    prog._FN_CACHE.clear()      # every program of the traffic misses once
    misses = prog.program_cache_stats()["misses"]
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as p:
        out = _traffic(db)
    misses = prog.program_cache_stats()["misses"] - misses
    recorded = spans.spans()
    spans.clear()
    return out, recorded, {e.name for e in p.events()}, misses


def test_off_records_nothing_and_never_enters_record_function(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda *a, **k: entered.append(a))
    spans.clear()
    assert not spans.on()
    db = PimDatabase(_tables(), device="cpu")
    _traffic(db)
    with spans.span("x") as sp:
        sp.set(a=1)
        sp.at(0.0, 1.0)
    spans.record("y", 0.0, 1.0)
    assert spans.spans() == [] and entered == []


def test_every_span_of_the_table_is_recorded(traced):
    _, recorded, _, _ = traced
    assert {s.name for s in recorded} == set(ALL)


def test_children_lie_inside_their_parents(traced):
    _, recorded, _, _ = traced
    by_id = {s.id: s for s in recorded}
    assert len(by_id) == len(recorded)
    n = 0
    for s in recorded:
        assert s.start <= s.end
        if s.parent is None:
            continue
        p = by_id[s.parent]
        assert p.thread == s.thread
        assert p.start <= s.start and s.end <= p.end, (p, s)
        n += 1
    assert n > 0
    parents = {by_id[s.parent].name for s in recorded
               if s.name == "db.compile.verify"}
    assert parents == {"db.compile"}
    assert {s.origin for s in recorded if s.name in ("svc.queue",
                                                     "host.queue")} \
        == {"event loop", "dispatch thread"}


def test_per_query_spans_carry_request_and_window(traced):
    _, recorded, _, _ = traced
    windows = {s.window: s for s in recorded if s.name == "dispatch.window"}
    assert all(s.request is None for s in windows.values())
    for s in recorded:
        if s.name in PER_QUERY:
            assert s.request is not None and s.window in windows, s
    for w, win in windows.items():
        queued = {s.request for s in recorded
                  if s.name == "svc.queue" and s.window == w}
        assert len(queued) == win.attrs["n_queries"]
        inner = {s.request for s in recorded
                 if s.name in PER_QUERY and s.window == w}
        assert inner == queued
    sizes = sorted(w.attrs["n_queries"] for w in windows.values())
    assert sizes == [1, len(FILTERS), len(FILTERS)]
    assert not any(w.attrs["degraded"] for w in windows.values())


def test_verify_spans_count_the_tape_cache_misses(traced):
    _, recorded, _, misses = traced
    assert misses > 0
    assert sum(s.name == "db.compile.verify" for s in recorded) == misses


def test_launch_shares_equal_pim_s_and_host_stage_equals_host_s(traced):
    (first, e2e, _, after), recorded, _, _ = traced
    windows = {s.window: s.attrs["n_queries"] for s in recorded
               if s.name == "dispatch.window"}
    e2e_window = next(w for w, n in windows.items() if n == 1)
    filter_windows = sorted(w for w, n in windows.items() if n > 1)
    for results, w in ((first, filter_windows[0]), (after, filter_windows[1]),
                       ([e2e], e2e_window)):
        launches = [s for s in recorded
                    if s.name == "db.launch" and s.window == w]
        assert launches
        for res in results:
            rels = res.relations or res.materialized_rows
            share = sum(s.seconds / s.attrs["n_queries"] for s in launches
                        if s.attrs["relation"] in rels)
            assert math.isclose(share, res.pim_s, rel_tol=1e-12,
                                abs_tol=0.0), (res.name, share, res.pim_s)
    stage = [s for s in recorded if s.name == "host.stage"]
    assert len(stage) == 1 and stage[0].seconds == e2e.host_s
    assert stage[0].thread.startswith("host-stage")


def test_readback_counts_bytes(traced):
    (first, e2e, _, _), recorded, _, _ = traced
    reads = [s for s in recorded if s.name == "db.readback"]
    windows = {s.window: s.attrs["n_queries"] for s in recorded
               if s.name == "dispatch.window"}
    # Before the insert a filter query copies one mask a relation it
    # filters: the relation's packed words.
    first_window = min(w for w, n in windows.items() if n > 1)
    plane_bytes = {4 * rel.valid.numel() for rel in PimDatabase(
        _tables(), device="cpu").relations.values()}
    masks = [s for s in reads if s.window == first_window]
    assert len(masks) == sum(len(res.relations) for res in first)
    assert {s.attrs["bytes"] for s in masks} <= plane_bytes
    # Q14 copies the selected records of its two relations.
    q14 = [s for s in reads if windows[s.window] == 1]
    assert len(q14) == len(e2e.materialized_rows) == 2
    assert all(s.attrs["bytes"] > 0 for s in q14)


def test_publish_lies_inside_apply(traced):
    _, recorded, _, _ = traced
    apply = [s for s in recorded if s.name == "dml.apply"]
    publish = [s for s in recorded if s.name == "dml.publish"]
    assert len(apply) == len(publish) == 1
    assert publish[0].parent == apply[0].id
    assert apply[0].start <= publish[0].start <= publish[0].end \
        <= apply[0].end


def test_every_span_is_mirrored_in_the_profiler(traced):
    _, recorded, names, _ = traced
    assert {s.name for s in recorded} <= names


def test_answers_equal_with_tracing_off(traced):
    out, _, _, _ = traced
    db = PimDatabase(_tables(), device="cpu")
    want = _answers(_traffic(db))
    got = _answers(out)
    assert got[:3] == want[:3]
    for g, w in zip(got[3], want[3]):
        assert g.keys() == w.keys()
        for r in g:
            np.testing.assert_array_equal(g[r], w[r])


FAULT_SPANS = ("faults.inject", "faults.scrub", "faults.repair",
               "faults.verify", "dispatch.retry", "dispatch.eager")


def _fault_round(db):
    """A scrub whose injection flips a lineitem and an orders cell, sticks
    a cell of an empty lineitem slot at 1 and queues 6 dispatch faults,
    then four windows of one query: two exhaust their retries, the breaker
    trips, one runs while it is open, the half-open probe closes it."""
    fm = FaultManager(db)
    for rel in ("lineitem", "orders"):
        fm.guard_relation(rel)
    empty = db.dml_state("lineitem").capacity - 1
    specs = [queries.get_query(n).filter_only() for n in FILTERS]

    def inject():
        fm.inject_flip("lineitem", "l_quantity", 3, 1)
        fm.inject_flip("orders", "o_totalprice", 5, 0)
        fm.inject_stuck("lineitem", "l_tax", empty, 0, 1)
        fm.model.inject_dispatch_faults(6)

    async def run():
        async with QueryService(db, max_wait_s=0.001,
                                fault_manager=fm) as svc:
            report = await svc.scrub(inject=inject)
            results = [await svc.submit(s) for s in specs]
            return report, results, svc.stats()

    return asyncio.run(asyncio.wait_for(run(), timeout=TIMEOUT_S))


@pytest.fixture(scope="module")
def traced_faults():
    db = PimDatabase(_tables(), device="cpu")
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = _fault_round(db)
    recorded = spans.spans()
    spans.clear()
    return out, recorded


def test_fault_spans_carry_their_attributes(traced_faults):
    (report, results, stats), recorded = traced_faults
    assert stats["breaker"] == {"state": "closed", "trips": 1,
                                "recoveries": 1}
    assert [r.engine.value for r in results] == ["eager"] * 3 + ["fused"]
    by_id = {s.id: s for s in recorded}
    named = {n: [s for s in recorded if s.name == n] for n in FAULT_SPANS}
    (inject,), (scrub,) = named["faults.inject"], named["faults.scrub"]
    assert inject.attrs == {"n_faults": 2 + 1 + 6}
    assert inject.end <= scrub.start
    assert scrub.attrs == {"relations": 2, "corrupt": 3, "bytes": 0}
    assert sorted((s.attrs["relation"], s.attrs["soft"], s.attrs["hard"],
                   s.attrs["rows"]) for s in named["faults.repair"]) == [
        ("lineitem", 1, 1, 1), ("orders", 1, 0, 1)]
    (publish,) = [s for s in recorded if s.name == "dml.publish"]
    assert {s.parent for s in named["faults.repair"]} == {publish.parent} \
        == {scrub.id}
    assert named["faults.verify"]
    for s in named["faults.verify"]:
        assert by_id[s.parent].name == "faults.repair"
        assert s.attrs == {"bytes": 0}        # nothing leaves the CPU
    assert [s.attrs["attempt"] for s in named["dispatch.retry"]] == \
        [0, 1, 0, 1]
    assert [s.attrs["reason"] for s in named["dispatch.eager"]] == \
        ["exhausted", "exhausted", "open"]
    for s in named["dispatch.retry"] + named["dispatch.eager"]:
        assert by_id[s.parent].name == "dispatch.window"
    assert [by_id[s.parent].attrs["degraded"]
            for s in named["dispatch.eager"]] == [True] * 3
    for s in named["faults.inject"] + named["faults.scrub"]:
        assert s.parent is None and s.thread.startswith(spans.DISPATCH)


def test_fault_spans_are_innermost_on_the_dispatch_thread(traced_faults):
    _, recorded = traced_faults
    t0 = min(s.start for s in recorded)
    t1 = max(s.end for s in recorded)
    out = spans.idle_by_span([], recorded, t0, t1)
    (dispatch,) = [d for t, d in out["idle_by_span"].items()
                   if t.startswith(spans.DISPATCH)]
    for name in FAULT_SPANS:
        assert dispatch.get(name, 0.0) > 0.0, name


def test_fault_path_records_nothing_with_tracing_off():
    spans.clear()
    assert not spans.on()
    report, results, stats = _fault_round(PimDatabase(_tables(),
                                                      device="cpu"))
    assert stats["degraded_windows"] == 3 and report["lineitem"]["hard"]
    assert spans.spans() == []


def test_recorder_cap_counts_what_it_drops():
    rec = spans.SpanRecorder(capacity=3)
    for i in range(5):
        rec.add(spans.Span(f"s{i}", 0.0, 1.0, "t", i, None, None, None,
                           None, {}))
    assert [s.name for s in rec.spans()] == ["s0", "s1", "s2"]
    assert rec.dropped == 2
    rec.clear()
    assert rec.spans() == [] and rec.dropped == 0


def _span(name, start, end, thread="pim-dispatch_0", origin=None, i=[0]):
    i[0] += 1
    return spans.Span(name, start, end, thread, i[0], None, None, None,
                      origin, {})


def test_clip_cuts_spans_to_the_interval():
    ss = [_span("a", 0.0, 2.0), _span("b", 1.0, 3.0), _span("c", 3.0, 4.0),
          _span("d", -1.0, 0.0)]
    got = spans.clip(ss, 0.5, 3.0)
    assert [(s.name, s.start, s.end) for s in got] == [
        ("a", 0.5, 2.0), ("b", 1.0, 3.0)]


def test_idle_by_span_shares_idle_by_the_innermost_span():
    # dispatch thread: window [0, 6) holding unpack [1, 3) and launch
    # [4, 5); the device is busy [4.2, 4.8); a queue wait is left out.
    ss = [_span("dispatch.window", 0.0, 6.0), _span("db.unpack", 1.0, 3.0),
          _span("db.launch", 4.0, 5.0),
          _span("svc.queue", 0.0, 9.0, origin="event loop"),
          _span("host.stage", 7.0, 8.0, thread="host-stage_0")]
    out = spans.idle_by_span([(4.2, 4.8)], ss, 0.0, 10.0)
    assert out["window_s"] == 10.0
    assert math.isclose(out["idle_s"], 9.4)
    d = out["idle_by_span"]["pim-dispatch_0"]
    assert math.isclose(d["db.unpack"], 2.0)
    assert math.isclose(d["db.launch"], 0.4)
    assert math.isclose(d["dispatch.window"], 3.0)
    assert math.isclose(d["(no span)"], 4.0)
    h = out["idle_by_span"]["host-stage_0"]
    assert math.isclose(h["host.stage"], 1.0)
    assert math.isclose(h["(no span)"], 8.4)
    assert math.isclose(out["dispatch_busy_share"], 0.6)
