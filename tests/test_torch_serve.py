"""Port: the async serving front end (``repro_torch.serve``) and the
trace-replay driver (``repro_torch.launch.serve``).

The cases of ``tests/test_serve.py`` on the port's modules (its 8-device
mesh smoke test is ``tests/test_torch_distributed.py::
test_serve_mesh_smoke``), on the CPU (the kernels' plain versions): the version-keyed result cache
and its key, the admission batcher, ``_pct``, cache hit / version
invalidation through ``submit``, in-flight coalescing, concurrent-submit
parity with sequential ``execute``, the EAGER engine, backpressure, the
failure paths (a dispatch failure reaches every coalesced waiter; a
closed service rejects promptly), the ``htap_stream`` service counters of
``benchmarks/baseline.json``, and ``parse_trace`` / ``serve_trace`` /
the ``--mode db`` CLI.

Parity with the reference (jax only through ``pytest.importorskip``): the
cache keys of every spec equal the reference's, before and after the same
mutations; the LRU gives the same hits, evictions and ``stats()``; the
batcher the same windows and counters; ``_pct`` the same percentiles;
the service the same results. The counters that depend on event-loop
timing (windows, coalescing, cache hits of a concurrent replay) are held
to invariants instead: parity with sequential execution, at most one
dispatch per relation a window touches, every submission completed.

Every coroutine runs under ``asyncio.wait_for(..., 60)``: a wedged
service fails its test instead of hanging the suite.
"""
import asyncio
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import dml
from repro_torch.core import bitslice
from repro_torch.db import queries, tpch
from repro_torch.db.database import Engine, PimDatabase
from repro_torch.launch import serve as launch
from repro_torch.serve import (AdmissionBatcher, QueryService, ResultCache,
                               spec_cache_key)
from repro_torch.serve.service import _pct

SF, SEED = 0.002, 123
ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 60
_CACHE: dict = {}


def _run(coro):
    """Run one coroutine to its end, failing after ``TIMEOUT_S``."""
    return asyncio.run(asyncio.wait_for(coro, timeout=TIMEOUT_S))


def _tables():
    if "tables" not in _CACHE:
        _CACHE["tables"] = tpch.generate(sf=SF, seed=SEED)
    return _CACHE["tables"]


@pytest.fixture(scope="module")
def db():
    """A shared port database. Tests that mutate it use their own."""
    return PimDatabase(_tables(), device="cpu")


def _ref():
    """The reference's modules (skips where jax is missing)."""
    pytest.importorskip("jax")
    from repro import dml as rdml
    from repro.db import database as rdb
    from repro.db import queries as rq
    from repro.serve import service as rservice
    from repro import serve as rserve
    return rdml, rdb, rq, rserve, rservice


# --------------------------------------------------------------------------
# Cache key + ResultCache, against the reference
# --------------------------------------------------------------------------
def test_spec_cache_key_structural(db):
    from repro_torch.db.compiler import And, Between, Cmp, Col, Lit

    q6 = queries.get_query("Q6")
    assert spec_cache_key(db, q6, Engine.FUSED) \
        == spec_cache_key(db, q6, Engine.FUSED)
    assert spec_cache_key(db, q6, Engine.FUSED) \
        != spec_cache_key(db, q6, Engine.EAGER)
    # Equal-meaning, differently-spelled predicates share a key.
    col = Col("l_quantity")
    a = dataclasses.replace(q6, filters={"lineitem": Between(col, 10, 20)})
    b = dataclasses.replace(q6, filters={"lineitem": And(
        Cmp("ge", col, Lit(10)), Cmp("le", col, Lit(20)))})
    assert spec_cache_key(db, a, Engine.FUSED) \
        == spec_cache_key(db, b, Engine.FUSED)

    # The reference's keys of the same requests are the same tuples, for
    # every spec of all_queries() on every engine, and for the respelled
    # predicates above.
    _, rdb, rq, rserve, _ = _ref()
    from repro.db import compiler as rc
    ref = rdb.PimDatabase(_tables())
    for spec, rspec in zip(queries.all_queries(), rq.all_queries()):
        for e in Engine:
            assert spec_cache_key(db, spec, e) == rserve.spec_cache_key(
                ref, rspec, rdb.Engine(e.value)), (spec.name, e)
    rq6 = rq.get_query("Q6")
    rcol = rc.Col("l_quantity")
    ra = dataclasses.replace(rq6, filters={"lineitem": rc.Between(rcol, 10,
                                                                  20)})
    rb = dataclasses.replace(rq6, filters={"lineitem": rc.And(
        rc.Cmp("ge", rcol, rc.Lit(10)), rc.Cmp("le", rcol, rc.Lit(20)))})
    assert spec_cache_key(db, a, Engine.FUSED) == rserve.spec_cache_key(
        ref, ra, rdb.Engine.FUSED) == rserve.spec_cache_key(
        ref, rb, rdb.Engine.FUSED)


def test_cache_key_tracks_relation_version():
    """Real mutations, not a simulated version bump: the publish step of
    ``PimDatabase.apply`` is what the key tracks, and ``bump_version``
    moves it too. The reference's keys follow the same steps equal."""
    rdml, rdb, rq, rserve, _ = _ref()
    db = PimDatabase(_tables(), device="cpu")
    ref = rdb.PimDatabase(_tables())
    pairs = {n: (queries.get_query(n), rq.get_query(n))
             for n in ("Q6", "Q14")}

    def keys():
        got = {n: spec_cache_key(db, s, Engine.FUSED)
               for n, (s, _) in pairs.items()}
        want = {n: rserve.spec_cache_key(ref, r, rdb.Engine.FUSED)
                for n, (_, r) in pairs.items()}
        assert got == want
        return got

    k0 = keys()
    take = {a: np.asarray(c[:2]) for a, c in _tables()["lineitem"].items()}
    db.apply([dml.Insert("lineitem", take)])
    ref.apply([rdml.Insert("lineitem", take)])
    k1 = keys()
    assert k1["Q6"] != k0["Q6"]
    # Mutating an unrelated relation leaves other queries' keys alone.
    db.apply([dml.Delete("customer", row_ids=[0])])
    ref.apply([rdml.Delete("customer", row_ids=[0])])
    k2 = keys()
    assert k2["Q14"] == k1["Q14"] and k2["Q6"] == k1["Q6"]
    db.bump_version("part")
    ref.bump_version("part")
    k3 = keys()
    assert k3["Q14"] != k2["Q14"] and k3["Q6"] == k2["Q6"]


def test_result_cache_lru():
    _, _, _, rserve, _ = _ref()
    ours, theirs = ResultCache(capacity=2), rserve.ResultCache(capacity=2)
    got, want = [], []
    for c, log in ((ours, got), (theirs, want)):
        c.put(("a",), "ra")
        c.put(("b",), "rb")
        log.append(c.get(("a",)))             # refreshes 'a'
        c.put(("c",), "rc")                   # evicts 'b' (LRU)
        log.append(c.get(("b",)))
        log += [c.get(("a",)), c.get(("c",)), len(c), c.stats()]
    assert got == want
    assert got[:4] == ["ra", None, "ra", "rc"]
    s = ours.stats()
    assert s["evictions"] == 1 and s["size"] == 2
    assert s["hits"] == 3 and s["misses"] == 1
    off = ResultCache(capacity=0)
    off.put(("a",), "ra")
    assert off.get(("a",)) is None and len(off) == 0


# --------------------------------------------------------------------------
# Admission batcher and _pct, against the reference
# --------------------------------------------------------------------------
def _batcher_by_size(cls):
    windows = []

    async def run():
        b = cls(windows.append, max_window=3, max_wait_s=60.0)
        for i in range(7):
            b.add(i)
        # Two size-flushes fired inline; one item still pending on the
        # (long) timer.
        assert b.pending == 1
        b.flush_now()
        return b.stats()

    return windows, _run(run())


def _batcher_by_timeout(cls):
    windows = []

    async def run():
        b = cls(windows.append, max_window=100, max_wait_s=0.02)
        b.add("x")
        b.add("y")
        assert b.pending == 2 and not windows
        await asyncio.sleep(0.1)
        return b.stats()

    return windows, _run(run())


def test_batcher_flush_on_size():
    windows, stats = _batcher_by_size(AdmissionBatcher)
    assert windows == [[0, 1, 2], [3, 4, 5], [6]]
    assert stats["flush_size"] == 2
    assert stats["flush_timeout"] == 0
    assert stats["flush_forced"] == 1
    assert stats["max_window_seen"] == 3
    _, _, _, rserve, _ = _ref()
    assert _batcher_by_size(rserve.AdmissionBatcher) == (windows, stats)


def test_batcher_flush_on_timeout():
    windows, stats = _batcher_by_timeout(AdmissionBatcher)
    assert windows == [["x", "y"]]
    assert stats["flush_timeout"] == 1 and stats["flush_size"] == 0
    _, _, _, rserve, _ = _ref()
    assert _batcher_by_timeout(rserve.AdmissionBatcher) == (windows, stats)


def test_batcher_rejects_bad_window():
    with pytest.raises(ValueError):
        AdmissionBatcher(lambda w: None, max_window=0)


@pytest.mark.parametrize("vals", [[1.0], [1.0, 2.0, 3.0, 4.0],
                                  [float(i) for i in range(101)],
                                  [0.5, 0.25, 7.0]])
def test_pct_helper(vals):
    vals = sorted(vals)
    assert _pct([1.0], 0.99) == 1.0
    assert _pct([1.0, 2.0, 3.0, 4.0], 0.0) == 1.0
    assert _pct([1.0, 2.0, 3.0, 4.0], 0.99) == 4.0
    _, _, _, _, rservice = _ref()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert _pct(vals, q) == rservice._pct(vals, q)


# --------------------------------------------------------------------------
# Service: cache hit/miss/invalidation through submit()
# --------------------------------------------------------------------------
def test_service_cache_hit_and_version_invalidation():
    db = PimDatabase(_tables(), device="cpu")
    q6 = queries.get_query("Q6")
    want = db.execute(q6)

    async def run():
        async with QueryService(db, max_window=4, max_wait_s=0.001) as svc:
            r1 = await svc.submit(q6)
            r2 = await svc.submit(q6)
            misses_before_dml = svc.cache.misses
            # Real DML through the service: deleting live rows bumps the
            # published relation version, so the stale cached result can
            # never be served again.
            ids = db.dml_state("lineitem").live_ids()[:2]
            await svc.apply([dml.Delete("lineitem", row_ids=ids)])
            r3 = await svc.submit(q6)
            return (r1, r2, r3, misses_before_dml, svc.cache.stats(),
                    svc.stats())

    r1, r2, r3, misses_before, cstats, sstats = _run(run())
    assert not r1.cached and r2.cached
    # The mutation changed the key: r3 re-dispatched (a miss) and ran
    # against the post-delete contents — equal to a fresh direct execute
    # on the mutated database and to ORACLE.
    assert not r3.cached
    assert cstats["misses"] == misses_before + 1
    assert r1.aggregates == r2.aggregates == want.aggregates
    assert r3.aggregates == db.execute(q6).aggregates \
        == db.execute(q6, engine=Engine.ORACLE).aggregates
    assert sstats["mutations"] == 1


def test_service_coalesces_identical_inflight(db):
    q1 = queries.get_query("Q1")
    want = db.execute(q1)

    async def run():
        async with QueryService(db, max_window=8, max_wait_s=0.005) as svc:
            res = await asyncio.gather(*[svc.submit(q1) for _ in range(5)])
            return res, svc.stats()

    res, stats = _run(run())
    assert all(r.aggregates == want.aggregates for r in res)
    assert stats["coalesced"] == 4
    assert stats["batcher"]["items"] == 1     # ONE dispatched request
    assert stats["dispatches"] == 1


# --------------------------------------------------------------------------
# Concurrent-submit parity vs sequential execute (and the reference)
# --------------------------------------------------------------------------
PARITY_TRACE = ("Q1", "Q6", "Q14", "Q3", "Q6", "Q1")


def _parity_trace(db, svc_kwargs=None):
    specs = [queries.get_query(n) for n in PARITY_TRACE]
    seq = [db.execute(s) for s in specs]

    async def run():
        async with QueryService(db, max_window=4, max_wait_s=0.005,
                                **(svc_kwargs or {})) as svc:
            res = await asyncio.gather(*[svc.submit(s) for s in specs])
            return res, svc.stats()

    res, stats = _run(run())
    for name, r, s in zip(PARITY_TRACE, res, seq):
        assert r.rows == s.rows, name
        assert r.aggregates == s.aggregates, name
    assert stats["completed"] == stats["submitted"] == len(specs)
    assert stats["errors"] == 0 and stats["inflight"] == 0
    # A window dispatches each relation it touches once: never more than
    # one dispatch per (distinct spec, relation) of the trace.
    distinct = {n: queries.get_query(n) for n in PARITY_TRACE}
    assert stats["dispatches"] <= sum(len(s.pim_relations())
                                      for s in distinct.values())
    return res, stats


def test_service_concurrent_parity(db):
    res, stats = _parity_trace(db)
    # Windowed linking must beat one dispatch per (query, relation).
    assert stats["dispatches"] < 8
    # The reference's service on the same trace gives the same results.
    _, rdb, rq, rserve, _ = _ref()
    ref = rdb.PimDatabase(_tables())
    specs = [rq.get_query(n) for n in PARITY_TRACE]

    async def run():
        async with rserve.QueryService(ref, max_window=4,
                                       max_wait_s=0.005) as svc:
            return await asyncio.gather(*[svc.submit(s) for s in specs])

    for name, got, want in zip(PARITY_TRACE, res, _run(run())):
        assert got.rows == want.rows, name
        assert got.aggregates == want.aggregates, name


def test_service_eager_engine_parity(db):
    q6 = queries.get_query("Q6")
    want = db.execute(q6, engine=Engine.EAGER)

    async def run():
        async with QueryService(db, engine=Engine.EAGER,
                                max_wait_s=0.001) as svc:
            return await svc.submit(q6), svc.stats()

    got, stats = _run(run())
    assert got.aggregates == want.aggregates \
        == db.execute(q6, engine=Engine.ORACLE).aggregates
    assert got.engine is Engine.EAGER
    assert stats["dispatches"] == 0           # no fused dispatch at all


# --------------------------------------------------------------------------
# Backpressure
# --------------------------------------------------------------------------
def test_service_backpressure_semaphore(db):
    q6 = queries.get_query("Q6")
    q1 = queries.get_query("Q1")

    async def run():
        svc = QueryService(db, max_window=1, max_wait_s=0.001,
                           max_pending=2, cache_capacity=0)
        async with svc:
            res = await asyncio.gather(
                *[svc.submit(q6 if i % 2 else q1) for i in range(6)])
            # All admissions resolved and every permit was returned.
            assert svc._sem._value == 2
            return res, svc.stats()

    res, stats = _run(run())
    assert len(res) == 6 and stats["errors"] == 0
    # cache_capacity=0 disables the result cache; repeats still resolve
    # (coalescing or fresh dispatch), so the semaphore really cycled.
    assert stats["cache"]["hits"] == 0
    want = {n: db.execute(queries.get_query(n)).aggregates
            for n in ("Q1", "Q6")}
    assert [r.aggregates for r in res] == \
        [want["Q6" if i % 2 else "Q1"] for i in range(6)]


# --------------------------------------------------------------------------
# Failure paths: rejection fan-out, permit restoration, cache hygiene
# --------------------------------------------------------------------------
def test_dispatch_failure_propagates_to_all_coalesced_waiters(db):
    # A dispatch-worker exception must reach EVERY awaiter parked on the
    # window — the submitter that admitted the query AND the coalesced
    # submissions sharing its key — and must restore the backpressure
    # permit, or the service wedges after its first bad window. It is
    # not a transient fault: no retry, no degraded window.
    q6 = queries.get_query("Q6")
    boom = ValueError("injected dispatch failure")
    calls = []

    def bad_dispatch(specs):
        calls.append(len(specs))
        raise boom

    async def run():
        svc = QueryService(db, max_window=8, max_wait_s=0.05, max_pending=2)
        db.dispatch_batch = bad_dispatch
        try:
            async with svc:
                # Both submits land before the (slow) timer flush: the
                # second coalesces onto the first's in-flight future.
                res = await asyncio.gather(svc.submit(q6), svc.submit(q6),
                                           return_exceptions=True)
                assert [r is boom for r in res] == [True, True]
                assert svc.stats()["coalesced"] == 1
                # The failed admission returned its permit.
                assert svc._sem._value == 2
                # A failed result is never cached, and nothing is stuck
                # in flight: a resubmit with the fault cleared dispatches
                # fresh and matches direct execution.
                del db.dispatch_batch
                key = spec_cache_key(db, q6, Engine.FUSED)
                assert svc.cache.get(key) is None
                assert not svc._inflight
                ok = await svc.submit(q6)
                assert not ok.cached
                assert ok.aggregates == db.execute(q6).aggregates
                return svc.stats()
        finally:
            db.__dict__.pop("dispatch_batch", None)

    stats = _run(run())
    # One rejection (the coalesced waiter shares the future), nothing
    # left in flight, one failed dispatch attempt.
    assert stats["errors"] == 1
    assert stats["inflight"] == 0
    assert calls == [1]
    assert stats["retries"] == stats["transient_faults"] == 0
    assert stats["degraded_windows"] == 0


def test_closed_service_rejects_promptly(db):
    # Submitting after close() must fail fast (the window handoff to the
    # shut-down pool raises and every request is rejected) — never hang
    # the awaiter on a future nothing will resolve.
    q6 = queries.get_query("Q6")

    async def run():
        svc = QueryService(db, max_window=4, max_wait_s=0.001)
        svc.close()
        with pytest.raises(RuntimeError):
            await asyncio.wait_for(svc.submit(q6), timeout=30)
        assert svc._sem._value == svc.max_pending
        return svc.stats()

    stats = _run(run())
    assert stats["errors"] == 1 and stats["inflight"] == 0


# --------------------------------------------------------------------------
# The htap_stream service counters (benchmarks/baseline.json)
# --------------------------------------------------------------------------
def _htap_replays(db, rounds, k, replays):
    """``bench_htap_stream``'s traffic through the service: ``replays``
    passes (the cold one and the warm ones) over one database, each a
    fresh ``QueryService`` running ``rounds`` rounds of ``svc.apply([
    Insert(k rows drawn by default_rng(7)), Delete(the previous round's
    ids)])`` then Q1 and Q6 ``filter_only()`` submitted one at a time.
    Q6 is held to the mutable-table oracle and Q1 to the numpy baseline
    every round, and no result after a mutation comes from the cache.
    Returns the last pass's service stats."""
    q1 = queries.get_query("Q1").filter_only()
    spec6 = queries.get_query("Q6")
    q6 = spec6.filter_only()
    oracle = dml.MutableTable(db.tables["lineitem"])
    src = {a: np.asarray(c) for a, c in db.tables["lineitem"].items()}
    n0 = oracle.n_rows
    rng = np.random.default_rng(7)

    async def one_pass():
        svc = QueryService(db, max_window=4, max_wait_s=0.001)
        prev = []
        async with svc:
            for _ in range(rounds):
                idx = rng.integers(0, n0, k)
                rows = {a: c[idx] for a, c in src.items()}
                muts = [dml.Insert("lineitem", rows)]
                if prev:
                    muts.append(dml.Delete("lineitem", row_ids=prev))
                await svc.apply(muts)
                new_ids = oracle.insert(rows)
                if prev:
                    oracle.delete(row_ids=prev)
                prev = new_ids
                r1 = await svc.submit(q1)
                r6 = await svc.submit(q6)
                exp = oracle.aggregate(spec6.filters["lineitem"],
                                       spec6.aggregates)
                assert tuple(r6.aggregates["all"][a.name]
                             for a in spec6.aggregates) == exp
                assert r1.aggregates == db.run_baseline(q1).aggregates
                assert not r1.cached and not r6.cached
        return svc.stats()

    for _ in range(replays):
        stats = _run(one_pass())
    return stats


def test_htap_stream_service_counters_match_baseline():
    base = json.loads((ROOT / "benchmarks/baseline.json").read_text())
    meta = base["rows"]["htap_stream"]["meta"]
    db = PimDatabase(tpch.generate(sf=base["sf"], seed=0), device="cpu")
    stats = _htap_replays(db, meta["rounds"], meta["batch"], replays=4)
    got = {"dispatches": stats["dispatches"],
           "plane_reads": stats["plane_reads"],
           "mutations": stats["mutations"]}
    assert got == {key: meta[key] for key in got}
    assert got == {"dispatches": 12, "plane_reads": 1422, "mutations": 11}
    assert stats["errors"] == 0 and stats["cache"]["hits"] == 0


# --------------------------------------------------------------------------
# The tape cache across a growth (ROADMAP C7d)
# --------------------------------------------------------------------------
def _grow_through(svc_cls, db, dml_mod, spec):
    """Through a fresh service: ``spec``, an insert of one row more than
    lineitem's spare slots (one tile of growth), ``spec`` again. Returns
    the two results and the program-cache misses the second one took."""
    d = db.dml_state("lineitem")
    src = {a: np.asarray(c) for a, c in db.tables["lineitem"].items()}
    n = len(next(iter(src.values())))
    idx = np.arange(d.capacity - len(d.slot_of) + 1) % n

    async def run():
        async with svc_cls(db, max_wait_s=0.001) as svc:
            before = await svc.submit(spec)
            await svc.apply([dml_mod.Insert(
                "lineitem", {a: c[idx] for a, c in src.items()})])
            m0 = svc.stats()["program_cache"]["misses"]
            after = await svc.submit(spec)
            return before, after, svc.stats()["program_cache"]["misses"] - m0

    return _run(run())


def test_growth_program_cache_differs_from_reference():
    """The port's tape-cache signature has no word count (ROADMAP C7d): after
    a growth the service's ``stats()["program_cache"]`` shows no miss
    where the reference's shows one recompile. The results are equal."""
    db = PimDatabase(tpch.generate(sf=SF, seed=0), device="cpu")
    words0 = db.dml_state("lineitem").rel.layout.n_words
    q6 = queries.get_query("Q6").filter_only()
    before, after, misses = _grow_through(QueryService, db, dml, q6)
    assert db.relations["lineitem"].layout.n_words == \
        words0 + bitslice.TILE_WORDS
    assert misses == 0
    assert after.aggregates == db.execute(q6, engine="oracle").aggregates

    rdml, rdb, rq, rserve, _ = _ref()
    ref = rdb.PimDatabase(tpch.generate(sf=SF, seed=0))
    rbefore, rafter, rmisses = _grow_through(
        rserve.QueryService, ref, rdml, rq.get_query("Q6").filter_only())
    assert rmisses == 1
    assert (rbefore.aggregates, rafter.aggregates) == \
        (before.aggregates, after.aggregates)


# --------------------------------------------------------------------------
# The trace-replay driver
# --------------------------------------------------------------------------
def test_parse_trace_matches_reference():
    trace = "Q1,Q6x3, Q3,,Q14x2"
    names = [s.name for s in launch.parse_trace(trace)]
    assert names == ["Q1", "Q6", "Q6", "Q6", "Q3", "Q14", "Q14"]
    assert launch.DEFAULT_TRACE.count(",") == 15
    pytest.importorskip("jax")
    from repro.launch import serve as rlaunch
    assert rlaunch.DEFAULT_TRACE == launch.DEFAULT_TRACE
    assert [s.name for s in rlaunch.parse_trace(trace)] == names


def test_serve_trace_equals_sequential(db):
    specs = launch.parse_trace("Q1,Q6x2,Q14,Q3,Q12,Q6")
    results, stats, wall = launch.serve_trace(db, specs, concurrency=4,
                                              max_window=4)
    seq = [db.execute(s) for s in specs]
    assert [(r.rows, r.aggregates) for r in results] == \
        [(s.rows, s.aggregates) for s in seq]
    assert stats["completed"] == stats["submitted"] == len(specs)
    assert stats["errors"] == 0 and wall > 0


def test_serve_cli_compare_reports_parity(capsys):
    launch.main(["--mode", "db", "--sf", "0.001", "--device", "cpu",
                 "--compare", "--trace", "Q1,Q6x2,Q14"])
    out = capsys.readouterr().out
    assert "replaying 4 queries" in out
    assert "(bit-parity ok)" in out


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------
@pytest.mark.cuda
def test_service_concurrent_parity_on_card():
    """The parity trace through a service over relations on the card:
    equal to the card's sequential results and to the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "false")
    card = PimDatabase(_tables())
    res, _ = _parity_trace(card)
    cpu = PimDatabase(_tables(), device="cpu")
    for name, r in zip(PARITY_TRACE, res):
        want = cpu.execute(queries.get_query(name))
        assert (r.rows, r.aggregates) == (want.rows, want.aggregates), name
