"""Port: fault tolerance (``repro_torch.faults``).

The cases of ``tests/test_faults.py`` on the port's modules, on the CPU
(the kernels' plain versions), each driven through the port and through
the reference (jax only through ``pytest.importorskip``) with the same
inputs and held equal: the guard-plane detection property (any single
flip caught, the same scrub report, the planes restored bit for bit),
zero false positives on legitimate DML (the expected parity words equal
the reference's after every batch), scrub -> republish -> a new cache
key, endurance death -> remap with oracle parity, the stuck cell, the
ghost valid flip, the retry policy, the breaker, the dispatch-fault
queue, the two service scenarios with a fault manager, and the chaos soak
(its whole report, all but ``wall_s`` and ``qps``). Bit 31 (a uint32
word's sign bit in the port's int32 planes) gets its own cases: a
stuck-at-1 and a stuck-at-0 cell there re-asserted after a write, and a
flip of bit 31 of a valid word.

The write-fault hook is process-wide: every test that arms a
``FaultManager`` disarms it in ``finally``. Every coroutine runs under
``asyncio.wait_for(..., 60)``.
"""
import asyncio
import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro_torch import dml, faults, serve
from repro_torch.core import engine as eng
from repro_torch.db import database, queries, tpch
from repro_torch.faults import (CircuitBreaker, DeviceFaultModel,
                                RetryPolicy, TransientDispatchError)
from repro_torch.faults import chaos, guard

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


def _port(device="cpu"):
    """The port's modules and a fresh database on ``device``."""
    return SimpleNamespace(
        dml=dml, faults=faults, queries=queries, serve=serve, chaos=chaos,
        Engine=database.Engine,
        db=lambda: database.PimDatabase(_tables(), device=device))


def _ref():
    """The reference's modules and a fresh database (skips where jax is
    missing)."""
    pytest.importorskip("jax")
    from repro import dml as rdml
    from repro import faults as rfaults
    from repro import serve as rserve
    from repro.db import database as rdb
    from repro.db import queries as rq
    from repro.faults import chaos as rchaos
    return SimpleNamespace(
        dml=rdml, faults=rfaults, queries=rq, serve=rserve, chaos=rchaos,
        Engine=rdb.Engine, db=lambda: rdb.PimDatabase(_tables()))


def _words(x) -> np.ndarray:
    """Plane or valid words of either package as numpy uint32."""
    if isinstance(x, torch.Tensor):
        return eng.to_words(x)
    return np.asarray(x, np.uint32)


def _same_relation(db, ref, name):
    """Both databases hold the same words for ``name`` (planes, valid)."""
    ours, theirs = db.relations[name], ref.relations[name]
    assert np.array_equal(_words(ours.valid), _words(theirs.valid))
    assert set(ours.planes) == set(theirs.planes)
    for a, p in theirs.planes.items():
        assert np.array_equal(_words(ours.planes[a]), _words(p)), a


# --------------------------------------------------------------------------
# Guard planes: detection property
# --------------------------------------------------------------------------
def _guarded(pkg, key):
    # Lazy singletons, not fixtures: the hypothesis shim hides the
    # wrapped signature from pytest.
    if key not in _CACHE:
        db = pkg.db()
        fm = pkg.faults.FaultManager(db)
        fm.guard_relation("customer")
        _CACHE[key] = (db, fm)
    return _CACHE[key]


@settings(max_examples=12, deadline=None)
@given(st.integers(0, 10**9), st.integers(0, 10**9), st.booleans())
def test_any_single_flip_is_detected(slot_draw, plane_draw, hit_valid):
    """Zero false negatives: every injected single-cell flip — any
    attribute, any plane, any slot (live, deleted, or ghost capacity) —
    is localized by the next scrub; the repair restores the planes and
    the immediate re-scrub is clean. The reference, given the same flip,
    reports the same and ends with the same words."""
    db, fm = _guarded(_port(), "port")
    d = db.dml_state("customer")
    slot = slot_draw % d.capacity
    if hit_valid:
        attr, plane = "__valid__", 0
    else:
        attrs = sorted(d.rel.layout.attributes)
        attr = attrs[plane_draw % len(attrs)]
        plane = plane_draw % d.rel.layout.attributes[attr].n_bits
    fm.inject_flip("customer", attr, slot, plane)
    report = fm.scrub()
    assert ("customer", attr, slot) in fm.detected
    assert (attr, slot) in report["customer"]["corrupt"]
    assert not fm.undetected()
    # Repair restored the planes: the very next scrub sees nothing.
    assert fm.scrub() == {}

    ref, rfm = _guarded(_ref(), "ref")
    rfm.inject_flip("customer", attr, slot, plane)
    assert rfm.scrub() == report
    assert rfm.scrub() == {}
    _same_relation(db, ref, "customer")
    assert (fm.n_detected, fm.n_repaired_rows, fm.n_scrubs) == \
        (rfm.n_detected, rfm.n_repaired_rows, rfm.n_scrubs)


def _legit_dml(pkg):
    """Insert / delete / in-place update / update-by-move (widen) /
    compact on a guarded lineitem; yields after every batch."""
    db = pkg.db()
    fm = pkg.faults.FaultManager(db)
    fm.guard_relation("lineitem")
    take = {a: np.asarray(c[:6]) for a, c in db.tables["lineitem"].items()}
    D = pkg.dml
    wide = 1 << db.relations["lineitem"].layout.attributes[
        "l_quantity"].n_bits
    for batch in ([D.Insert("lineitem", take)],
                  [D.Delete("lineitem", row_ids=[1, 3]),
                   D.Update("lineitem", {"l_quantity": 9}, row_ids=[0, 2])],
                  [D.Update("lineitem", {"l_quantity": wide},
                            row_ids=[4])],       # widen + move
                  [D.Compact("lineitem")]):
        db.apply(batch)
        yield db, fm


def test_legit_dml_no_false_positives():
    """The parity expectation tracks the instruction stream exactly: no
    scrub detection after legitimate DML, and after every batch the
    expected parity words, the quarantine words and the planes equal the
    reference's."""
    r = _ref()
    for (db, fm), (ref, rfm) in zip(_legit_dml(_port()), _legit_dml(r)):
        g, rg = fm.guards["lineitem"], rfm.guards["lineitem"]
        assert set(g.parity) == set(rg.parity)
        for a, p in rg.parity.items():
            assert p.dtype == g.parity[a].dtype == np.uint32
            assert np.array_equal(g.parity[a], p), a
        assert np.array_equal(g.quarantined, rg.quarantined)
        _same_relation(db, ref, "lineitem")
    assert fm.scrub() == {} == rfm.scrub()
    assert fm.n_detected == rfm.n_detected == 0


def test_scrub_repairs_publish_and_invalidate_cache():
    """A repair bumps the relation version, so a result cached against
    corrupt contents can never be served again (by construction); the
    keys equal the reference's at each step."""
    keys = []
    for pkg in (_port(), _ref()):
        db = pkg.db()
        fm = pkg.faults.FaultManager(db)
        fm.guard_relation("lineitem")
        q6 = pkg.queries.get_query("Q6")
        v0 = db.relations["lineitem"].version
        k0 = pkg.serve.spec_cache_key(db, q6, pkg.Engine.FUSED)
        fm.inject_flip("lineitem", "l_quantity", 5, 0)
        # Silent corruption must NOT bump the version on its own...
        assert db.relations["lineitem"].version == v0
        k1 = pkg.serve.spec_cache_key(db, q6, pkg.Engine.FUSED)
        report = fm.scrub()
        # ...but detection + repair must.
        assert db.relations["lineitem"].version > v0
        k2 = pkg.serve.spec_cache_key(db, q6, pkg.Engine.FUSED)
        assert k0 == k1 != k2
        keys.append((k0, k2, report))
    assert keys[0] == keys[1]


# --------------------------------------------------------------------------
# Hard faults: endurance death, stuck cells, remap + quarantine
# --------------------------------------------------------------------------
def _dead_row_remap(pkg):
    """A hot row whose wear crosses the endurance budget dies; the next
    update is dropped by the device, verify-after-write flags it, the
    scrub remaps the row into spare capacity. Returns what the test
    compares."""
    db = pkg.db()
    layout = db.relations["lineitem"].layout
    budget = layout.row_bits + 1.5 * layout.attributes["l_quantity"].n_bits
    fm = pkg.faults.FaultManager(db, endurance_budget=budget)
    fm.guard_relation("lineitem")
    oracle = pkg.dml.MutableTable(db.tables["lineitem"])
    spec = pkg.queries.get_query("Q6")
    fm.arm()
    try:
        died = []
        for rnd in range(40):
            m = pkg.dml.Update("lineitem", {"l_quantity": rnd % 50 + 1},
                               row_ids=[0])
            db.apply([m])
            oracle.apply(m)
            died = fm.update_wear("lineitem")
            if died:
                break
        assert died, "endurance budget never crossed"
        dead_slot = died[0]
        # The next update to the dead row is silently dropped by the
        # device...
        m = pkg.dml.Update("lineitem", {"l_quantity": 33}, row_ids=[0])
        db.apply([m])
        oracle.apply(m)
        assert fm.n_write_faults > 0
        # ...and the scrub remaps the row off the dead slot.
        report = fm.scrub()
        assert report["lineitem"]["hard"] == [dead_slot]
        d = db.dml_state("lineitem")
        assert d.slot_of[0] != dead_slot
        assert d.segments.n_retired == 1
        assert fm.n_remapped_rows == 1
    finally:
        fm.disarm()
    # Post-recovery parity against the independent oracle.
    r = db.execute(spec.filter_only(), engine=pkg.Engine.FUSED)
    exp = oracle.aggregate(spec.filters["lineitem"], spec.aggregates)
    got = tuple(r.aggregates["all"][a.name] for a in spec.aggregates)
    assert got == exp
    # Retired slots are never handed out again.
    take = {a: np.asarray(c[:64]) for a, c in db.tables["lineitem"].items()}
    new_ids = db.dml_state("lineitem").insert(take)
    assert dead_slot not in {db.dml_state("lineitem").slot_of[i]
                             for i in new_ids}
    return db, {"rounds": rnd, "died": died, "report": report,
                "write_faults": fm.n_write_faults, "aggregates": got,
                "slot_of": dict(d.slot_of), "new_ids": new_ids}


def test_dead_row_remap_oracle_parity():
    """The port on the CPU against the reference's ``jnp`` backend: the
    same death round and slot, scrub report, slot map, write faults,
    oracle-equal Q6 and plane words."""
    db, got = _dead_row_remap(_port())
    assert eng._WRITE_FAULT_HOOK is None
    ref, want = _dead_row_remap(_ref())
    assert got == want
    _same_relation(db, ref, "lineitem")


def _stuck_cell(pkg, slot=None, plane=0, value=1):
    db = pkg.db()
    fm = pkg.faults.FaultManager(db)
    fm.guard_relation("lineitem")
    d = db.dml_state("lineitem")
    if slot is None:
        # A live slot whose plane-0 l_quantity bit is 0, so stuck-at-1 is
        # immediately observable.
        slot = next(s for s in range(d.capacity)
                    if d.live[s] and not (int(d.shadow["l_quantity"][s]) & 1))
    lid = next(i for i, sl in d.slot_of.items() if sl == slot)
    fm.arm()
    try:
        fm.inject_stuck("lineitem", "l_quantity", slot, plane, value)
        assert fm.model.is_hard("lineitem", "l_quantity", slot)
        stuck_words = _words(db.relations["lineitem"].planes["l_quantity"])
        report = fm.scrub()
        assert report["lineitem"]["hard"] == [slot]
        assert d.slot_of[lid] != slot
        assert d.segments.n_retired == 1
        # The moved row reads back its true value from the new slot.
        assert fm.scrub() == {}
    finally:
        fm.disarm()
    return db, stuck_words, report, fm.n_injected


def test_stuck_cell_is_hard_and_remapped():
    db, words, report, n = _stuck_cell(_port())
    assert n == 1
    ref, rwords, rreport, rn = _stuck_cell(_ref())
    assert np.array_equal(words, rwords)
    assert (report, n) == (rreport, rn)
    _same_relation(db, ref, "lineitem")


def _ghost_valid_flip(pkg):
    """A flipped valid bit in never-allocated capacity makes a ghost row
    visible; the scrub detects it and the rewrite clears it again."""
    db = pkg.db()
    fm = pkg.faults.FaultManager(db)
    fm.guard_relation("lineitem")
    d = db.dml_state("lineitem")
    ghost = d.capacity - 1
    assert not d.live[ghost]
    q6 = pkg.queries.get_query("Q6").filter_only()
    baseline = db.run_baseline(q6)
    fm.inject_flip("lineitem", "__valid__", ghost, 0)
    flipped = _words(db.relations["lineitem"].valid)
    report = fm.scrub()
    assert ("__valid__", ghost) in report["lineitem"]["corrupt"]
    r = db.execute(q6, engine=pkg.Engine.FUSED)
    assert r.aggregates == baseline.aggregates
    return db, flipped, report


def test_ghost_valid_flip_repaired():
    db, flipped, report = _ghost_valid_flip(_port())
    ref, rflipped, rreport = _ghost_valid_flip(_ref())
    assert np.array_equal(flipped, rflipped)
    assert report == rreport
    _same_relation(db, ref, "lineitem")


# --------------------------------------------------------------------------
# Bit 31: the sign bit of the port's int32 words
# --------------------------------------------------------------------------
def _bit31_stuck(pkg, value):
    """A cell stuck at ``value`` in bit 31 of a word (slot 31, row 31): its
    stored bit forced now, re-asserted by the write hook after an update
    of the row that writes the other value, caught by verify-after-write
    and remapped by the scrub."""
    db = pkg.db()
    fm = pkg.faults.FaultManager(db)
    fm.guard_relation("lineitem")
    d = db.dml_state("lineitem")
    slot = 31
    assert d.slot_of[31] == slot
    cur = int(d.shadow["l_quantity"][slot])
    # The lowest plane whose stored bit differs from ``value``.
    plane = next(b for b in range(6) if ((cur >> b) & 1) != value)
    fm.arm()
    try:
        fm.inject_stuck("lineitem", "l_quantity", slot, plane, value)
        forced = _words(db.relations["lineitem"].planes["l_quantity"])
        assert ((int(forced[plane, 0]) >> 31) & 1) == value
        # Rewrite the row's own value, whose bit there is the other one:
        # the hook re-asserts the cell after the merge.
        db.apply([pkg.dml.Update("lineitem", {"l_quantity": cur},
                                 row_ids=[31])])
        after = _words(db.relations["lineitem"].planes["l_quantity"])
        assert ((int(after[plane, 0]) >> 31) & 1) == value
        faults_seen = fm.n_write_faults
        report = fm.scrub()
    finally:
        fm.disarm()
    return db, {"plane": plane, "forced": forced, "after": after,
                "write_faults": faults_seen, "report": report,
                "slot_of_31": d.slot_of[31]}


@pytest.mark.parametrize("value", [1, 0])
def test_bit31_stuck_cell_round_trips(value):
    db, got = _bit31_stuck(_port(), value)
    assert got["write_faults"] == 1
    assert got["report"]["lineitem"]["hard"] == [31]
    assert got["slot_of_31"] != 31
    ref, want = _bit31_stuck(_ref(), value)
    for k in ("forced", "after"):
        assert np.array_equal(got.pop(k), want.pop(k)), k
    assert got == want
    _same_relation(db, ref, "lineitem")


def test_bit31_valid_flip_round_trips():
    """A flip of bit 31 of a valid word (slot 63: word 1, bit 31) is the
    reference's word, is found by the scrub and is repaired; the parity
    row that detected it came off the device as uint32."""
    out = []
    for pkg in (_port(), _ref()):
        db = pkg.db()
        fm = pkg.faults.FaultManager(db)
        fm.guard_relation("lineitem")
        before = _words(db.relations["lineitem"].valid).copy()
        fm.inject_flip("lineitem", "__valid__", 63, 0)
        flipped = _words(db.relations["lineitem"].valid)
        assert int(flipped[1] ^ before[1]) == 1 << 31
        report = fm.scrub()
        assert ("__valid__", 63) in report["lineitem"]["corrupt"]
        assert np.array_equal(_words(db.relations["lineitem"].valid), before)
        out.append((flipped, report, db))
    assert np.array_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]
    _same_relation(out[0][2], out[1][2], "lineitem")
    assert guard.xor_reduce(torch.tensor([[-1], [0]],
                                         dtype=torch.int32)).tolist() \
        == [0xFFFFFFFF]


def test_force_stuck_bit31_masks_equal_reference():
    """``DeviceFaultModel.force_stuck`` on bit-31 masks: the port's int32
    merge gives the reference's uint32 words."""
    r = _ref()
    planes = np.random.default_rng(0).integers(
        0, 1 << 32, size=(3, 5), dtype=np.uint64).astype(np.uint32)
    ours, theirs = DeviceFaultModel(), r.faults.DeviceFaultModel()
    for m in (ours, theirs):
        m.add_stuck("t", "a", 31, 0, 1, 3, 5)       # word 0, bit 31 -> 1
        m.add_stuck("t", "a", 63, 2, 0, 3, 5)       # word 1, bit 31 -> 0
        m.add_stuck("t", "a", 64 * 2 + 5, 1, 1, 3, 5)
    got = ours.force_stuck("t", "a", eng.to_planes(planes, "cpu"))
    want = theirs.force_stuck("t", "a", planes)
    assert np.array_equal(_words(got), _words(want))
    assert (_words(got)[0, 0] >> 31) == 1 and (_words(got)[2, 1] >> 31) == 0


# --------------------------------------------------------------------------
# Retry policy + circuit breaker + dispatch-fault queue, against the
# reference
# --------------------------------------------------------------------------
def test_retry_policy_capped_exponential():
    rp = RetryPolicy(max_retries=4, base_delay_s=0.01, max_delay_s=0.05)
    assert rp.delay(0) == 0.01
    assert rp.delay(1) == 0.02
    assert rp.delay(2) == 0.04
    assert rp.delay(3) == 0.05      # capped
    assert rp.delay(10) == 0.05
    r = _ref()
    theirs = r.faults.RetryPolicy(max_retries=4, base_delay_s=0.01,
                                  max_delay_s=0.05)
    assert [rp.delay(a) for a in range(12)] == \
        [theirs.delay(a) for a in range(12)]
    assert dataclasses.asdict(RetryPolicy()) == \
        dataclasses.asdict(r.faults.RetryPolicy())


def _breaker_walk(br):
    log = []
    for step in "ffsffaafaasaaffaaaas":
        if step == "f":
            br.record_failure()
        elif step == "s":
            br.record_success()
        else:
            log.append(br.allow_fused())
        log.append((br.state, br.n_trips, br.n_recoveries))
    return log


def test_circuit_breaker_state_machine():
    br = CircuitBreaker(failure_threshold=2, cooldown_windows=2)
    assert br.state == "closed" and br.allow_fused()
    br.record_failure()
    assert br.state == "closed"     # below threshold
    br.record_success()
    br.record_failure()
    br.record_failure()             # 2 consecutive -> trip
    assert br.state == "open" and br.n_trips == 1
    assert not br.allow_fused()     # cooldown window 1
    assert br.allow_fused()         # cooldown elapsed -> half-open probe
    assert br.state == "half_open"
    br.record_failure()             # failed probe re-opens immediately
    assert br.state == "open" and br.n_trips == 2
    assert not br.allow_fused()
    assert br.allow_fused()
    br.record_success()             # successful probe closes
    assert br.state == "closed" and br.n_recoveries == 1
    r = _ref()
    for thr, cool in ((2, 2), (1, 3), (3, 1)):
        assert _breaker_walk(CircuitBreaker(thr, cool)) == \
            _breaker_walk(r.faults.CircuitBreaker(thr, cool))


def test_device_model_dispatch_fault_queue():
    m = DeviceFaultModel()
    m.check_dispatch()              # empty queue: no-op
    m.inject_dispatch_faults(2)
    with pytest.raises(TransientDispatchError, match="1 still queued"):
        m.check_dispatch()
    with pytest.raises(TransientDispatchError, match="0 still queued"):
        m.check_dispatch()
    m.check_dispatch()              # drained
    assert m.n_dispatch_faults_raised == 2
    assert issubclass(TransientDispatchError, RuntimeError)


# --------------------------------------------------------------------------
# Self-healing service integration
# --------------------------------------------------------------------------
def _retry_once(pkg):
    db = pkg.db()
    fm = pkg.faults.FaultManager(db)
    q6 = pkg.queries.get_query("Q6").filter_only()
    expect = db.run_baseline(q6).aggregates

    async def run():
        svc = pkg.serve.QueryService(db, max_wait_s=0.001, fault_manager=fm)
        async with svc:
            fm.model.inject_dispatch_faults(1)
            r = await svc.submit(q6)
        return r, svc

    r, svc = _run(run())
    assert r.aggregates == expect
    return (svc.n_transient_faults, svc.n_retries, svc.n_fault_recovered,
            svc.n_errors, svc.n_dispatches, fm.breaker.state)


def test_service_retries_transient_dispatch_fault():
    got = _retry_once(_port())
    assert got == (1, 1, 1, 0, 1, "closed")
    assert got == _retry_once(_ref())


def _degrade_and_recover(pkg):
    db = pkg.db()
    fm = pkg.faults.FaultManager(
        db, retry=pkg.faults.RetryPolicy(max_retries=1, base_delay_s=0.0),
        breaker=pkg.faults.CircuitBreaker(failure_threshold=1,
                                          cooldown_windows=2))
    q6 = pkg.queries.get_query("Q6").filter_only()
    q1 = pkg.queries.get_query("Q1").filter_only()
    expect6 = db.run_baseline(q6).aggregates
    expect1 = db.run_baseline(q1).aggregates

    async def run():
        svc = pkg.serve.QueryService(db, max_wait_s=0.001, fault_manager=fm)
        async with svc:
            # Exhaust retries (2 attempts) -> degrade + trip breaker.
            fm.model.inject_dispatch_faults(2)
            r6 = await svc.submit(q6)
            # Breaker open: next window degrades without trying FUSED.
            r1 = await svc.submit(q1)
            # Cooldown elapsed: half-open probe succeeds, breaker closes.
            take = {a: np.asarray(c[:1])
                    for a, c in db.tables["lineitem"].items()}
            await svc.apply([pkg.dml.Insert("lineitem", take)])
            r6b = await svc.submit(q6)
        return r6, r1, r6b, svc

    r6, r1, r6b, svc = _run(run())
    assert r6.aggregates == expect6          # degraded, still correct
    assert r1.aggregates == expect1
    assert r6.engine.value == r1.engine.value == "eager"
    assert r6b.engine.value == "fused"
    stats = svc.stats()
    return {"errors": svc.n_errors, "degraded": svc.n_degraded_windows,
            "recovered": svc.n_fault_recovered,
            "transient": svc.n_transient_faults, "retries": svc.n_retries,
            "dispatches": svc.n_dispatches, "breaker": stats["breaker"],
            "r6b": r6b.aggregates}


def test_service_degrades_to_eager_and_recovers():
    got = _degrade_and_recover(_port())
    assert got["errors"] == 0
    assert got["degraded"] == 2 and got["recovered"] == 2
    assert got["breaker"] == {"state": "closed", "trips": 1,
                              "recoveries": 1}
    assert got == _degrade_and_recover(_ref())


# --------------------------------------------------------------------------
# The chaos soak
# --------------------------------------------------------------------------
def _soak_report(rep):
    return {k: v for k, v in rep.items() if k not in ("wall_s", "qps")}


def test_chaos_soak_smoke():
    """One short seeded chaos soak end to end: every injected fault
    detected, parity + availability held, breaker recovered — and the
    whole report (but its wall and qps) equal to the reference's."""
    logs = []
    rep = chaos.run_chaos(sf=0.001, rounds=6, batch=16, seed=7,
                          device="cpu", on_manager=logs.append)
    assert rep["ok"], rep["violations"]
    assert rep["all_detected"]
    assert rep["parity"]
    assert rep["detected_injected"] == rep["injected"] == 4
    assert rep["breaker_state"] == "closed"
    assert rep["breaker_trips"] == 1
    assert rep["recovered_queries"] > 0
    assert rep["remapped_rows"] > 0
    assert eng._WRITE_FAULT_HOOK is None
    fm, = logs
    assert len(fm.scrub_log) == rep["scrubs"] == 6
    # On the CPU nothing is copied off a device.
    assert all(b == 0 for _, b in fm.scrub_log)
    r = _ref()
    want = r.chaos.run_chaos(sf=0.001, rounds=6, batch=16, seed=7)
    assert set(rep) == set(want)
    assert _soak_report(rep) == _soak_report(want)


def test_chaos_counters_match_baseline_keys():
    """The report carries every ``chaos_soak`` counter of
    ``benchmarks/baseline.json`` under the names its bench row reads."""
    meta = json.loads((ROOT / "benchmarks/baseline.json").read_text())[
        "rows"]["chaos_soak"]["meta"]
    rep = chaos.run_chaos(sf=0.001, rounds=1, batch=16, device="cpu")
    names = {"detected": "detected_injected"}
    for key in ("injected", "detected", "detect_latency_rounds",
                "write_faults", "worn_dead", "repaired_rows",
                "remapped_rows", "dispatches", "transient_faults",
                "retries", "degraded_windows", "recovered_queries",
                "breaker_trips", "breaker_recoveries"):
        assert key in meta
        assert names.get(key, key) in rep


def test_chaos_cli_exit_codes(capsys):
    """A clean control run exits 0; two faulted rounds leave the fault
    injected after round 1 for a scrub that never comes: exit 1, with the
    violation printed."""
    assert chaos.main(["--sf", "0.001", "--rounds", "2", "--device", "cpu",
                       "--no-inject"]) == 0
    out = capsys.readouterr().out
    assert "ok: True" in out and "injected: 0" in out
    assert chaos.main(["--sf", "0.001", "--rounds", "2", "--device",
                       "cpu"]) == 1
    out = capsys.readouterr().out
    assert "ok: False" in out and "undetected faults" in out


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "false")


@pytest.mark.cuda
def test_dead_row_remap_on_card_matches_cpu():
    """Endurance death -> remap with lineitem on the card: the same report,
    slot map and Q6 as on the CPU, the same words, planes still on the
    card, and the verify-after-write read back only the written words."""
    _needs_card()
    before = guard.readback_bytes
    db, got = _dead_row_remap(_port("cuda"))
    assert all(p.is_cuda for p in db.relations["lineitem"].planes.values())
    cpu, want = _dead_row_remap(_port("cpu"))
    assert got == want
    _same_relation(db, cpu, "lineitem")
    assert guard.readback_bytes > before


@pytest.mark.cuda
def test_chaos_round_on_card_matches_cpu():
    """One chaos round on the card: the report of the CPU's run."""
    _needs_card()
    got = chaos.run_chaos(sf=0.001, rounds=1, batch=16, device="cuda")
    want = chaos.run_chaos(sf=0.001, rounds=1, batch=16, device="cpu")
    assert got["ok"], got["violations"]
    assert _soak_report(got) == _soak_report(want)
