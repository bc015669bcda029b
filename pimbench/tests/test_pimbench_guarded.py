"""The guarded deployment (``deployments/tpch_guarded.py``) of the cell
``sf1-filter-faults``, at sf 0.002 on the CPU in a short window: the cell
is correct with every fault found and repaired, a strike left unscrubbed
fails both its own checks and a base check, each of the four checks
counts what it should on a hand-made plan and report, an outage trips the
program's breaker once whatever its settings, and a program whose
``QueryService.scrub`` takes no ``inject`` cannot load it."""
import numpy as np
import pytest

from pimbench import harness, run as run_py
from pimbench.deployments import tpch_guarded as G
from pimbench.tests import _small

CELL = "sf1-filter-faults"
SECONDS = 2.0


def _cell(only=None, sf=_small.SF):
    """The cell at ``sf``, its rounds in a window of ``SECONDS``, and
    arrivals at 40 queries/s (so every round's dispatch faults meet
    windows)."""
    _, cell, config, traffic = _small.cell(CELL, sf=sf)
    traffic = dict(traffic, rate_qps=40.0)
    if only is not None:
        traffic = dict(traffic, templates=[
            t for t in traffic["templates"] if t["query"] in only])
    return cell, config, traffic


def _run(only=None):
    cell, config, traffic = _cell(only)
    return harness.run_cell(cell, config, traffic, _small.SEED, SECONDS,
                            False, device="cpu")


def test_the_cell_is_correct_and_every_fault_is_repaired():
    run, checks, attempted, failed, _ = _run()
    assert attempted > 0 and failed == 0
    assert set(checks) >= {"faults_undetected", "faults_false_alarms",
                           "faults_misclassified", "guarded_rows_wrong"}
    assert not any(checks.values()), checks
    assert run_py.is_correct(checks, failed, run_py.limits_of(run))
    rounds = run.deployment["rounds"]
    assert rounds[0]["warmup"]
    assert len(rounds) == 1 + config_rounds()
    planned = {(rel, a, s) for r in rounds for rel, a, s, _ in G._planned(r)}
    reported = {(rel, a, s) for r in rounds
                for rel, x in r["report"].items() for a, s in x["corrupt"]}
    assert planned == reported and len(planned) == 6 * len(rounds)
    assert sum(r["trips"] for r in rounds[1:]) >= 1
    assert sum(r["recoveries"] for r in rounds[1:]) >= 1
    assert "live" not in run.deployment


def config_rounds():
    return _small.cell(CELL)[2]["faults"]["rounds"]


def _shipdate_flips(tables, monkeypatch):
    """Every round's first flip lands in the top plane of ``l_shipdate``
    (which Q1 reads), on a row a flip there moves past Q1's cut-off; a
    new row each round, so no flip undoes another."""
    ship = tables["lineitem"]["l_shipdate"]
    rows = np.flatnonzero((ship >= 600) & (ship < 2048))
    inner = G.plan_round

    def plan_round(layout, plan, seed, k, retired):
        p = inner(layout, plan, seed, k, retired)
        top = layout["lineitem"]["attrs"]["l_shipdate"] - 1
        p["flips"][0] = ["lineitem", "l_shipdate", int(rows[k]), top]
        return p
    monkeypatch.setattr(G, "plan_round", plan_round)


def test_a_strike_without_its_scrub_fails_its_checks_and_a_base_check(
        monkeypatch):
    from repro_torch.serve import QueryService

    async def strike_only(self, inject=None):
        """Injects, as the scrub's job would, and repairs nothing."""
        loop = self._bind_loop()
        self.batcher.flush_now()
        await loop.run_in_executor(self._dispatch_pool, inject)
        return {}

    monkeypatch.setattr(QueryService, "scrub", strike_only)
    _shipdate_flips(_small.tables(), monkeypatch)
    run, checks, attempted, failed, _ = _run(only=("Q1", "Q6"))
    assert attempted > 0
    assert checks["faults_undetected"] > 0
    assert checks["guarded_rows_wrong"] > 0
    assert checks["mask_bits_wrong"] + checks["agg_wrong"] > 0, checks
    assert not run_py.is_correct(checks, failed, run_py.limits_of(run))


def _round(flips=(), ghosts=(), stuck=(), report=None):
    return {"k": 1, "warmup": False,
            "plan": {"flips": [list(f) for f in flips],
                     "ghosts": [list(g) for g in ghosts],
                     "stuck": [list(s) for s in stuck],
                     "dispatch_faults": 6},
            "report": report or {}}


FLIP = ("orders", "o_totalprice", 17, 3)
GHOST = ("lineitem", G.VALID, 40_001)
STUCK = ("lineitem", "l_tax", 40_002, 1)
GOOD = {"orders": {"corrupt": [["o_totalprice", 17]], "soft": [17],
                   "hard": []},
        "lineitem": {"corrupt": [[G.VALID, 40_001], ["l_tax", 40_002]],
                     "soft": [40_001], "hard": [40_002]}}


def _with(rel, **changes):
    return {**GOOD, rel: {**GOOD[rel], **changes}}


@pytest.mark.parametrize("report,expect", [
    (GOOD, {}),
    (_with("orders", corrupt=[], soft=[]), {"faults_undetected": 1}),
    (_with("orders", corrupt=[["o_totalprice", 17], ["o_custkey", 9]],
           soft=[9, 17]), {"faults_false_alarms": 1}),
    (_with("lineitem", soft=[40_001, 40_002], hard=[]),
     {"faults_misclassified": 1}),
], ids=["repaired", "missed", "false_alarm", "misclassified"])
def test_the_fault_checks_on_a_hand_made_plan_and_report(report, expect):
    got = G.fault_checks([_round([FLIP], [GHOST], [STUCK], report)])
    want = {"faults_undetected": 0, "faults_false_alarms": 0,
            "faults_misclassified": 0, **expect}
    assert got == want


def test_a_round_without_its_report_counts_its_faults_undetected():
    """A strike whose scrub report never came back counts every fault it
    planned; a round whose job never ran injected nothing."""
    rec = _round([FLIP], [GHOST], [STUCK])
    del rec["report"]
    assert G.fault_checks([rec])["faults_undetected"] == 3
    del rec["plan"]
    assert G.fault_checks([rec])["faults_undetected"] == 0


@pytest.mark.parametrize("alter,wrong", [
    (lambda cols, valid: None, 0),
    (lambda cols, valid: cols["a"].__setitem__(2, 99), 1),
    (lambda cols, valid: valid.__setitem__(1, False), 1),
    (lambda cols, valid: valid.__setitem__(6, True), 1),
], ids=["stored", "altered", "valid_cleared", "ghost_valid"])
def test_rows_wrong_counts_each_altered_row_and_ghost(alter, wrong):
    gen = {"a": np.arange(5), "b": np.arange(5) * 3}
    cols = {a: v.copy() for a, v in gen.items()}
    valid = np.zeros(8, bool)
    valid[:5] = True
    alter(cols, valid)
    assert G.rows_wrong(gen, cols, valid) == wrong


def test_plan_keeps_hard_faults_off_live_rows_and_retired_slots():
    layout = {"lineitem": {"n_rows": 100, "words": 4, "capacity": 128,
                           "attrs": {"l_tax": 4, "l_quantity": 6}},
              "orders": {"n_rows": 10, "words": 1, "capacity": 32,
                         "attrs": {"o_totalprice": 20}}}
    plan = {"guarded": ["lineitem", "orders"], "cell_flips": 4,
            "ghost_valid_flips": 1, "stuck_cells": 1, "dispatch_outages": 1}
    retired = set()
    for k in range(20):
        p = G.plan_round(layout, plan, 2 ** 31 + 5, k, retired)
        assert p == G.plan_round(layout, plan, 2 ** 31 + 5, k, retired)
        cells = {(rel, a, s) for rel, a, s, _ in p["flips"]}
        assert len(cells) == 4
        for rel, a, s, plane in p["flips"]:
            assert s < layout[rel]["n_rows"]
            assert plane < layout[rel]["attrs"][a]
        (ghost,), (stuck,) = p["ghosts"], p["stuck"]
        assert 100 <= ghost[2] < 128 and 100 <= stuck[2] < 128
        assert ghost[2] != stuck[2]
        assert ghost[2] not in retired and stuck[2] not in retired
        retired.add(stuck[2])


@pytest.mark.parametrize("retries,threshold,cooldown",
                         [(2, 2, 2), (1, 3, 1), (0, 1, 3)])
def test_an_outage_trips_the_breaker_once_whatever_its_settings(
        retries, threshold, cooldown):
    """``outage_faults`` follows the ``FaultManager``'s retry policy and
    breaker: that many queued dispatch faults, met by windows one query
    each, trip the breaker once, and it closes again."""
    import asyncio

    from repro_torch.faults import (CircuitBreaker, DeviceFaultModel,
                                    FaultManager, RetryPolicy)
    from repro_torch.serve import QueryService

    from pimbench import adapter, templates
    from pimbench.deployments import tpch

    _, _, config, _ = _small.cell(CELL)
    db = tpch.load(_small.tables(), config, "cpu")
    fm = FaultManager(db, model=DeviceFaultModel(seed=3),
                      retry=RetryPolicy(max_retries=retries,
                                        base_delay_s=0.0),
                      breaker=CircuitBreaker(failure_threshold=threshold,
                                             cooldown_windows=cooldown))
    n = G.outage_faults(fm)
    assert n == (retries + 1) * threshold
    fm.model.inject_dispatch_faults(n)
    q6 = templates.load_template("Q6")
    rng = np.random.default_rng(5)

    async def drive():
        async with QueryService(db, fault_manager=fm) as svc:
            for _ in range(4 * n + 4 * cooldown):
                if fm.model.dispatch_faults_queued == 0 \
                        and fm.breaker.state == "closed":
                    break
                q = templates.bind(q6, "pim", templates.draw_params(q6, rng))
                await svc.submit(adapter.query_spec(q))
            return svc.n_transient_faults
    assert asyncio.run(drive()) == n
    assert fm.model.dispatch_faults_queued == 0
    assert fm.breaker.state == "closed"
    assert (fm.breaker.n_trips, fm.breaker.n_recoveries) == (1, 1)


def test_a_program_without_scrub_inject_cannot_load_it(monkeypatch):
    from repro_torch.serve import QueryService

    async def scrub(self):
        return {}
    monkeypatch.setattr(QueryService, "scrub", scrub)
    _, _, config, _ = _small.cell(CELL)
    with pytest.raises(RuntimeError, match="inject"):
        G.load(G.generate(config, 7), config, "cpu")


@pytest.mark.cuda
def test_a_short_traced_run_on_the_card_is_correct_and_spanned(card):
    cell, config, traffic = _cell(sf=0.01)
    run, checks, attempted, failed, dev = harness.run_cell(
        cell, config, traffic, _small.SEED, SECONDS, True, device=card)
    assert attempted > 0 and failed == 0 and not any(checks.values()), checks
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    bench, *_ = _small.cell(CELL)
    metrics = harness.read_metrics(run, run_py.cell_metrics(bench, cell, True))
    assert set(metrics) == {"scrub_ms", "repair_ms", "scrub_readback_bytes",
                            "eager_window_ms", "recover_ms",
                            "p95_ms.sf1-filter-faults"}
    assert metrics["scrub_readback_bytes"]["value"] > 0
