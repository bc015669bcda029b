"""Port: the examples (``repro_torch.examples``), held against the
reference's.

``quickstart.main`` on the CPU gives the revenue, count, stateful-logic
cycles and host-read bytes the reference's ``examples/quickstart.py``
computes, here recomputed in-process through ``repro.core.engine`` and
``repro.core.cost_model`` on the same seed-0 data.
``tpch_analytics.main(["--sf", "0.002", "--device", "cpu"])`` verifies
every row it prints (all 19 queries against ORACLE, Q3 end to end, the
linked batch, the served stream, the HTAP round), and its cost rows for
Q1, Q6 and Q14 equal the reference's ``database.cost_report`` at that SF.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.examples import quickstart, tpch_analytics

SF = 0.002


def _reference_quickstart():
    """The reference quickstart's numbers on its own engine."""
    from repro.core import cost_model, engine
    from repro.db.compiler import Agg, And, Between, Cmp, Col, Compiler, Lit
    orders = quickstart.make_orders()
    rel = engine.PimRelation.from_columns("orders", orders)
    c = Compiler(rel)
    mask = c.compile_filter(And(Cmp("eq", Col("status"), Lit(2)),
                                Between(Col("day"), 90, 179)),
                            with_transform=False)
    regs = c.compile_aggregates(mask, [Agg("sum", Col("amount"), "revenue"),
                                       Agg("count", None, "n")])
    eng = engine.Engine(rel)
    eng.run(c.program)
    return {"revenue": int(eng.read_scalar(regs["revenue"][1])),
            "n": int(eng.read_scalar(regs["n"][1])),
            "cycles": cost_model.classify_program(eng.trace).cycles_total,
            "scan_bytes": quickstart.N * (16 + 2 + 9) // 8,
            "pim_bytes": cost_model.pim_read_bytes_aggregate(
                rel.layout.n_crossbars, 2)}


def test_quickstart_matches_reference(capsys):
    pytest.importorskip("jax")
    got = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "matches numpy ✓" in out
    assert got == _reference_quickstart()
    orders = quickstart.make_orders()
    sel = ((orders["status"] == 2) & (orders["day"] >= 90)
           & (orders["day"] <= 179))
    assert (got["revenue"], got["n"]) == (int(orders["amount"][sel].sum()),
                                          int(sel.sum()))


@pytest.fixture(scope="module")
def analytics():
    return tpch_analytics.main(["--sf", str(SF), "--device", "cpu"])


def test_tpch_analytics_verifies_every_row(analytics):
    assert analytics["ok"]
    assert len(analytics["rows"]) == 19
    assert all(ok for _, ok in analytics["rows"])
    assert analytics["e2e"]["ok"] and analytics["e2e"]["rows"]
    assert analytics["batch"]["n_dispatches"] == 2
    assert all(ok for _, ok in analytics["batch"]["ok"])
    assert analytics["serve"]["ok"] and analytics["serve"]["errors"] == 0
    assert analytics["htap"]["ok"]
    assert analytics["htap"]["busiest"] <= analytics["htap"]["unleveled"]


def test_tpch_analytics_cost_rows_match_reference(analytics):
    pytest.importorskip("jax")
    from repro.db import database as rdb
    from repro.db import queries as rq
    from repro.db import tpch as rtpch
    db = rdb.PimDatabase(rtpch.generate(sf=SF, seed=42))
    for name in ("Q1", "Q6", "Q14"):
        run = db.execute(rq.get_query(name).filter_only())
        want = dataclasses.asdict(rdb.cost_report(run, sf_scale=1000 / SF))
        got = dataclasses.asdict(analytics["reports"][name])
        assert {k: got[k] for k in want} == want, name
        assert np.isfinite(got["speedup"]) and got["cycles"]["total"] > 0
