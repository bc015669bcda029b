"""Port: end-to-end TPC-H queries — the PIM filter and ``Materialize``,
then the numpy host stage (joins, residual predicates, group-by,
order/limit).

For the six specs with a host stage, the port's FUSED ``execute`` (the
kernels' plain versions on the CPU) gives the same result rows as the JAX
package's ``PimDatabase.execute`` and as the port's ORACLE, exactly, with
the same materialized record counts and plane-read counters. The counts
of ``benchmarks/baseline.json`` (``q3_e2e``, ``q14_e2e``: TPC-H sf 0.005,
seed 0) are pinned.
"""
import pytest

from repro_torch.db import database as tdb
from repro_torch.db import queries as tq
from repro_torch.db import tpch as ttpch

SF, SEED = 0.005, 0
HOST_SPECS = ["Q3", "Q5", "Q10", "Q12", "Q14", "Q19"]


@pytest.fixture(scope="module")
def tables():
    return ttpch.generate(sf=SF, seed=SEED)


@pytest.fixture(scope="module")
def port_db(tables):
    return tdb.PimDatabase(tables, device="cpu")


@pytest.fixture(scope="module")
def ref_db(tables):
    pytest.importorskip("jax")
    from repro.db import database as rdb
    return rdb.PimDatabase(tables)


def test_host_specs_are_the_six():
    assert [q.name for q in tq.all_queries() if q.host is not None] == \
        HOST_SPECS


@pytest.mark.parametrize("qname", HOST_SPECS)
def test_end_to_end_matches_reference_and_oracle(port_db, ref_db, qname):
    from repro.db import queries as rq
    spec = tq.get_query(qname)
    fused = port_db.execute(spec)
    oracle = port_db.execute(spec, engine=tdb.Engine.ORACLE)
    ref = ref_db.execute(rq.get_query(qname))
    assert fused.engine is tdb.Engine.FUSED
    assert fused.columns == oracle.columns == tuple(ref.columns)
    assert fused.rows, qname
    assert fused.rows == oracle.rows == ref.rows
    assert fused.materialized_rows == oracle.materialized_rows == \
        ref.materialized_rows
    assert fused.total_materialized == ref.total_materialized
    assert fused.wall_s == fused.pim_s + fused.host_s
    stats = fused.batch_stats
    assert stats is port_db.last_batch_stats
    assert stats["n_dispatches"] == len(fused.materialized_rows)
    for rel, st in stats["relations"].items():
        assert st["plane_reads"] == \
            ref.batch_stats["relations"][rel]["plane_reads"]


def test_decoded_rows_match_reference(port_db, ref_db):
    from repro.db import queries as rq
    got = port_db.execute(tq.get_query("Q3")).decoded_rows()
    assert got == ref_db.execute(rq.get_query("Q3")).decoded_rows()
    assert len(got) == 10 and all(len(r) == 4 for r in got)


@pytest.mark.parametrize("qname,materialized,result_rows",
                         [("Q3", 20_027, 10), ("Q14", 1_409, 1)])
def test_baseline_counts(port_db, qname, materialized, result_rows):
    res = port_db.execute(tq.get_query(qname))
    assert res.total_materialized == materialized
    assert len(res.rows) == result_rows
