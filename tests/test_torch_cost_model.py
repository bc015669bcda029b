"""Port: the paper's analytical cost model (``core.cost_model``), the cost
report of a query (``db.database.cost_report``, ``PimDatabase.report``)
and the arithmetic lowering census it reads (``ArithPlan.steps``).

* The cases of ``tests/test_cost_model.py`` hold for the port's copy.
* ``cost_report`` at paper scale (``sf_scale = 1000 / SF``) of the 19
  TPC-H specs, on FUSED and on EAGER, equals the reference's field by
  field. The floats compare exactly: both sides run the same Python float
  arithmetic on equal inputs.
* ``ArithPlan.steps`` and ``classify_lowering`` of it equal the
  reference's on all 34 relation programs (the port once dropped
  ``steps``).
"""
import dataclasses

import pytest

from repro_torch.core import cost_model as cm
from repro_torch.core import isa
from repro_torch.core import program as tprog
from repro_torch.db import cost_report
from repro_torch.db import database as tdb
from repro_torch.db import queries as tq
from repro_torch.db import tpch as ttpch

SF, SEED = 0.005, 0
SF_SCALE = 1000 / SF


# --------------------------------------------------------------------------
# The reference's cost-model cases, on the port's copy
# --------------------------------------------------------------------------
def test_table4_cycle_formulas():
    assert isa.EqualImm(dest="", attr="a", imm=0b1011, n_bits=4).cycles() \
        == 1 + 3 * 3 + 1          # imm0=1, imm1=3
    assert isa.NotEqualImm(dest="", attr="a", imm=0, n_bits=5).cycles() \
        == 5 + 0 + 3
    assert isa.LessThanImm(dest="", attr="a", imm=0b11,
                           n_bits=4).cycles() == 11 * 2 + 3 * 2 + 4
    assert isa.GreaterThanImm(dest="", attr="a", imm=0b1111,
                              n_bits=4).cycles() == 0 + 3 * 4 + 2
    assert isa.AddImm(dest="", attr="a", imm=1, n_bits=8).cycles() \
        == 18 * 8 + 3
    assert isa.Equal(dest="", attr_a="a", attr_b="b", n_bits=12).cycles() \
        == 11 * 12 + 3
    assert isa.LessThan(dest="", attr_a="a", attr_b="b",
                        n_bits=7).cycles() == 16 * 7 + 2
    assert isa.Add(dest="", attr_a="a", attr_b="b", n_bits=16).cycles() \
        == 18 * 16 + 1
    assert isa.Multiply(dest="", attr_a="a", attr_b="b",
                        n_bits=8, m_bits=4).cycles() \
        == 24 * 8 * 4 - 19 * 8 + 2 * 4 - 1
    assert isa.ReduceSum(dest="", attr="a", mask="m", n_bits=10).cycles() \
        == 2254 * 10 + 3006
    assert isa.ReduceMinMax(dest="", attr="a", mask="m",
                            n_bits=10).cycles() == 2306 * 10 + 200
    assert isa.ColumnTransform(dest="", mask="m").cycles() == 2050
    assert isa.SetReset(dest="", value=1, n_bits=3).cycles() == 3
    assert isa.BitwiseAnd(dest="", src_a="a", src_b="b",
                          n_bits=1).cycles() == 6
    assert isa.BitwiseOr(dest="", src_a="a", src_b="b", n_bits=1).cycles() \
        == 4
    assert isa.BitwiseNot(dest="", src="a", n_bits=1).cycles() == 2


def test_intermediate_cells_match_table4():
    assert isa.LessThanImm(dest="", attr="a", imm=1,
                           n_bits=4).intermediate_cells() == 5
    assert isa.ReduceSum(dest="", attr="a", mask="m",
                         n_bits=10).intermediate_cells() == 25
    assert isa.ReduceMinMax(dest="", attr="a", mask="m",
                            n_bits=10).intermediate_cells() == 17


def test_program_classification():
    prog = [isa.EqualImm(dest="m", attr="a", imm=3, n_bits=4),
            isa.ReduceSum(dest="s", attr="b", mask="m", n_bits=8),
            isa.ColumnTransform(dest="c", mask="m")]
    cost = cm.classify_program(prog)
    assert cost.cycles_filter > 0
    assert cost.cycles_reduce_row > 0 and cost.cycles_reduce_col > 0
    assert cost.cycles_col_transform == 2050
    assert cost.cycles_total == sum(cost.breakdown().values())


def test_timing_read_reduction_drives_speedup():
    cost = cm.ProgramCost(cycles_filter=500)
    n = 10_000_000
    base_bytes = n * 4                       # 32-bit attribute scan
    pim_bytes = cm.pim_read_bytes_filter(n)  # 1 bit per record
    t = cm.query_timing(cost, n, n // 1024, base_bytes, pim_bytes)
    assert t.read_reduction == pytest.approx(32.0, rel=0.01)
    assert t.speedup > 1.0


def test_energy_and_endurance_positive():
    cost = cm.ProgramCost(cycles_filter=500, cycles_reduce_col=2000,
                          cycles_reduce_row=20000)
    t = cm.query_timing(cost, 10**7, 10**4, 10**7, 10**5)
    e = cm.query_energy(cost, t, 10**4)
    assert e.pimdb_total_j > 0 and e.baseline_j > 0
    end = cm.endurance_ops_per_cell(cost, exec_time_s=t.pimdb_total_s)
    assert 0 < end < 1e14


def test_baseline_cacheline_model():
    full = cm.baseline_scan_bytes(10**6, [32, 32], [1.0, 1.0])
    sel = cm.baseline_scan_bytes(10**6, [32, 32], [0.001, 1.0])
    assert sel < full
    assert sel >= 10**6 * 4        # first column always fully scanned


def test_classify_lowering_rejects_unknown_kinds():
    got = cm.classify_lowering((("csa_compress", 3), ("carry_propagate", 40),
                                ("copy_through", 1)))
    assert (got.csa_compressions, got.carry_propagate_bits,
            got.copy_throughs, got.paper_cycles) == (3, 40, 1, 0)
    with pytest.raises(ValueError, match="unknown lowering kind"):
        cm.classify_lowering((("wallace", 1),))


# --------------------------------------------------------------------------
# Against the reference, at paper scale
# --------------------------------------------------------------------------
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


@pytest.mark.parametrize("qname", [q.name for q in tq.all_queries()])
def test_cost_report_matches_reference(port_db, ref_db, qname):
    from repro.db import database as rdb
    from repro.db import queries as rq
    spec = tq.get_query(qname).filter_only()
    ref_run = ref_db.execute(rq.get_query(qname).filter_only(),
                             engine="eager")
    want = dataclasses.asdict(ref_db.report(ref_run, sf_scale=SF_SCALE))
    assert want == dataclasses.asdict(rdb.cost_report(
        ref_run, SF_SCALE, relations=ref_db.relations))
    for engine in (tdb.Engine.FUSED, tdb.Engine.EAGER):
        run = port_db.execute(spec, engine=engine)
        got = port_db.report(run, sf_scale=SF_SCALE)
        assert dataclasses.asdict(got) == want, engine
        assert dataclasses.asdict(cost_report(
            run, SF_SCALE, relations=port_db.relations)) == want
        assert got.row() == ref_db.report(ref_run, SF_SCALE).row()
    assert want["bytes_resident"] > 0 and want["cycles"]["total"] > 0


def test_arith_steps_match_reference(port_db, ref_db):
    from repro.core import cost_model as rcm
    from repro.core import program as rprog
    from repro.db import queries as rq
    n = 0
    seen = set()
    for spec, rspec in zip(tq.all_queries(), rq.all_queries()):
        s, rs = spec.filter_only(), rspec.filter_only()
        for rel_name, pred in s.filters.items():
            c, m, _ = port_db._compile_relation(port_db.relations[rel_name],
                                                s, pred)
            rc, rm, _ = ref_db._compile_relation(
                ref_db.relations[rel_name], rs, rs.filters[rel_name])
            cp = tprog.compile_program(port_db.relations[rel_name],
                                       c.program, mask_outputs=(m,))
            rcp = rprog.compile_program(ref_db.relations[rel_name],
                                        rc.program, mask_outputs=(rm,))
            assert cp.arith.steps == rcp.arith.steps, (s.name, rel_name)
            assert dataclasses.asdict(cm.classify_lowering(cp.arith.steps)) \
                == dataclasses.asdict(rcm.classify_lowering(rcp.arith.steps))
            seen.add(cp.arith.steps)
            n += 1
    assert n == 34
    assert any(dict(st)["csa_compress"] for st in seen)   # Q1's multiplies
