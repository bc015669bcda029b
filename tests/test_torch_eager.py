"""Port: the eager engine (``core.engine.Engine``, ``Engine.EAGER``) and
its word primitives, against the reference, bit for bit (tolerance 0).

* The primitives (popcount totals, masked per-bit popcounts, exact SUM,
  MIN/MAX narrowing with the empty-mask flag, ripple multiplies) equal
  ``repro.core.engine``'s at the shapes of ``tests/test_engine.py``.
* The port's ``Engine`` run over the 34 relation programs of the 19
  TPC-H specs and the 16 ``Materialize`` programs of the six host-stage
  specs (sf 0.005, seed 0) equals the reference's ``Engine(backend=
  "jnp")``: trace, masks, derived attributes and reduces, found flags and
  materialized values.
* ``PimDatabase(device="cpu").execute(spec, engine="eager")`` equals the
  reference's EAGER and the port's FUSED and ORACLE.
* Its immediate predicates go through ``kernels.ops``; DML raises.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import bitslice as tb
from repro_torch.core import engine as te
from repro_torch.core import isa as tisa
from repro_torch.db import database as tdb
from repro_torch.db import queries as tq
from repro_torch.db import tpch as ttpch
from repro_torch.db.compiler import Compiler
from repro_torch.kernels import ops as tops

SF, SEED = 0.005, 0
HOST_SPECS = ("Q3", "Q5", "Q10", "Q12", "Q14", "Q19")


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


def _words(t):
    return te.to_words(t)


# --------------------------------------------------------------------------
# Word primitives
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n,width,density", [(1, 1, 1.0), (1500, 14, 0.3),
                                             (3000, 24, 0.0),
                                             (33_000, 33, 0.7)])
def test_reduce_primitives_match_reference(n, width, density):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import engine as reng
    rng = np.random.default_rng(n + width)
    vals = rng.integers(0, 1 << width, n, dtype=np.uint64)
    planes_np = tb.pack_bits(vals, width)
    sel = rng.random(n) < density
    mask_np = tb.pack_mask(sel, planes_np.shape[1])
    p, m = te.to_planes(planes_np, "cpu"), te.to_planes(mask_np, "cpu")
    jp, jm = jnp.asarray(planes_np), jnp.asarray(mask_np)
    assert int(te.popcount_total(m)) == int(reng.popcount_total(jm)) \
        == int(sel.sum())
    assert int(te.reduce_count(m)) == int(reng.reduce_count(jm))
    np.testing.assert_array_equal(te.reduce_sum_bits(p, m).numpy(),
                                  np.asarray(reng.reduce_sum_bits(jp, jm)))
    assert te.reduce_sum(p, m) == reng.reduce_sum(jp, jm) \
        == int(vals[sel].sum())
    for fn, want in (("reduce_min", vals[sel].min() if sel.any() else None),
                     ("reduce_max", vals[sel].max() if sel.any() else None)):
        got = getattr(te, fn)(p, m)
        assert got == getattr(reng, fn)(jp, jm)
        assert got[1] is bool(sel.any())
        if want is not None:
            assert got[0] == int(want)
    if not sel.any():    # the reference's exact empty values
        assert te.reduce_min(p, m) == ((1 << width) - 1, False)
        assert te.reduce_max(p, m) == (0, False)


@pytest.mark.parametrize("n,wa,wb", [(1, 1, 1), (800, 10, 6),
                                     (33_000, 17, 5)])
def test_ripple_multiplies_match_reference(n, wa, wb):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import engine as reng
    rng = np.random.default_rng(n * wa + wb)
    va = rng.integers(0, 1 << wa, n)
    vb = rng.integers(0, 1 << wb, n)
    pa_np, pb_np = tb.pack_bits(va, wa), tb.pack_bits(vb, wb)
    pa, pb = te.to_planes(pa_np, "cpu"), te.to_planes(pb_np, "cpu")
    ja, jb = jnp.asarray(pa_np), jnp.asarray(pb_np)
    out = wa + wb
    prod = te.mul_planes(pa, pb, out)
    np.testing.assert_array_equal(_words(prod),
                                  np.asarray(reng.mul_planes(ja, jb, out)))
    np.testing.assert_array_equal(tb.unpack_bits(_words(prod), n), va * vb)
    for imm in (0, 1, int(rng.integers(1, 1 << wb)), (1 << wb) - 1):
        np.testing.assert_array_equal(
            _words(te.mul_imm_planes(pa, imm, out)),
            np.asarray(reng.mul_imm_planes(ja, imm, out)))
    for k in (0, 1, 3):
        pps = te.mul_partial_products(pa, pb, None, out)[:k]
        jpps = reng.mul_partial_products(ja, jb, None, out)[:k]
        np.testing.assert_array_equal(
            _words(te._ripple_accumulate(pps, out, pa[0])),
            np.asarray(reng._ripple_accumulate(jpps, out, ja.shape[1:])))


# --------------------------------------------------------------------------
# The Engine over every relation program
# --------------------------------------------------------------------------
def _programs(db, Q, C, E):
    """(label, relation, instructions) for the filter_only() programs of
    all specs and the Materialize programs of the host-stage specs, built
    with the queries, compiler and exec modules ``Q``, ``C``, ``E``."""
    out = []
    for spec in Q.all_queries():
        s = spec.filter_only()
        for rel_name, pred in s.filters.items():
            c, _, _ = db._compile_relation(db.relations[rel_name], s, pred)
            out.append((f"{s.name}/{rel_name}", rel_name, list(c.program)))
    for name in HOST_SPECS:
        for rel_name, pred, cols in E.split_query(Q.get_query(name))[0]:
            c = C.Compiler(db.relations[rel_name])
            m = (c.compile_filter(pred, with_transform=False)
                 if pred is not None else c.compile_scan_all())
            c.compile_materialize(m, cols)
            out.append((f"{name}_e2e/{rel_name}", rel_name, list(c.program)))
    return out


def _fields(ins):
    return (ins.kind, dataclasses.astuple(ins))


def test_engine_matches_reference_on_every_program(port_db, ref_db):
    from repro.core import engine as reng
    from repro.db import compiler as rc
    from repro.db import exec as rexec
    from repro.db import queries as rq
    from repro_torch.db import compiler as tc
    from repro_torch.db import exec as texec
    mine = _programs(port_db, tq, tc, texec)
    theirs = _programs(ref_db, rq, rc, rexec)
    assert len(mine) == len(theirs) == 34 + 16
    n_materialized = 0
    for (label, rel_name, prog), (_, _, rprog) in zip(mine, theirs):
        e = te.Engine(port_db.relations[rel_name])
        e.run(prog)
        r = reng.Engine(ref_db.relations[rel_name], backend="jnp")
        r.run(rprog)
        assert [_fields(i) for i in e.trace] == \
            [_fields(i) for i in r.trace], label
        assert list(e.masks) == list(r.masks), label
        for k in r.masks:
            np.testing.assert_array_equal(_words(e.masks[k]),
                                          np.asarray(r.masks[k]),
                                          f"{label} {k}")
            np.testing.assert_array_equal(e.read_mask(k), r.read_mask(k))
        assert list(e.derived) == list(r.derived), label
        for k, v in r.derived.items():
            if isinstance(v, int):
                assert e.derived[k] == v and type(e.derived[k]) is int, k
                assert e.read_reduce(k) == r.read_reduce(k)
            else:
                np.testing.assert_array_equal(_words(e.derived[k]),
                                              np.asarray(v), f"{label} {k}")
        assert e.found == r.found, label
        assert list(e.materialized) == list(r.materialized), label
        for k, cols in r.materialized.items():
            n_materialized += 1
            for a, v in cols.items():
                assert e.materialized[k][a].dtype == np.int64
                np.testing.assert_array_equal(e.materialized[k][a], v)
    assert n_materialized == 16


def test_immediate_predicates_go_through_ops(port_db, monkeypatch):
    """Every EqualImm/NotEqualImm/LessThanImm/GreaterThanImm with a
    representable immediate is one ``ops.predicate_eq_imm`` or
    ``predicate_cmp_imm`` call — what launches the CUDA kernels on a CUDA
    relation; an unrepresentable one short-circuits without a call."""
    calls = []
    for name in ("predicate_eq_imm", "predicate_cmp_imm"):
        fn = getattr(tops, name)
        monkeypatch.setattr(tops, name, lambda p, imm, fn=fn, name=name: (
            calls.append(name), fn(p, imm))[1])
    for spec in [q.filter_only() for q in tq.all_queries()]:
        for rel_name, pred in spec.filters.items():
            rel = port_db.relations[rel_name]
            c, _, _ = port_db._compile_relation(rel, spec, pred)
            e = te.Engine(rel)
            calls.clear()
            e.run(c.program)
            want = [("predicate_eq_imm" if "Equal" in i.kind
                     else "predicate_cmp_imm") for i in e.trace
                    if i.kind in ("EqualImm", "NotEqualImm", "LessThanImm",
                                  "GreaterThanImm")
                    and i.imm < 1 << e._planes(i.attr).shape[0]]
            assert calls == want, (spec.name, rel_name)
    rel = port_db.relations["customer"]
    e = te.Engine(rel)
    calls.clear()
    e.execute(tisa.EqualImm(dest="m", attr="c_acctbal", imm=1 << 40,
                            n_bits=rel.width_of("c_acctbal")))
    e.execute(tisa.GreaterThanImm(dest="g", attr="c_acctbal", imm=1 << 40,
                                  n_bits=rel.width_of("c_acctbal")))
    assert calls == [] and not e.read_mask("m").any() \
        and not e.read_mask("g").any()


# --------------------------------------------------------------------------
# PimDatabase.execute(spec, engine="eager")
# --------------------------------------------------------------------------
@pytest.mark.parametrize("qname", [q.name for q in tq.all_queries()])
def test_eager_execute_matches_reference_and_other_engines(port_db, ref_db,
                                                           qname):
    from repro.db import queries as rq
    spec = tq.get_query(qname).filter_only()
    eager = port_db.execute(spec, engine="eager")
    fused = port_db.execute(spec)
    oracle = port_db.execute(spec, engine=tdb.Engine.ORACLE)
    ref = ref_db.execute(rq.get_query(qname).filter_only(), engine="eager")
    assert eager.engine is tdb.Engine.EAGER and eager.batch_stats is None
    assert eager.aggregates == fused.aggregates == oracle.aggregates \
        == ref.aggregates
    for rel in spec.filters:
        e, r = eager.relations[rel], ref.relations[rel]
        np.testing.assert_array_equal(e.mask, fused.relations[rel].mask)
        np.testing.assert_array_equal(e.mask, oracle.relations[rel].mask)
        np.testing.assert_array_equal(e.mask, r.mask)
        assert [_fields(i) for i in e.trace] == [_fields(i) for i in r.trace]
        assert (e.selectivity, e.filter_attr_bits, e.filter_attr_sels,
                e.agg_attr_bits) == (r.selectivity, r.filter_attr_bits,
                                     r.filter_attr_sels, r.agg_attr_bits)
        assert (e.agg_plane_reads, e.agg_plane_reads_ungrouped,
                e.n_reduce_jobs) == (0, 0, 0)


def test_eager_host_specs_end_to_end(port_db, ref_db):
    from repro.db import queries as rq
    port_db.last_batch_stats = None
    for name in HOST_SPECS:
        eager = port_db.execute(tq.get_query(name), engine=tdb.Engine.EAGER)
        fused = port_db.execute(tq.get_query(name))
        oracle = port_db.execute(tq.get_query(name), engine="oracle")
        ref = ref_db.execute(rq.get_query(name), engine="eager")
        assert eager.engine is tdb.Engine.EAGER and eager.batch_stats is None
        assert eager.rows and eager.rows == fused.rows == oracle.rows \
            == ref.rows, name
        assert eager.materialized_rows == fused.materialized_rows \
            == oracle.materialized_rows == ref.materialized_rows, name
    port_db.execute(tq.get_query("Q6"), engine="eager")
    assert port_db.last_batch_stats is not None      # set by FUSED only


def test_engine_coerce_and_unported_writes(port_db):
    assert tdb.Engine.coerce(False) is tdb.Engine.EAGER
    assert tdb.Engine.coerce(True) is tdb.Engine.FUSED
    assert tdb.Engine.coerce("EAGER") is tdb.Engine.EAGER
    assert tdb.Engine.coerce(tdb.Engine.ORACLE) is tdb.Engine.ORACLE
    rel = port_db.relations["lineitem"]
    e = te.Engine(rel)
    e.execute(tisa.SetReset(dest="all", value=1, n_bits=1))
    assert e.count("all") == rel.n_records
    # The DML writes (ported with the dml package) program the engine's
    # copy of the relation, never the database's.
    width = rel.width_of("l_quantity")
    e.execute(tisa.PlaneWrite(dest="l_quantity", rows=(0, 33),
                              values=((1 << width) - 1, 0), n_bits=width))
    e.execute(tisa.ValidClear(dest="__valid__", rows=(0,)))
    got = tb.unpack_bits(te.to_words(e.rel.planes["l_quantity"]),
                                  rel.n_records)
    want = tb.unpack_bits(te.to_words(rel.planes["l_quantity"]),
                                   rel.n_records)
    assert (got[0], got[33]) == ((1 << width) - 1, 0)
    assert np.array_equal(np.delete(got, [0, 33]), np.delete(want, [0, 33]))
    assert e.count("all") == rel.n_records - 1
    assert te.Engine(rel).count("__valid__") == rel.n_records
    # A list on EAGER runs spec by spec (linking is FUSED's).
    got, = port_db.execute([tq.get_query("Q6")], engine="eager")
    assert got.engine is tdb.Engine.EAGER
    assert got.aggregates == port_db.execute(tq.get_query("Q6"),
                                             engine="eager").aggregates


def test_scan_all_materialize_and_readout(port_db):
    """A scan-all ``Materialize`` hands back the whole column, int64 in
    record order; a derived attribute reads back as its plane words."""
    rel = port_db.relations["lineitem"]
    c = Compiler(rel)
    c.compile_materialize(c.compile_scan_all(), ["l_quantity"])
    e = te.Engine(rel)
    e.run(c.program)
    got = e.read_materialized(c.program[-1].dest)["l_quantity"]
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, port_db.tables["lineitem"]
                                  ["l_quantity"])
    e.execute(tisa.AddImm(dest="q1", attr="l_quantity", imm=1, n_bits=8))
    np.testing.assert_array_equal(
        tb.unpack_bits(e.read_scalar("q1"), rel.n_records),
        port_db.tables["lineitem"]["l_quantity"] + 1)
    assert torch.equal(e.mask("__valid__"), rel.valid)
