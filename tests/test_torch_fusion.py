"""Port: linked multi-query batches (``PimDatabase.execute(list)``).

A FUSED list of specs is compiled spec by spec under ``q<i>.``
namespaces, linked into one SSA program per relation
(``core.program.link_programs``) and run as one program launch per
relation. On the CPU (the kernels' plain versions) the port's batches
equal the reference's batches (default ``jnp`` backend) and the port's
sequential results exactly: masks, aggregates, result rows and the
hardware-free counters (launches, plane reads, deduped instructions, the
linked programs' cache keys), and the ``q1_q6_q14_concurrent`` counters of
``benchmarks/baseline.json``. ``link_programs`` gives the reference's
instructions, outputs and slots for the same input programs.
"""
import dataclasses
import json
import threading
import warnings
from pathlib import Path

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from repro_torch.core import program as prog
from repro_torch.db import database as tdb
from repro_torch.db import queries as tq
from repro_torch.db import tpch as ttpch
from repro_torch.db.compiler import Agg, Cmp, Col, Lit

SF, SEED = 0.002, 123
ROOT = Path(__file__).resolve().parents[1]
BATCH = ("Q1", "Q6", "Q14")
# Lazy module-level singletons, not fixtures: the property test below
# cannot take fixtures (the hypothesis shim hides its signature).
_CACHE: dict = {}


def _tables():
    if "tables" not in _CACHE:
        _CACHE["tables"] = ttpch.generate(sf=SF, seed=SEED)
    return _CACHE["tables"]


def _port_db() -> tdb.PimDatabase:
    if "port" not in _CACHE:
        _CACHE["port"] = tdb.PimDatabase(_tables(), device="cpu")
    return _CACHE["port"]


@pytest.fixture(scope="module")
def db():
    return _port_db()


@pytest.fixture(scope="module")
def ref_db():
    pytest.importorskip("jax")
    from repro.db import database as rdb
    return rdb.PimDatabase(_tables())


def _ref_specs(names):
    from repro.db import queries as rq
    return [rq.get_query(n) for n in names]


def _assert_same(got, want, spec):
    """Masks, aggregates, result rows and materialized counts equal."""
    assert got.aggregates == want.aggregates, spec.name
    assert got.columns == want.columns, spec.name
    assert got.rows == want.rows, spec.name
    assert got.materialized_rows == want.materialized_rows, spec.name
    if spec.host is None:
        assert list(got.relations) == list(want.relations), spec.name
        for rel in got.relations:
            np.testing.assert_array_equal(got.relations[rel].mask,
                                          want.relations[rel].mask,
                                          f"{spec.name}/{rel}")


def _assert_batch_matches_sequential(dbx, specs):
    """The batch's results equal each spec run alone and ORACLE's; returns
    (results, the batch's stats)."""
    batch = dbx.execute(specs)
    stats = dbx.last_batch_stats    # before the single runs replace it
    assert len(batch) == len(specs)
    for spec, got in zip(specs, batch):
        assert got.spec is spec and got.engine is tdb.Engine.FUSED
        assert got.batch_stats is stats
        _assert_same(got, dbx.execute(spec), spec)
        oracle = dbx.execute(spec, engine="oracle")
        assert got.rows == oracle.rows, spec.name
        if spec.host is None:
            assert got.aggregates == oracle.aggregates, spec.name
            for rel in spec.filters:
                np.testing.assert_array_equal(
                    got.relations[rel].mask, oracle.relations[rel].mask)
    return batch, stats


# --------------------------------------------------------------------------
# The headline batch against the reference
# --------------------------------------------------------------------------
def test_q1_q6_q14_batch_matches_reference_and_sequential(db, ref_db):
    specs = [tq.get_query(n) for n in BATCH]
    batch, stats = _assert_batch_matches_sequential(db, specs)
    ref = ref_db.execute(_ref_specs(BATCH))
    rstats = ref_db.last_batch_stats
    for spec, got, want in zip(specs, batch, ref):
        _assert_same(got, want, spec)
    assert stats["n_queries"] == rstats["n_queries"] == 3
    assert stats["n_dispatches"] == rstats["n_dispatches"] == 2
    assert stats["relations"]["lineitem"]["n_programs"] == 3
    assert stats["relations"]["lineitem"]["instrs_deduped"] > 0
    assert set(stats["relations"]) == set(rstats["relations"])
    for rel, r in rstats["relations"].items():
        for key in ("n_programs", "instrs_unlinked", "instrs_linked",
                    "instrs_deduped", "plane_reads", "agg_plane_reads",
                    "source_plane_reads", "linked_key"):
            assert stats["relations"][rel][key] == r[key], (rel, key)
    assert stats["relations"]["lineitem"]["linked_key"] == "3964190c7eb5bc31"
    assert stats["relations"]["part"]["linked_key"] == "1039bb3dd73c4f88"
    assert stats["relations"]["lineitem"]["plane_reads"] == 195
    assert stats["relations"]["part"]["plane_reads"] == 17


def test_batch_with_empty_avg_group(db):
    """An empty group's avg and min stay None through the linked batch,
    exactly as in the sequential path."""
    spec = tq.QuerySpec(
        "Qempty", "full",
        filters={"customer": Cmp("gt", Col("c_acctbal"), Lit(1 << 40))},
        agg_relation="customer",
        aggregates=[Agg("avg", Col("c_acctbal"), "a"),
                    Agg("min", Col("c_acctbal"), "mn"),
                    Agg("count", None, "c")])
    batch = db.execute([spec, tq.get_query("Q6")])
    assert batch[0].aggregates["all"] == {"a": None, "mn": None, "c": 0}
    assert batch[0].aggregates == db.execute(spec).aggregates
    assert batch[1].aggregates == db.execute(tq.get_query("Q6")).aggregates


def test_recurring_batch_hits_tape_cache(db):
    """The same batch again links to the same programs: every relation's
    tape comes from the cache, no miss is added."""
    specs = [tq.get_query(n) for n in BATCH]
    db.execute(specs)
    keys = {r: s["linked_key"]
            for r, s in db.last_batch_stats["relations"].items()}
    h0, m0 = prog._FN_CACHE.hits, prog._FN_CACHE.misses
    db.execute(specs)
    assert prog._FN_CACHE.misses == m0
    assert prog._FN_CACHE.hits >= h0 + db.last_batch_stats["n_dispatches"]
    assert keys == {r: s["linked_key"]
                    for r, s in db.last_batch_stats["relations"].items()}


# --------------------------------------------------------------------------
# Linking
# --------------------------------------------------------------------------
def _fields(ins):
    """An instruction as (class name, field tuples), for comparing the two
    packages' instructions."""
    return (type(ins).__name__,
            tuple((f.name, getattr(ins, f.name))
                  for f in dataclasses.fields(ins)))


def _relation_programs(dbx, names, namespaced):
    """(instrs, mask_outputs) of each spec's lineitem program, compiled as
    ``_compile_batch`` compiles a filter/aggregate spec (with a ``q<i>.``
    namespace or without one)."""
    rel = dbx.relations["lineitem"]
    out = []
    for qi, spec in enumerate(names):
        ns = f"q{qi}." if namespaced else ""
        c, m, _ = dbx._compile_relation(rel, spec, spec.filters["lineitem"],
                                        namespace=ns)
        out.append((tuple(c.program), (m,)))
    return rel, out


def _check_ssa(lp, rel):
    """Single assignment, and every register read is defined earlier or is
    a relation attribute or the valid plane."""
    dests = [i.dest for i in lp.instrs]
    assert len(dests) == len(set(dests)), "linked program must stay SSA"
    defined = set(rel.planes) | {"__valid__"}
    for ins in lp.instrs:
        for r in prog.instruction_reads(ins):
            assert r in defined, (ins, r)
        defined.add(ins.dest)


@pytest.mark.parametrize("names,namespaced", [
    (("Q1", "Q6"), False), (("Q1", "Q6", "Q14"), True),
    (("Q6", "Q6", "Q19"), True), (("Q12", "Q1", "Q6"), False)])
def test_link_programs_matches_reference(db, ref_db, names, namespaced):
    """The port's ``link_programs`` over the port's programs equals the
    reference's over the reference's: instructions field for field, mask
    outputs, slots, counts and the cache key. Un-namespaced compilers
    collide and the linker renames; the result stays SSA."""
    from repro.core import program as rprog
    specs = [tq.get_query(n).filter_only() for n in names]
    rspecs = [s.filter_only() for s in _ref_specs(names)]
    rel, progs = _relation_programs(db, specs, namespaced)
    rrel, rprogs = _relation_programs(ref_db, rspecs, namespaced)
    assert [[_fields(i) for i in p] for p, _ in progs] == \
        [[_fields(i) for i in p] for p, _ in rprogs]
    lp = prog.link_programs(progs, relation=rel)
    rlp = rprog.link_programs(rprogs, relation=rrel)
    assert [_fields(i) for i in lp.instrs] == [_fields(i) for i in rlp.instrs]
    assert lp.mask_outputs == rlp.mask_outputs
    assert [(dict(s.reg_map), s.mask_outputs) for s in lp.slots] == \
        [(dict(s.reg_map), s.mask_outputs) for s in rlp.slots]
    assert (lp.n_instrs_unlinked, lp.n_deduped) == \
        (rlp.n_instrs_unlinked, rlp.n_deduped)
    assert lp.cache_key == rlp.cache_key
    _check_ssa(lp, rel)
    if not namespaced:
        assert {i.dest for i in progs[0][0]} & {i.dest for i in progs[1][0]}
        assert any(i.dest.startswith("q1.") for i in lp.instrs)


def test_namespaced_compilers_do_not_collide(db):
    rel = db.relations["lineitem"]
    spec = tq.get_query("Q6")
    regs = set()
    for ns in ("q0.", "q1."):
        c, m, _ = db._compile_relation(rel, spec, spec.filters["lineitem"],
                                       namespace=ns)
        mine = {i.dest for i in c.program}
        assert all(r.startswith(ns) for r in mine)
        assert not (regs & mine)
        regs |= mine


def test_equal_meaning_programs_link_to_one(db):
    """A program linked with itself under another namespace vanishes: every
    instruction of the second copy dedups, both slots read the same mask,
    and the compiled linked program is one launch for two queries."""
    spec = tq.get_query("Q6").filter_only()
    rel, progs = _relation_programs(db, [spec, spec], True)
    lp = prog.link_programs(progs, relation=rel)
    assert lp.n_deduped == len(progs[1][0])
    assert lp.slots[0].mask_outputs == lp.slots[1].mask_outputs
    cp = prog.compile_program(rel, lp.instrs, mask_outputs=lp.mask_outputs,
                              query_slots=lp.slots)
    assert cp.n_queries == 2 and cp.n_dispatches == 1
    res = prog.run_program(cp, rel)
    np.testing.assert_array_equal(res.query(0).mask(progs[0][1][0]),
                                  res.query(1).mask(progs[1][1][0]))


# --------------------------------------------------------------------------
# Property: any subset of the 19 runnable queries
# --------------------------------------------------------------------------
_ALL = [q.name for q in tq.all_queries()]


@settings(max_examples=5, deadline=None)
@given(st.integers(1, (1 << len(_ALL)) - 1))
def test_fusion_parity_random_subsets(subset_bits):
    """For any subset of the runnable TPC-H queries (the first 4 of it),
    the batch equals the specs run one at a time and ORACLE: rows,
    aggregates, masks."""
    specs = [tq.get_query(n) for i, n in enumerate(_ALL)
             if subset_bits >> i & 1][:4]
    _, stats = _assert_batch_matches_sequential(_port_db(), specs)
    rels = {r for s in specs
            for r in ([p[0] for p in _split(s)] if s.host is not None
                      else s.filters)}
    assert stats["n_dispatches"] == len(rels)


def _split(spec):
    from repro_torch.db import exec as E
    return E.split_query(spec)[0]


# --------------------------------------------------------------------------
# The reference benchmark's batch counters
# --------------------------------------------------------------------------
def test_batch_counters_match_baseline():
    """``q1_q6_q14_concurrent`` of ``benchmarks/baseline.json`` (SF 0.005,
    seed 0, Q14 as its full host spec), counted as the benchmark counts:
    launches of the batch and of the three run alone, lineitem plane reads
    of the batch and of each alone, deduped instructions and the batch's
    reads over the costliest single's, x1000."""
    base = json.loads((ROOT / "benchmarks" / "baseline.json").read_text())
    want = base["rows"]["q1_q6_q14_concurrent"]["meta"]
    assert base["sf"] == 0.005
    dbx = tdb.PimDatabase(ttpch.generate(sf=0.005, seed=0), device="cpu")
    specs = [tq.get_query(n) for n in BATCH]
    batch = dbx.execute(specs)
    stats = dbx.last_batch_stats
    li = stats["relations"]["lineitem"]
    singles, seq_dispatches = [], 0
    for spec in specs:
        dbx.execute([spec])
        s1 = dbx.last_batch_stats
        singles.append(s1["relations"]["lineitem"]["plane_reads"])
        seq_dispatches += s1["n_dispatches"]
    got = {"dispatches": stats["n_dispatches"],
           "dispatches_sequential": seq_dispatches,
           "plane_reads_batch": li["plane_reads"],
           "plane_reads_single_sum": sum(singles),
           "plane_reads_single_max": max(singles),
           "sublinearity_x1000": round(li["plane_reads"] / max(singles)
                                       * 1000),
           "instrs_deduped": li["instrs_deduped"]}
    assert got == {k: want[k] for k in got}
    assert got == {"dispatches": 2, "dispatches_sequential": 4,
                   "plane_reads_batch": 201, "plane_reads_single_sum": 287,
                   "plane_reads_single_max": 163,
                   "sublinearity_x1000": 1233, "instrs_deduped": 18}
    assert batch[0].aggregates == dbx.execute(specs[0]).aggregates
    assert batch[2].rows == dbx.execute(specs[2]).rows


# --------------------------------------------------------------------------
# Edge cases, threads and the deprecated shims
# --------------------------------------------------------------------------
def test_empty_and_singleton_batches(db):
    db.execute(tq.get_query("Q6"))
    assert db.last_batch_stats["n_queries"] == 1
    assert db.execute([]) == []
    assert db.last_batch_stats == tdb._empty_batch_stats()
    for name in ("Q6", "Q14"):
        spec = tq.get_query(name)
        one, = db.execute([spec])
        _assert_same(one, db.execute(spec), spec)
        assert db.last_batch_stats["n_queries"] == 1
        assert all(s["linked_key"] is None
                   for s in db.last_batch_stats["relations"].values())
    specs = [tq.get_query("Q6"), tq.get_query("Q14")]
    for engine in ("eager", "oracle"):
        got = db.execute(specs, engine=engine)
        for spec, r in zip(specs, got):
            assert r.engine is tdb.Engine.coerce(engine)
            _assert_same(r, db.execute(spec, engine=engine), spec)


def test_dispatch_and_finish_from_threads(db):
    """Four threads each dispatch a batch and finish its queries, and four
    threads finish the queries of one shared batch at once: every result
    equals the sequential one, and the shared batch's ``host_s`` is the
    sum of its queries' host stages."""
    specs = [tq.get_query(n) for n in ("Q3", "Q6", "Q12", "Q14", "Q19")]
    want = [db.execute(s) for s in specs]
    results, errors = [], []

    def own_batch():
        try:
            pendings, _ = db.dispatch_batch(specs)
            results.append([db.finish_query(p) for p in pendings])
        except Exception as e:              # reported below
            errors.append(e)
    threads = [threading.Thread(target=own_batch) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(results) == 4
    for got in results:
        for spec, g, w in zip(specs, got, want):
            _assert_same(g, w, spec)

    pendings, stats = db.dispatch_batch(specs)
    assert [p.needs_host for p in pendings] == \
        [s.host is not None for s in specs]
    assert stats["host_s"] == 0.0
    done = [None] * len(pendings)

    def finish(k):
        done[k] = db.finish_query(pendings[k])
    threads = [threading.Thread(target=finish, args=(k,))
               for k in range(len(pendings)) if pendings[k].needs_host]
    assert len(threads) == 4
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for k, p in enumerate(pendings):
        if not p.needs_host:
            done[k] = db.finish_query(p)
    for spec, g, w in zip(specs, done, want):
        _assert_same(g, w, spec)
    assert stats["host_s"] == pytest.approx(
        sum(r.host_s for r in done if r.spec.host is not None))


def test_deprecated_shims_warn_and_match(db):
    """``run_pim``, ``run_query`` and ``run_queries`` warn and return what
    ``execute`` returns; ``run_baseline`` is the ORACLE at the filter
    scope and, as in the reference, does not warn."""
    q1, q14 = tq.get_query("Q1"), tq.get_query("Q14")
    with pytest.warns(DeprecationWarning, match="run_pim"):
        got = db.run_pim(q1)
    _assert_same(got, db.execute(q1.filter_only()), q1)
    with pytest.warns(DeprecationWarning, match="run_pim"):
        eager = db.run_pim(q1, fused=False)
    assert eager.engine is tdb.Engine.EAGER
    assert eager.aggregates == got.aggregates
    with pytest.warns(DeprecationWarning, match="run_query"):
        got = db.run_query(q14)
    _assert_same(got, db.execute(q14), q14)
    specs = [q1, q14]
    with pytest.warns(DeprecationWarning, match="run_queries"):
        got = db.run_queries(specs)
    for spec, g, w in zip(specs, got, db.execute(specs)):
        _assert_same(g, w, spec)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        base = db.run_baseline(q1)
    assert base.engine is tdb.Engine.ORACLE
    assert base.aggregates == db.execute(q1.filter_only(),
                                         engine="oracle").aggregates
    assert tdb.QueryRun is tdb.QueryResult
    assert got[0].wall_time_s == got[0].wall_s

