"""Port: record-sharded relations on a mesh (``repro_torch.core.distributed``).

The counterparts of the reference's mesh tests, on the CPU (the kernels'
plain versions) with 8 logical shards on ``device="cpu"``, TPC-H sf 0.002;
every equality is exact, bits and ints:

* ``tests/test_distributed.py``'s DB tests on a (4, 2) ``("data",
  "model")`` mesh: the eager wrappers' filter + aggregate against numpy,
  and the valid-plane padding regression (one shard wholly padding) on the
  wrappers and on the fused path;
* ``tests/test_distributed_program.py``: all 19 specs plus ``Qmm_empty``
  and ``Qmm`` on a ``PimDatabase(tables, mesh=make_mesh((2, 4), ("pod",
  "data")))`` equal the port's single-device run, the reference's
  single-device FUSED ``execute`` and ORACLE; one logical dispatch, eight
  shards, masks left per shard with ``W/8`` words; the same mesh reuses
  the tape and no mesh is another cache entry;
* the mesh cases of ``test_exec``, ``test_fusion``, ``test_serve`` and
  ``test_dml``, held against the reference's single-device results (its
  own mesh tests of those fail: ``ProgramResult.materialized`` slices a
  word-sharded array, which jax 0.9 refuses).

The reference runs only through ``pytest.importorskip("jax")`` fixtures.
The ``-m cuda`` cases run the kernels at the shards' shapes on the card,
and over distinct cards where there are two or more.
"""
import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import dml
from repro_torch.core import bitslice
from repro_torch.core import distributed as dist
from repro_torch.core import engine as eng
from repro_torch.core import program as prog
from repro_torch.db import compiler as tc
from repro_torch.db import database as tdb
from repro_torch.db import queries as tq
from repro_torch.db import tpch as ttpch
from repro_torch.db.compiler import Agg, Between, Cmp, Col, Compiler, Lit
from repro_torch.serve import QueryService

SF, SEED = 0.002, 123
HOST_SPECS = ("Q3", "Q5", "Q10", "Q12", "Q14", "Q19")
BATCH = ("Q1", "Q6", "Q14", "Q19")
_CACHE: dict = {}


def _tables():
    if "tables" not in _CACHE:
        _CACHE["tables"] = ttpch.generate(sf=SF, seed=SEED)
    return _CACHE["tables"]


def _mesh():
    return dist.make_mesh((2, 4), ("pod", "data"), device="cpu")


def _minmax_specs(Q, C):
    """``Qmm_empty`` (an empty selection) and ``Qmm`` (MIN/MAX over a real
    one) of the reference's parity test, built from a package's
    ``queries`` and ``compiler`` modules."""
    return [
        Q.QuerySpec("Qmm_empty", "full",
                    filters={"customer": C.Cmp("gt", C.Col("c_acctbal"),
                                               C.Lit(1 << 40))},
                    agg_relation="customer",
                    aggregates=[C.Agg("min", C.Col("c_acctbal"), "mn"),
                                C.Agg("max", C.Col("c_acctbal"), "mx"),
                                C.Agg("sum", C.Col("c_acctbal"), "s"),
                                C.Agg("count", None, "c")]),
        Q.QuerySpec("Qmm", "full",
                    filters={"lineitem": C.Cmp("lt", C.Col("l_quantity"),
                                               C.Lit(10))},
                    agg_relation="lineitem",
                    aggregates=[C.Agg("min", C.Col("l_extendedprice"), "mn"),
                                C.Agg("max", C.Col("l_extendedprice"), "mx"),
                                C.Agg("count", None, "c")])]


def _specs(Q, C):
    """The 21 specs of the parity test, by name."""
    out = {q.name: q.filter_only() for q in Q.all_queries()}
    out.update((s.name, s) for s in _minmax_specs(Q, C))
    return out


SPEC_NAMES = list(_specs(tq, tc))


@pytest.fixture(scope="module")
def single_db():
    return tdb.PimDatabase(_tables(), device="cpu")


@pytest.fixture(scope="module")
def mesh_db():
    return tdb.PimDatabase(_tables(), mesh=_mesh())


@pytest.fixture(scope="module")
def ref_db():
    pytest.importorskip("jax")
    from repro.db import database as rdb
    return rdb.PimDatabase(_tables())


def _ref_result(ref_db, name, full=False):
    """The reference's single-device FUSED result of one spec (the parity
    spec of ``name``, or with ``full`` its end-to-end spec), cached."""
    key = ("ref", name, full)
    if key not in _CACHE:
        from repro.db import compiler as rc
        from repro.db import queries as rq
        spec = rq.get_query(name) if full else _specs(rq, rc)[name]
        _CACHE[key] = ref_db.execute(spec)
    return _CACHE[key]


# --------------------------------------------------------------------------
# Eager wrappers (test_distributed.py)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("axes", [("data",), ("data", "model")])
def test_distributed_filter_and_aggregate(axes):
    mesh = dist.make_mesh((4, 2), ("data", "model"), device="cpu")
    rng = np.random.default_rng(0)
    n = 4 * bitslice.TILE_RECORDS
    key = rng.integers(0, 1 << 16, n)
    val = rng.integers(0, 1 << 12, n)
    kp, vp, valid = (
        dist.shard_relation_planes(eng.to_planes(a, "cpu"), mesh, axes)
        for a in (bitslice.pack_bits(key, 16), bitslice.pack_bits(val, 12),
                  bitslice.pack_mask(np.ones(n, bool))))
    assert len(kp) == (4 if axes == ("data",) else 8)
    lo, hi = 1000, 30000
    run = dist.distributed_filter_aggregate(
        mesh, dist.make_sum_where_program(lo, hi), axes)
    pcs = run(kp, vp, valid)
    assert pcs.dtype == torch.int64
    got = sum(int(pcs[b]) << b for b in range(12))
    assert got == int(val[(key >= lo) & (key < hi)].sum())
    # A pure filter: no combine, the masks stay per shard.
    filt = dist.distributed_filter(
        mesh, lambda p: eng.cmp_imm_planes(p, hi)[0], axes)
    masks = filt(kp, valid)
    assert [m.shape[0] for m in masks] == [p.shape[1] for p in kp]
    mask = eng.to_words(dist.gather_shards(masks))
    assert (bitslice.unpack_mask(mask, n) == (key < hi)).all()


def test_distributed_valid_plane_padding_regression():
    """``n_records`` not a tile multiple: the zero-padded tail records would
    satisfy ``key >= 0 AND key < hi`` without the valid plane. Shard 7 of
    8 holds padding only."""
    mesh = dist.make_mesh((4, 2), ("data", "model"), device="cpu")
    rng = np.random.default_rng(1)
    n = 2 * bitslice.TILE_RECORDS + 12345
    W = bitslice.pad_words(n)
    assert n % bitslice.TILE_RECORDS != 0 and W * 32 > n
    key = rng.integers(1, 1 << 16, n)
    val = rng.integers(0, 1 << 12, n)
    kp, vp, valid = (
        dist.shard_relation_planes(eng.to_planes(a, "cpu"), mesh)
        for a in (bitslice.pack_bits(key, 16, W), bitslice.pack_bits(val, 12, W),
                  bitslice.pack_mask(np.ones(n, bool), W)))
    lo, hi = 0, 30000     # lo = 0: every zero-padded record passes the cmp
    run = dist.distributed_filter_aggregate(
        mesh, dist.make_sum_where_program(lo, hi))
    pcs = run(kp, vp, valid)
    got = sum(int(pcs[b]) << b for b in range(12))
    assert got == int(val[(key >= lo) & (key < hi)].sum())
    filt = dist.distributed_filter(
        mesh, lambda p: eng.cmp_imm_planes(p, hi)[0])
    mask = eng.to_words(dist.gather_shards(filt(kp, valid)))
    assert (bitslice.unpack_mask(mask, n) == (key < hi)).all()
    assert not bitslice.unpack_bits(mask[None], W * 32)[n:].any()
    # The fused path on the same relation, over all 8 shards.
    rel = eng.PimRelation.from_columns("t", {"k": key, "v": val},
                                       device="cpu").shard(mesh)
    assert rel.n_shards == 8 and not rel.shard_valid[-1].any()
    c = Compiler(rel)
    m = c.compile_filter(Between(Col("k"), 0, hi - 1), with_transform=False)
    regs = c.compile_aggregates(m, [Agg("sum", Col("v"), "s"),
                                    Agg("count", None, "c"),
                                    Agg("min", Col("k"), "mn")])
    cp = prog.compile_program(rel, c.program, mask_outputs=(m,), mesh=mesh)
    res = prog.run_program(cp, rel)
    sel = key < hi
    np.testing.assert_array_equal(res.mask(m), sel)
    assert not bitslice.unpack_bits(res.mask_packed(m)[None],
                                    W * 32)[n:].any()
    assert res.scalar(regs["s"][1]) == int(val[sel].sum())
    assert res.scalar(regs["c"][1]) == int(sel.sum())
    # MIN would be 0 (a padding record) without the valid words.
    assert res.scalar(regs["mn"][1]) == int(key[sel].min())


# --------------------------------------------------------------------------
# The fused path on a mesh database (test_distributed_program.py)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", SPEC_NAMES)
def test_fused_parity_all_queries(mesh_db, single_db, ref_db, name):
    """Mesh FUSED == single-device FUSED == mesh EAGER == ORACLE == the
    reference's single-device FUSED, masks and aggregates."""
    spec = _specs(tq, tc)[name]
    got = mesh_db.execute(spec)
    ref = _ref_result(ref_db, name)
    for other in (single_db.execute(spec),
                  mesh_db.execute(spec, engine="eager"),
                  single_db.execute(spec, engine="oracle"), ref):
        for rel in spec.filters:
            np.testing.assert_array_equal(got.relations[rel].mask,
                                          other.relations[rel].mask,
                                          f"{name}/{rel}")
        assert got.aggregates == other.aggregates, name
    stats = mesh_db.last_batch_stats
    assert stats["n_dispatches"] == len(spec.filters)
    assert all(r["program_launches"] == 8
               for r in stats["relations"].values())
    if name == "Qmm_empty":
        assert got.aggregates["all"] == {"mn": None, "mx": None, "s": 0,
                                         "c": 0}
    if name == "Qmm":
        assert got.aggregates["all"]["c"] > 0


def test_program_single_dispatch_and_sharded_outputs(mesh_db):
    """One logical dispatch, eight shards, the mask left per shard (W/8
    words each); the same mesh reuses the tape, no mesh is a miss."""
    spec = tq.get_query("Q6")
    rel = mesh_db.relations["lineitem"]
    c, mask_reg, _ = mesh_db._compile_relation(rel, spec,
                                               spec.filters["lineitem"])
    mesh = mesh_db.mesh
    cp = prog.compile_program(rel, c.program, mask_outputs=(mask_reg,),
                              mesh=mesh)
    assert cp.n_dispatches == 1 and cp.n_shards == 8
    assert cp.shard_axes == ("pod", "data")
    res = prog.run_program(cp, rel)
    parts = res._raw["masks"][mask_reg]
    W = rel.layout.n_words
    assert len(parts) == 8 and all(p.shape == (W // 8,) for p in parts)
    misses = prog._FN_CACHE.misses
    cp2 = prog.compile_program(rel, c.program, mask_outputs=(mask_reg,),
                               mesh=mesh)
    assert cp2.tape is cp.tape and prog._FN_CACHE.misses == misses
    # No mesh is another cache entry, another tape.
    cp3 = prog.compile_program(rel, c.program, mask_outputs=(mask_reg,))
    assert cp3.tape is not cp.tape and cp3.mesh is None
    # A program compiled for one device does not run on the sharded
    # relation: no quiet gather.
    with pytest.raises(ValueError, match="compiled for mesh"):
        prog.run_program(cp3, rel)


def test_fused_path_never_gathers(mesh_db, monkeypatch):
    """FUSED on a mesh reads each shard where it lies: no gathered view of
    a relation is built (the eager engine's is)."""
    def boom(shards):
        raise AssertionError("gathered a sharded relation")
    monkeypatch.setattr(dist, "gather_shards", boom)
    specs = [tq.get_query(n) for n in ("Q1", "Q6", "Q14", "Q3")]
    for s in specs:
        mesh_db.execute(s)
    mesh_db.execute(specs)
    with pytest.raises(AssertionError, match="gathered"):
        mesh_db.execute(specs[1], engine="eager")


def test_shard_keeps_one_resident_copy():
    """The shards are the only copy: their bytes are the relation's, none
    is a view of the unsharded tensors, and the gathered view equals the
    relation bit for bit."""
    rel = eng.PimRelation.from_columns(
        "lineitem", _tables()["lineitem"], device="cpu")
    srel = rel.shard(_mesh())
    assert isinstance(srel, dist.ShardedRelation)
    nbytes = sum(t.untyped_storage().nbytes()
                 for part in srel.shard_planes for t in part.values())
    nbytes += sum(v.untyped_storage().nbytes() for v in srel.shard_valid)
    assert nbytes == srel.bytes_resident() == rel.bytes_resident()
    ptrs = {t.untyped_storage().data_ptr() for t in rel.planes.values()}
    assert not ptrs & {t.untyped_storage().data_ptr()
                       for part in srel.shard_planes for t in part.values()}
    g = srel.gathered()
    assert type(g) is eng.PimRelation
    for a, p in rel.planes.items():
        assert torch.equal(g.planes[a], p)
    assert torch.equal(g.valid, rel.valid)
    # bumped and a replace that keeps the planes keep the same shards.
    assert srel.bumped().shard_planes is srel.shard_planes
    assert dataclasses.replace(srel, version=3).shard_planes is \
        srel.shard_planes


def test_shard_axes_subset_places_each_shard_once(single_db):
    """Sharded over ``("data",)`` of a (2, 4) mesh: 4 shards, held once
    each (the reference replicates them over ``pod``); results equal."""
    db = tdb.PimDatabase(_tables(), mesh=_mesh(), shard_axes=("data",))
    rel = db.relations["lineitem"]
    assert rel.n_shards == 4 and rel.shard_axes == ("data",)
    for name in ("Q1", "Q14"):
        spec = tq.get_query(name)
        got, want = db.execute(spec), single_db.execute(spec)
        assert (got.aggregates, got.rows) == (want.aggregates, want.rows)


def test_mesh_not_dividing_words_raises():
    mesh = dist.make_mesh((3,), ("data",), device="cpu")
    rel = eng.PimRelation.from_columns("t", {"k": np.arange(100)},
                                       device="cpu")
    assert rel.layout.n_words % 3
    with pytest.raises(ValueError, match="do not divide"):
        dist.shard_relation_planes(rel.planes["k"], mesh)
    with pytest.raises(ValueError, match="do not divide"):
        rel.shard(mesh)
    with pytest.raises(ValueError, match="do not divide"):
        tdb.PimDatabase(_tables(), mesh=mesh)
    with pytest.raises(ValueError, match="not in mesh axes"):
        dist.mesh_shard_axes(mesh, ("pod",))


def test_cuda_mesh_without_cuda_raises(monkeypatch):
    """``make_mesh(..., device="cuda")`` and a mesh over CUDA devices raise
    where CUDA is unavailable, never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        dist.make_mesh((2, 4), ("pod", "data"))
    with pytest.raises(RuntimeError, match="is_available"):
        dist.make_mesh((2,), ("data",), devices=["cuda:0", "cuda:1"])
    with pytest.raises(RuntimeError, match="is_available"):
        tdb.PimDatabase(_tables(), mesh=dist.make_mesh(
            (2, 4), ("pod", "data"), device="cuda"))


@pytest.mark.parametrize("case", ["empty", "full", "random"])
@pytest.mark.parametrize("is_max", [False, True])
def test_combine_one_level_equals_two(case, is_max):
    """Reducing every shard's tile candidates at once gives the bits of
    reducing each shard first and then the shards' extrema (the
    reference's two levels), at an empty selection, a full one and a
    random one, bit 31 included."""
    gen = torch.Generator().manual_seed(5)
    n_shards, tiles, n_bits = 8, 5, 32
    bits = torch.randint(0, 2, (n_shards * tiles, n_bits), generator=gen,
                         dtype=torch.int32)
    found = {"empty": torch.zeros(n_shards * tiles, dtype=torch.bool),
             "full": torch.ones(n_shards * tiles, dtype=torch.bool),
             "random": torch.randint(0, 2, (n_shards * tiles,),
                                     generator=gen).bool()}[case]
    one, any1 = dist.combine_minmax_candidates(bits, found, is_max)
    per = [dist.combine_minmax_candidates(bits[s * tiles:(s + 1) * tiles],
                                          found[s * tiles:(s + 1) * tiles],
                                          is_max)
           for s in range(n_shards)]
    two, any2 = dist.combine_minmax_candidates(
        torch.stack([b for b, _ in per]), torch.stack([f for _, f in per]),
        is_max)
    assert bool(any1) == bool(any2) == bool(found.any())
    if case != "empty":
        assert torch.equal(one, two)
        vals = [sum(int(r[b]) << b for b in range(n_bits))
                for r, f in zip(bits, found) if f]
        assert sum(int(one[b]) << b for b in range(n_bits)) == \
            (max(vals) if is_max else min(vals))


# --------------------------------------------------------------------------
# Mesh cases of test_exec, test_fusion, test_serve and test_dml
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", HOST_SPECS)
def test_end_to_end_mesh(mesh_db, single_db, ref_db, name):
    """Per-shard materialize + the host prefix stitch give the
    single-device rows bit for bit (the reference's own mesh test of this
    fails at its stitch under jax 0.9)."""
    spec = tq.get_query(name)
    got = mesh_db.execute(spec)
    ref = _ref_result(ref_db, name, full=True)
    want = single_db.execute(spec)
    assert got.rows and got.rows == want.rows == ref.rows
    assert got.columns == want.columns == tuple(ref.columns)
    assert got.materialized_rows == want.materialized_rows == \
        ref.materialized_rows
    eager = mesh_db.execute(spec, engine="eager")
    assert eager.rows == got.rows


def test_empty_avg_on_mesh(mesh_db):
    spec = tq.QuerySpec(
        "Qavg_empty", "full",
        filters={"customer": Cmp("gt", Col("c_acctbal"), Lit(1 << 40))},
        agg_relation="customer",
        aggregates=[Agg("avg", Col("c_acctbal"), "avg_bal")])
    assert mesh_db.execute(spec).aggregates == {"all": {"avg_bal": None}}
    with pytest.warns(DeprecationWarning):
        assert mesh_db.run_pim(spec).aggregates == {
            "all": {"avg_bal": None}}


def test_fusion_parity_mesh(mesh_db, ref_db):
    """The linked Q1+Q6+Q14+Q19 batch on the mesh: one logical dispatch per
    relation (eight launches each), every result equal to the reference's
    single-device one; split-phase and the shims too."""
    specs = [tq.get_query(n) for n in BATCH]
    batch = mesh_db.execute(specs)
    stats = mesh_db.last_batch_stats
    assert stats["n_dispatches"] == 2
    assert {r: s["program_launches"] for r, s in stats["relations"].items()
            } == {"lineitem": 8, "part": 8}
    pendings, _ = mesh_db.dispatch_batch(specs)
    split = [mesh_db.finish_query(p) for p in pendings]
    with pytest.warns(DeprecationWarning):
        shim = mesh_db.run_queries(specs)
    for spec, *gots in zip(specs, batch, split, shim):
        want = _ref_result(ref_db, spec.name, full=True)
        for got in gots:
            assert got.rows == want.rows, spec.name
            assert got.aggregates == want.aggregates, spec.name
            for rel in got.relations:
                np.testing.assert_array_equal(
                    got.relations[rel].mask, want.relations[rel].mask,
                    f"{spec.name}/{rel}")


def test_serve_mesh_smoke(single_db):
    specs = [tq.get_query(n) for n in ("Q1", "Q6", "Q14", "Q6", "Q1")]
    want = [single_db.execute(s) for s in specs]
    dbm = tdb.PimDatabase(_tables(), mesh=_mesh())

    async def main():
        async with QueryService(dbm, max_window=3, max_wait_s=0.005) as svc:
            res = await asyncio.gather(*[svc.submit(s) for s in specs])
            return res, svc.stats()

    res, stats = asyncio.run(asyncio.wait_for(main(), 60))
    for s, got, exp in zip(specs, res, want):
        assert (got.rows, got.aggregates) == (exp.rows, exp.aggregates), \
            s.name
    assert stats["errors"] == 0
    assert stats["coalesced"] == 2


def _dml_round(db, pkg_dml):
    """The reference's mesh DML smoke: insert 32, delete 16, update 32 on
    lineitem, then Q6; returns the oracle's and the database's Q6."""
    oracle = pkg_dml.MutableTable(db.tables["lineitem"])
    live = db.dml_state("lineitem").live_ids()
    take = {a: np.asarray(c[:32]) for a, c in db.tables["lineitem"].items()}
    db.apply([pkg_dml.Insert("lineitem", take),
              pkg_dml.Delete("lineitem", row_ids=live[:16]),
              pkg_dml.Update("lineitem", {"l_quantity": 9},
                             row_ids=live[16:48])])
    oracle.insert(take)
    oracle.delete(row_ids=list(range(16)))
    oracle.update({"l_quantity": 9}, row_ids=list(range(16, 48)))
    return oracle


def test_dml_mesh_smoke():
    """DML on a sharded database: ``apply`` writes on the gathered view and
    ``publish`` shards the relation again; Q6 then equals the mutable
    table, the single-device port and the reference's single-device
    database after the same writes."""
    pytest.importorskip("jax")
    from repro import dml as rdml
    from repro.db import database as rdb
    from repro.db import queries as rq
    tables = ttpch.generate(sf=SF, seed=0)
    dbs = [tdb.PimDatabase(tables, mesh=_mesh()),
           tdb.PimDatabase(tables, device="cpu")]
    spec = tq.get_query("Q6")
    got = []
    for db in dbs:
        oracle = _dml_round(db, dml)
        r = db.execute(spec)
        exp = oracle.aggregate(spec.filters["lineitem"], spec.aggregates)
        assert tuple(r.aggregates["all"][a.name]
                     for a in spec.aggregates) == exp
        got.append(r)
    rel = dbs[0].relations["lineitem"]
    assert isinstance(rel, dist.ShardedRelation) and rel.n_shards == 8
    assert dbs[0].dml_state("lineitem").rel is rel
    ref = rdb.PimDatabase(tables)
    _dml_round(ref, rdml)
    want = ref.execute(rq.get_query("Q6"))
    for r in got:
        assert r.aggregates == want.aggregates
        np.testing.assert_array_equal(r.relations["lineitem"].mask,
                                      want.relations["lineitem"].mask)


def test_dml_growth_on_mesh(single_db):
    """An insert past the reserved capacity grows the planes by a tile;
    the grown relation is sharded again, 8 ways, and queries stay equal to
    the mutable table and the single-device port."""
    tables = ttpch.generate(sf=SF, seed=0)
    dbs = [tdb.PimDatabase(tables, mesh=_mesh()),
           tdb.PimDatabase(tables, device="cpu")]
    spec = tq.get_query("Q6")
    src = tables["lineitem"]
    n = len(src["l_quantity"])
    w0 = dbs[0].relations["lineitem"].layout.n_words
    k = dbs[0].dml_state("lineitem").capacity - n + 100
    take = {a: np.asarray(c)[np.arange(k) % n] for a, c in src.items()}
    res = []
    for db in dbs:
        oracle = dml.MutableTable(db.tables["lineitem"])
        db.apply([dml.Insert("lineitem", take)])
        oracle.insert(take)
        r = db.execute(spec.filter_only())
        assert tuple(r.aggregates["all"][a.name] for a in spec.aggregates) \
            == oracle.aggregate(spec.filters["lineitem"], spec.aggregates)
        res.append(r)
    rel = dbs[0].relations["lineitem"]
    assert rel.layout.n_words > w0 and rel.n_shards == 8
    assert all(v.shape == (rel.layout.n_words // 8,)
               for v in rel.shard_valid)
    np.testing.assert_array_equal(res[0].relations["lineitem"].mask,
                                  res[1].relations["lineitem"].mask)


def test_scrub_repairs_on_mesh():
    """The fault guard runs unchanged on a sharded database: a flipped cell
    is found by the scrub (on the gathered view), repaired and
    republished sharded, with the single-device port's report."""
    from repro_torch import faults
    reports = []
    for kw in ({"mesh": _mesh()}, {"device": "cpu"}):
        db = tdb.PimDatabase(_tables(), **kw)
        fm = faults.FaultManager(db)
        fm.guard_relation("lineitem")
        v0 = db.relations["lineitem"].version
        fm.inject_flip("lineitem", "l_quantity", 5, 0)
        fm.inject_flip("lineitem", "__valid__", 40, 0)
        assert db.relations["lineitem"].version == v0
        reports.append(fm.scrub())
        assert db.relations["lineitem"].version > v0
        assert not fm.undetected()
        spec = tq.get_query("Q6")
        reports.append(db.execute(spec).aggregates)
        if "mesh" in kw:
            assert db.relations["lineitem"].n_shards == 8
    assert reports[:2] == reports[2:]


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------
def _need_cuda(n: int = 1) -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "false")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} GPUs, found {torch.cuda.device_count()}")


@pytest.mark.cuda
@pytest.mark.parametrize("n_words", [128, 23_552])
def test_shard_kernels_equal_plain_on_card(n_words):
    """``fused_program`` and ``materialize`` at a shard's shapes (sf
    0.002's 128 words, SF 1 lineitem's 23,552): a shard of data, one
    wholly padding and one with no selected record, each == plain."""
    _need_cuda()
    from repro_torch.kernels import materialize as kmat
    from repro_torch.kernels import program as kprog
    rng = np.random.default_rng(n_words)
    n = n_words * 32
    cols = {"k": rng.integers(0, 1 << 12, n), "v": rng.integers(0, 1 << 20, n)}
    rel = eng.PimRelation.from_columns("t", cols, device="cuda")
    c = Compiler(rel)
    m = c.compile_filter(Between(Col("k"), 100, 2000), with_transform=False)
    c.compile_aggregates(m, [Agg("sum", Col("v"), "s"),
                             Agg("min", Col("v"), "mn"),
                             Agg("max", Col("k"), "mx")])
    cp = prog.compile_program(rel, c.program, mask_outputs=(m,))
    rows, r0 = {}, 0
    for a in cp.kernel_attrs:
        rows[a] = slice(r0, r0 + rel.width_of(a))
        r0 += rel.width_of(a)
    stacked = prog.stack_sources(cp, rel)
    cases = {"data": stacked, "padding": torch.zeros_like(stacked),
             "none": stacked.clone()}
    cases["none"][rows["k"]] = 0           # k = 0: nothing in [100, 2000]
    for what, st in cases.items():
        got = kprog.fused_program(st, cp.tape)
        want = kprog.fused_program_torch(st, cp.tape)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu()), what
        planes = [st[rows["v"]], st[rows["k"]]]
        vals, cnt = kmat.materialize(planes, got[0][0])
        pv, pc = kmat.materialize_torch([p.cpu() for p in planes],
                                        want[0][0].cpu())
        assert int(cnt) == int(pc), what
        assert torch.equal(vals[:, :int(cnt)].cpu(), pv[:, :int(pc)]), what


@pytest.mark.cuda
def test_mesh_over_distinct_cards():
    """A (2,) mesh over two cards: every shard on its own device, Q1, Q6
    and Q14 equal to the single-card database."""
    _need_cuda(2)
    tables = ttpch.generate(sf=SF, seed=SEED)
    mesh = dist.make_mesh((2,), ("data",), devices=["cuda:0", "cuda:1"])
    dbm = tdb.PimDatabase(tables, mesh=mesh)
    assert {v.device.index for v in dbm.relations["lineitem"].shard_valid} \
        == {0, 1}
    db1 = tdb.PimDatabase(tables)
    for name in ("Q1", "Q6", "Q14"):
        spec = tq.get_query(name)
        got, want = dbm.execute(spec), db1.execute(spec)
        assert (got.aggregates, got.rows) == (want.aggregates, want.rows)
