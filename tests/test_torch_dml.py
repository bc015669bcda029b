"""Port: mutable relations (``repro_torch.dml``).

The cases of ``tests/test_dml.py`` on the port's modules (its 8-device
mesh smoke test is ``tests/test_torch_distributed.py::
test_dml_mesh_smoke``):
the allocator (policies, tile growth, the replayable wear
counterfactual), ``RelationDml`` plane-level readback against the NumPy
mutable-table oracle (insert / delete / update in place / widening
update-by-move / compact), growth past the reserved append segment, the
delete-everything edge case through a full query, the accounting of
``PimDatabase.apply`` / ``report``, and a seeded interleaved-DML property
test on both of the port's engines (FUSED and EAGER).

Parity with the reference (jax only through ``pytest.importorskip``): one
mutation stream through both packages' ``RelationDml`` gives the same
plane words, valid words, allocator events, ``MutationStats`` and write
programs; and the ``htap_stream`` stream of
``benchmarks/bench_kernels.py`` (4 x 6 rounds of 64 rows, sf 0.005) driven
through ``db.apply`` gives ``benchmarks/baseline.json``'s DML counters.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro_torch import dml
from repro_torch.core import bitslice
from repro_torch.core import engine as eng
from repro_torch.core.engine import PimRelation
from repro_torch.db import queries, tpch
from repro_torch.db.compiler import Cmp, Col, Lit
from repro_torch.db.database import PimDatabase

ROOT = Path(__file__).resolve().parents[1]


def _small(n=60, seed=0, widths=None, device="cpu"):
    rng = np.random.default_rng(seed)
    cols = {"a": rng.integers(0, 50, n), "b": rng.integers(0, 1000, n)}
    return PimRelation.from_columns("t", cols, widths=widths,
                                    device=device), cols


def _readback(d: dml.RelationDml):
    """Decode live rows straight from the device planes (logical-id
    order) — the strong parity check: the bits, not the shadow."""
    rel = d.rel
    cap = rel.layout.capacity_records
    slots = np.asarray([d.slot_of[i] for i in d.live_ids()], dtype=np.int64)
    valid = bitslice.unpack_mask(eng.to_words(rel.valid), cap)
    assert np.array_equal(np.flatnonzero(valid), np.sort(slots))
    return {a: bitslice.unpack_bits(eng.to_words(p), cap)[slots]
            for a, p in rel.planes.items()}


def _assert_same(d: dml.RelationDml, t: dml.MutableTable):
    assert d.live_ids() == sorted(t.ids.tolist())
    got = _readback(d)
    exp = t.columns()
    assert set(got) == set(exp)
    for a in exp:
        assert np.array_equal(got[a], np.asarray(exp[a])), a


# --------------------------------------------------------------------------
# AppendSegments: policies, growth, replay counterfactual
# --------------------------------------------------------------------------
def test_append_segments_policies():
    s = dml.AppendSegments(8, n_packed=4, policy="first_fit")
    assert list(s.alloc(2)) == [4, 5]
    s.free([0, 1])
    assert list(s.alloc(1)) == [0]        # immediately reuses freed low slot

    r = dml.AppendSegments(8, n_packed=4, policy="rotate")
    assert list(r.alloc(2)) == [4, 5]
    r.free([0, 1])
    assert list(r.alloc(2)) == [6, 7]     # cursor keeps walking forward
    assert list(r.alloc(2)) == [0, 1]     # ...and only then wraps

    with pytest.raises(ValueError):
        dml.AppendSegments(8, policy="lru")


def test_append_segments_growth_tile_multiple():
    s = dml.AppendSegments(4, n_packed=4, policy="rotate")
    slots = s.alloc(2)                    # no free slots: must grow
    assert list(slots) == [4, 5]
    assert s.capacity == 4 + dml.GROWTH_SLOTS
    assert s.grown_tiles == 1


def test_replay_staging_churn_counterfactual():
    """Rolling staging buffer: rotate spreads writes over the append
    region, first_fit ping-pongs two slot blocks. Replay of the same
    logical trace reproduces the rotate profile exactly and puts the
    first-fit counterfactual well above 2x."""
    cap, n0, k = 256, 64, 16
    seg = dml.AppendSegments(cap, n_packed=n0, policy="rotate")
    slot_of, next_id, prev = {}, n0, []
    for _ in range(12):
        slots = seg.alloc(k)
        ids = list(range(next_id, next_id + k))
        next_id += k
        for lid, s_ in zip(ids, slots):
            slot_of[lid] = int(s_)
        seg.record_writes(slots, 10.0)
        seg.log("insert", ids, 10.0)
        if prev:
            ps = [slot_of.pop(lid) for lid in prev]
            seg.free(ps)
            seg.record_writes(ps, 1.0)
            seg.log("delete", prev, 1.0)
        prev = ids
    again = dml.replay(seg.events, cap, n0, "rotate")
    assert np.array_equal(again.writes, seg.writes)
    ff = dml.replay(seg.events, cap, n0, "first_fit")
    assert seg.busiest_row_ops() <= 0.5 * ff.busiest_row_ops()
    assert seg.total_cell_writes() == ff.total_cell_writes()


# --------------------------------------------------------------------------
# RelationDml vs oracle: plane-level readback parity
# --------------------------------------------------------------------------
def _mutations_match_oracle(device):
    rel, cols = _small(60, device=device)
    d = dml.RelationDml(rel, cols)
    t = dml.MutableTable(cols)

    ids = d.insert({"a": [1, 2, 3], "b": [7, 8, 9]})
    assert ids == t.insert({"a": [1, 2, 3], "b": [7, 8, 9]})
    _assert_same(d, t)

    assert d.delete(row_ids=[0, 5, ids[1]]) == [0, 5, ids[1]]
    assert t.delete(row_ids=[0, 5, ids[1]]) == 3
    _assert_same(d, t)

    pred = Cmp("le", Col("a"), Lit(10))
    assert d.update({"a": 11}, pred=pred) == t.update({"a": 11}, pred=pred)
    _assert_same(d, t)

    # Per-row assignment sequence aligns with ascending-logical-id order.
    d.update({"b": [100, 101]}, row_ids=[10, 11])
    t.update({"b": [100, 101]}, row_ids=[10, 11])
    _assert_same(d, t)

    k = d.compact()
    t.apply(dml.Compact("t"))             # oracle: no-op by design
    assert k == t.n_rows
    assert d.rel.layout.n_records == k    # watermark reset
    assert sorted(d.slot_of.values()) == list(range(k))
    _assert_same(d, t)

    with pytest.raises(KeyError):
        d.delete(row_ids=[0])             # id 0 was deleted above
    with pytest.raises(ValueError):
        d.insert({"a": [1]})              # missing column b
    with pytest.raises(ValueError):
        d.insert({"a": [1 << 40], "b": [0]})   # overflows the plane stack
    return d


def test_mutations_match_oracle_readback():
    _mutations_match_oracle("cpu")


def test_update_widening_move():
    rel, cols = _small(20, widths={"a": 6, "b": 10})
    d = dml.RelationDml(rel, cols)
    t = dml.MutableTable(cols)
    assert d.rel.width_of("a") == 6

    # 100 needs 7 bits: the stack widens and the rows move via the
    # allocator (delete + insert under the same logical ids).
    assert d.update({"a": 100}, row_ids=[3, 4]) == 2
    t.update({"a": 100}, row_ids=[3, 4])
    assert d.rel.width_of("a") == 7
    assert d.slot_of[3] >= 20 and d.slot_of[4] >= 20
    assert d.rel.layout.n_records == d.slot_of[4] + 1
    _assert_same(d, t)


def test_insert_past_capacity_grows_in_tiles():
    n = bitslice.TILE_RECORDS - 8
    rng = np.random.default_rng(1)
    cols = {"a": rng.integers(0, 100, n)}
    rel = PimRelation.from_columns("t", cols, device="cpu")
    d = dml.RelationDml(rel, cols)
    t = dml.MutableTable(cols)
    assert d.rel.layout.n_words == bitslice.TILE_WORDS
    assert d.segments.n_free == 8

    rows = {"a": list(range(40))}
    assert d.insert(rows) == t.insert(rows)
    assert d.rel.layout.n_words == 2 * bitslice.TILE_WORDS
    assert d.rel.layout.capacity_records == 2 * bitslice.TILE_RECORDS
    for p in d.rel.planes.values():
        assert p.shape[1] == 2 * bitslice.TILE_WORDS
        assert p.dtype == torch.int32
    assert d.rel.valid.shape[0] == 2 * bitslice.TILE_WORDS
    assert d.rel.layout.n_records == n + 40
    assert d.rel.bytes_reserved() > 0
    _assert_same(d, t)


# --------------------------------------------------------------------------
# Through the database: edge cases + accounting
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def db():
    return PimDatabase(tpch.generate(sf=0.002, seed=0), device="cpu")


def test_apply_accounting_and_report(db):
    spec = queries.get_query("Q6")
    q6 = spec.filter_only()
    rel = db.relations["lineitem"]
    v0 = rel.version
    take = {a: np.asarray(c[:16]) for a, c in db.tables["lineitem"].items()}
    stats = db.apply([dml.Insert("lineitem", take)])["lineitem"]
    assert stats["n_mutations"] == 1 and stats["n_rows"] == 16
    # Every inserted row programs its full row: all attribute planes
    # plus the valid bit — row_bits cells each.
    assert stats["cells_written"] == 16 * rel.layout.row_bits
    assert stats["version"] == db.relations["lineitem"].version > v0
    assert stats["busiest_row_ops"] > 0

    rep = db.report(db.execute(q6))
    assert rep.dml_row_ops == stats["busiest_row_ops"]
    assert rep.bytes_reserved > 0
    # Per-query footprint: the relations this query touches.
    assert rep.bytes_resident \
        == db.relations["lineitem"].bytes_resident() > 0
    assert rep.bytes_reserved \
        == db.relations["lineitem"].bytes_reserved()


def test_delete_all_then_query():
    # Own database: emptying lineitem must not poison the shared fixture.
    db = PimDatabase(tpch.generate(sf=0.002, seed=0), device="cpu")
    spec = queries.get_query("Q6")
    q6 = spec.filter_only()
    db.apply([dml.Delete("lineitem",
                         row_ids=db.dml_state("lineitem").live_ids())])
    # A second delete-everything is a no-op batch, not stale accounting.
    st_ = db.apply([dml.Delete("lineitem",
                               pred=spec.filters["lineitem"])])["lineitem"]
    assert st_["n_rows"] == 0 and st_["cells_written"] == 0
    assert db.tables["lineitem"]["l_quantity"].size == 0
    res = db.execute(q6)
    assert res.aggregates == db.run_baseline(q6).aggregates
    for agg, got in zip(spec.aggregates,
                        (res.aggregates["all"][a.name]
                         for a in spec.aggregates)):
        assert got == (0 if agg.op in ("sum", "count") else None)


# --------------------------------------------------------------------------
# Property test: seeded interleaved DML vs oracle, both engines
# --------------------------------------------------------------------------
_PROP: dict = {}


def _prop_db(engine: str) -> PimDatabase:
    if engine not in _PROP:
        _PROP[engine] = PimDatabase(tpch.generate(sf=0.002, seed=7),
                                    device="cpu")
    return _PROP[engine]


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 10**6),
       st.sampled_from(["fused", "eager"]),
       st.sampled_from(["insert", "delete", "update"]),
       st.booleans())
def test_interleaved_dml_matches_oracle(seed, engine, op, compact):
    """Mutations accumulate across examples on a shared database; each
    example mirrors its batch onto a fresh oracle built from the
    published ``db.tables`` view, then checks (a) the published table
    stays bit-identical to the oracle and (b) Q6 through the real
    filter pipeline on ``engine`` matches the oracle aggregate."""
    db = _prop_db(engine)
    spec = queries.get_query("Q6")
    q6 = spec.filter_only()
    oracle = dml.MutableTable(db.tables["lineitem"])
    live = db.dml_state("lineitem").live_ids()
    n = len(live)
    rng = np.random.default_rng(seed)

    muts = []
    if op == "insert" or n < 8:
        idx = rng.integers(0, n, int(rng.integers(1, 6)))
        rows = {a: np.asarray(c)[idx]
                for a, c in db.tables["lineitem"].items()}
        muts.append(dml.Insert("lineitem", rows))
        oracle_ops = [("insert", rows)]
    elif op == "delete":
        pos = sorted(set(rng.integers(0, n, 4).tolist()))
        muts.append(dml.Delete("lineitem",
                               row_ids=[live[p] for p in pos]))
        oracle_ops = [("delete", pos)]
    else:
        pos = sorted(set(rng.integers(0, n, 4).tolist()))
        val = int(rng.integers(0, 40))
        muts.append(dml.Update("lineitem", {"l_quantity": val},
                               row_ids=[live[p] for p in pos]))
        oracle_ops = [("update", (pos, val))]
    if compact:
        muts.append(dml.Compact("lineitem"))
    db.apply(muts)

    for kind, payload in oracle_ops:
        if kind == "insert":
            oracle.insert(payload)
        elif kind == "delete":
            oracle.delete(row_ids=payload)
        else:
            pos, val = payload
            oracle.update({"l_quantity": val}, row_ids=pos)

    got_cols, exp_cols = db.tables["lineitem"], oracle.columns()
    for a in exp_cols:
        assert np.array_equal(np.asarray(got_cols[a]),
                              np.asarray(exp_cols[a])), (engine, a)
    r = db.execute(q6, engine=engine)
    exp = oracle.aggregate(spec.filters["lineitem"], spec.aggregates)
    got = tuple(r.aggregates["all"][a.name] for a in spec.aggregates)
    assert exp == got, (engine, op, compact)


# --------------------------------------------------------------------------
# Parity with the reference's DML
# --------------------------------------------------------------------------
def _stream(d, take, C):
    """One mutation stream through a ``RelationDml`` of either package
    (``C`` its compiler module, for the predicates), touching every write
    path: insert, delete by ids and by predicate, update in place, a
    widening update-by-move, growth past capacity, compact, and the two
    repair primitives."""
    ids = d.insert({a: v[:5] for a, v in take.items()})
    yield
    d.delete(row_ids=[0, 7, ids[2]])
    yield
    d.delete(pred=C.Cmp("lt", C.Col("b"), C.Lit(40)))
    yield
    d.update({"a": 3}, pred=C.Cmp("ge", C.Col("a"), C.Lit(45)))
    yield
    d.update({"b": [5, 6]}, row_ids=[10, 11])
    yield
    d.update({"a": 100}, row_ids=[12, 13, ids[0]])   # a widens to 7 bits
    yield
    d.insert({a: np.resize(v, bitslice.TILE_RECORDS) for a, v in
              take.items()})                         # grows one tile
    yield
    d.compact()
    yield
    live = d.live_ids()
    d.rewrite_rows([int(d.slot_of[live[0]]), d.capacity - 1])
    yield
    d.remap_rows([int(d.slot_of[i]) for i in live[1:3]])
    yield


def test_relation_dml_equals_reference():
    """The same stream through both packages' ``RelationDml`` from the
    same columns: after every step the same plane words, valid words,
    layout and watermark; at the end the same allocator events, wear
    counters, ``MutationStats`` and write programs."""
    pytest.importorskip("jax")
    from repro import dml as rdml
    from repro.core import engine as reng
    from repro.db import compiler as rcompiler
    from repro_torch.db import compiler
    rng = np.random.default_rng(3)
    cols = {"a": rng.integers(0, 50, 300), "b": rng.integers(0, 1000, 300)}
    take = {"a": rng.integers(0, 50, 64), "b": rng.integers(0, 1000, 64)}
    ours = dml.RelationDml(PimRelation.from_columns("t", cols,
                                                    device="cpu"), cols)
    theirs = rdml.RelationDml(reng.PimRelation.from_columns("t", cols), cols)
    for _ in zip(_stream(ours, take, compiler),
                 _stream(theirs, take, rcompiler)):
        assert repr(ours.rel.layout) == repr(theirs.rel.layout)
        assert ours.rel.n_records == theirs.rel.n_records
        assert np.array_equal(eng.to_words(ours.rel.valid),
                              np.asarray(theirs.rel.valid))
        for a, p in theirs.rel.planes.items():
            assert np.array_equal(eng.to_words(ours.rel.planes[a]),
                                  np.asarray(p)), a
        assert ours.slot_of == theirs.slot_of
    assert ours.rel.width_of("a") == 7
    assert ours.segments.grown_tiles == theirs.segments.grown_tiles == 1
    assert [dataclasses.astuple(e) for e in ours.segments.events] == \
        [dataclasses.astuple(e) for e in theirs.segments.events]
    assert np.array_equal(ours.segments.writes, theirs.segments.writes)
    assert [dataclasses.astuple(s) for s in ours.stats] == \
        [dataclasses.astuple(s) for s in theirs.stats]
    assert [(op, [repr(i) for i in instrs]) for op, instrs in ours.programs] \
        == [(op, [repr(i) for i in instrs])
            for op, instrs in theirs.programs]


def _htap_counters(db, rounds=6, replays=4, k=64):
    """``bench_htap_stream``'s traffic without the service: ``replays``
    passes of ``rounds`` rounds, each one ``db.apply([Insert(k rows drawn
    by default_rng(7)), Delete(the previous round's ids)])`` then Q1 and
    Q6 ``filter_only()`` on FUSED, Q6 held to the mutable-table oracle and
    Q1 to the numpy baseline every round."""
    q1 = queries.get_query("Q1").filter_only()
    spec6 = queries.get_query("Q6")
    q6 = spec6.filter_only()
    oracle = dml.MutableTable(db.tables["lineitem"])
    src = {a: np.asarray(c) for a, c in db.tables["lineitem"].items()}
    n0 = oracle.n_rows
    rng = np.random.default_rng(7)
    cells = 0
    for _ in range(replays):
        prev = []
        for _ in range(rounds):
            idx = rng.integers(0, n0, k)
            rows = {a: c[idx] for a, c in src.items()}
            muts = [dml.Insert("lineitem", rows)]
            if prev:
                muts.append(dml.Delete("lineitem", row_ids=prev))
            cells += db.apply(muts)["lineitem"]["cells_written"]
            new_ids = oracle.insert(rows)
            if prev:
                oracle.delete(row_ids=prev)
            prev = new_ids
            r1, r6 = db.execute(q1), db.execute(q6)
            exp = oracle.aggregate(spec6.filters["lineitem"],
                                   spec6.aggregates)
            assert tuple(r6.aggregates["all"][a.name]
                         for a in spec6.aggregates) == exp
            assert r1.aggregates == db.run_baseline(q1).aggregates
    d = db.dml_state("lineitem")
    leveled = d.segments.busiest_row_ops()
    unleveled = dml.replay(d.segments.events,
                           bitslice.pad_words(n0) * bitslice.WORD_BITS, n0,
                           "first_fit").busiest_row_ops()
    rep = db.report(r6)
    return {"cells_written": cells,
            "busiest_row_ops": round(leveled),
            "busiest_row_ops_unleveled": round(unleveled),
            "wear_ratio_x1000": round(leveled / unleveled * 1000),
            "bytes_resident": rep.bytes_resident,
            "bytes_reserved": rep.bytes_reserved,
            "endurance_ops_cell_10y": round(rep.endurance_ops_per_cell_10y)}


def test_htap_stream_counters_match_baseline():
    """``benchmarks/baseline.json``'s ``htap_stream`` DML counters at its
    sf 0.005 (the service's dispatch, plane-read and mutation counters
    wait for the port's serving front end)."""
    base = json.loads((ROOT / "benchmarks/baseline.json").read_text())
    meta = base["rows"]["htap_stream"]["meta"]
    db = PimDatabase(tpch.generate(sf=base["sf"], seed=0), device="cpu")
    got = _htap_counters(db, rounds=meta["rounds"], k=meta["batch"])
    assert got == {key: meta[key] for key in got}
    assert got == {"cells_written": 173312, "busiest_row_ops": 113,
                   "busiest_row_ops_unleveled": 1356,
                   "wear_ratio_x1000": 83, "bytes_resident": 458752,
                   "bytes_reserved": 17024,
                   "endurance_ops_cell_10y": 3117429641471}


def _grow_lineitem(db, dml_mod=dml):
    """Insert one row more than lineitem's spare slots (through
    ``dml_mod``, either package's ``dml``): the planes grow by one tile.
    Returns the word count before."""
    d = db.dml_state("lineitem")
    words0 = d.rel.layout.n_words
    src = {a: np.asarray(c) for a, c in db.tables["lineitem"].items()}
    n = len(next(iter(src.values())))
    idx = np.arange(d.capacity - len(d.slot_of) + 1) % n
    db.apply([dml_mod.Insert("lineitem",
                             {a: c[idx] for a, c in src.items()})])
    return words0


def test_growth_reuses_the_tape():
    """The port's tape-cache signature has no word count (ROADMAP C7): a
    growth by one tile reuses Q6's tape, and Q6 stays equal to ORACLE;
    the reference's executable cache misses once on the same growth."""
    from repro_torch.core import program as prog
    db = PimDatabase(tpch.generate(sf=0.002, seed=0), device="cpu")
    q6 = queries.get_query("Q6").filter_only()
    db.execute(q6)
    words0 = _grow_lineitem(db)
    assert db.relations["lineitem"].layout.n_words == \
        words0 + bitslice.TILE_WORDS
    misses = prog.program_cache_stats()["misses"]
    got = db.execute(q6)
    assert prog.program_cache_stats()["misses"] == misses
    assert got.aggregates == db.execute(q6, engine="oracle").aggregates

    pytest.importorskip("jax")
    from repro import dml as rdml
    from repro.core import program as rprog
    from repro.db import database as rdb
    from repro.db import queries as rqueries
    ref = rdb.PimDatabase(tpch.generate(sf=0.002, seed=0))
    rq6 = rqueries.get_query("Q6").filter_only()
    ref.execute(rq6)
    _grow_lineitem(ref, rdml)
    misses = rprog.program_cache_stats()["misses"]
    assert ref.execute(rq6).aggregates == got.aggregates
    assert rprog.program_cache_stats()["misses"] == misses + 1


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "false")


@pytest.mark.cuda
def test_mutations_on_card_match_oracle_and_cpu():
    """The readback stream on a CUDA relation: every plane stays a CUDA
    tensor, the bits equal the oracle's and the CPU run's, and the write
    primitives count the bytes they move to the card."""
    _needs_card()
    before = eng.upload_bytes
    d = _mutations_match_oracle("cuda")
    assert d.rel.valid.is_cuda
    assert all(p.is_cuda for p in d.rel.planes.values())
    assert eng.upload_bytes > before
    c = _mutations_match_oracle("cpu")
    assert torch.equal(d.rel.valid.cpu(), c.rel.valid)
    for a, p in c.rel.planes.items():
        assert torch.equal(d.rel.planes[a].cpu(), p)


@pytest.mark.cuda
def test_htap_stream_on_card_matches_baseline():
    """The htap stream with lineitem on the card: the same counters as on
    the CPU, Q6 equal to the oracle and Q1 to the baseline every round."""
    _needs_card()
    base = json.loads((ROOT / "benchmarks/baseline.json").read_text())
    meta = base["rows"]["htap_stream"]["meta"]
    db = PimDatabase(tpch.generate(sf=base["sf"], seed=0))
    got = _htap_counters(db, rounds=meta["rounds"], k=meta["batch"])
    assert got == {key: meta[key] for key in got}
    assert db.relations["lineitem"].valid.is_cuda
