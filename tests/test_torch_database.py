"""Port: the whole filter/aggregate slice, and the guards around it.

All 19 TPC-H specs (``spec.filter_only()``) through the port's
``PimDatabase.execute`` on the CPU (the kernel's plain version) equal the
reference's FUSED ``execute`` and the port's ORACLE — every mask and
aggregate exactly. The guards: the port imports neither ``jax`` nor
``repro``; the default device is CUDA and never silently the CPU.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.db import database as tdb
from repro_torch.db import queries as tq
from repro_torch.db import tpch as ttpch

SF, SEED = 0.002, 123
ROOT = Path(__file__).resolve().parents[1]


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
def test_slice_matches_reference_and_oracle(port_db, ref_db, qname):
    from repro.db import queries as rq
    spec = tq.get_query(qname).filter_only()
    fused = port_db.execute(spec)
    oracle = port_db.execute(spec, engine="oracle")
    ref = ref_db.execute(rq.get_query(qname).filter_only())
    assert fused.engine is tdb.Engine.FUSED
    assert oracle.engine is tdb.Engine.ORACLE
    assert list(fused.relations) == list(spec.filters)
    for rel in spec.filters:
        np.testing.assert_array_equal(fused.relations[rel].mask,
                                      oracle.relations[rel].mask, rel)
        np.testing.assert_array_equal(fused.relations[rel].mask,
                                      ref.relations[rel].mask, rel)
        f, r = fused.relations[rel], ref.relations[rel]
        assert (f.agg_plane_reads, f.agg_plane_reads_ungrouped,
                f.n_reduce_jobs) == (r.agg_plane_reads,
                                     r.agg_plane_reads_ungrouped,
                                     r.n_reduce_jobs)
        assert f.filter_attr_bits == r.filter_attr_bits
        assert f.filter_attr_sels == r.filter_attr_sels
        assert [i.cycles() for i in f.trace] == [i.cycles() for i in r.trace]
    assert fused.aggregates == oracle.aggregates == ref.aggregates
    stats = fused.batch_stats
    assert stats["n_dispatches"] == len(spec.filters)
    for rel, st in stats["relations"].items():
        assert st["plane_reads"] == \
            ref.batch_stats["relations"][rel]["plane_reads"]
        assert 0 < st["n_slots"] <= st["tape_len"]


def test_empty_group_aggregates_are_none(port_db):
    """An empty selection: avg, min and max come back as None, sums and
    counts as 0 — on FUSED and ORACLE alike."""
    from repro_torch.db.compiler import Agg, Cmp, Col, Lit
    spec = tq.QuerySpec(
        "Qempty", "full",
        filters={"lineitem": Cmp("gt", Col("l_quantity"), Lit(1000))},
        agg_relation="lineitem",
        aggregates=[Agg("avg", Col("l_quantity"), "a"),
                    Agg("min", Col("l_quantity"), "mn"),
                    Agg("max", Col("l_quantity"), "mx"),
                    Agg("sum", Col("l_quantity"), "s"),
                    Agg("count", None, "c")])
    want = {"all": {"a": None, "mn": None, "mx": None, "s": 0, "c": 0}}
    assert port_db.execute(spec).aggregates == want
    assert port_db.execute(spec, engine=tdb.Engine.ORACLE).aggregates == want
    assert tdb.avg_value(None) is None and tdb.avg_value((7, 2)) == 3.5


def test_batch_mask_on_grown_relation_matches_eager_and_oracle(
        monkeypatch):
    """A FUSED batch's ``QueryView.mask`` on a relation DML has grown
    past a tile (its words hold more records than ``n_records``) equals
    the EAGER engine's ``read_mask`` and the ORACLE's selection: a
    ``(n_records,)`` bool mask, each live row's bit at its slot, the
    other slots clear."""
    from repro_torch import dml
    from repro_torch.core import bitslice
    from repro_torch.core import program as tprog
    db = tdb.PimDatabase(ttpch.generate(sf=SF, seed=SEED + 1), device="cpu")
    li = db.tables["lineitem"]
    n0 = len(next(iter(li.values())))
    idx = np.random.default_rng(SEED).integers(
        0, n0, bitslice.TILE_RECORDS - n0 + 100)
    db.apply([dml.Insert("lineitem", {a: np.asarray(c)[idx]
                                      for a, c in li.items()}),
              dml.Delete("lineitem", row_ids=list(range(0, 300, 3)))])
    rel = db.relations["lineitem"]
    n = rel.n_records
    assert n > bitslice.TILE_RECORDS
    assert rel.layout.capacity_records > n

    seen = []
    real = tprog.QueryView.mask

    def spy(self, name, n_records=None):
        out = real(self, name, n_records)
        seen.append(out)
        return out
    monkeypatch.setattr(tprog.QueryView, "mask", spy)
    specs = [tq.get_query(q).filter_only() for q in ("Q6", "Q1")]
    pendings, _ = db.dispatch_batch(specs)
    assert len(seen) == len(specs)
    d = db.dml_state("lineitem")
    slots = np.asarray([d.slot_of[i] for i in d.live_ids()], np.int64)
    for spec, pending, mask in zip(specs, pendings, seen):
        assert mask.dtype == np.bool_ and mask.shape == (n,)
        assert pending.result.relations["lineitem"].mask is mask
        eager = db.execute(spec, engine="eager").relations["lineitem"].mask
        np.testing.assert_array_equal(mask, eager, spec.name)
        oracle = db.execute(spec, engine="oracle").relations["lineitem"].mask
        np.testing.assert_array_equal(mask[slots], oracle, spec.name)
        assert mask.sum() == oracle.sum() > 0


# --------------------------------------------------------------------------
# Guards
# --------------------------------------------------------------------------
def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_repro():
    files = _port_sources()
    assert len(files) > 10 and (ROOT / "chip_smoke.py").exists()
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), \
                    f"{path.relative_to(ROOT)}:{node.lineno} imports {name}"


def test_default_device_is_cuda(tables):
    """No device means CUDA: without one, construction raises instead of
    quietly running on the CPU."""
    if torch.cuda.is_available():
        assert tdb.PimDatabase(tables).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tdb.PimDatabase(tables)


def test_unported_scopes_raise(port_db):
    """Every single spec now runs, on FUSED (here) and EAGER
    (``test_torch_eager.py``) alike: the host-stage specs end to end,
    equal to the ORACLE's rows. A list of specs no longer raises: it runs
    as one linked batch whose results equal the specs run one at a time
    (``test_torch_fusion.py`` holds batches against the reference)."""
    host_specs = [q for q in tq.all_queries() if q.host is not None]
    assert {q.name for q in host_specs} == {"Q3", "Q5", "Q10", "Q12", "Q14",
                                            "Q19"}
    for spec in host_specs:
        fused = port_db.execute(spec)
        oracle = port_db.execute(spec, engine=tdb.Engine.ORACLE)
        assert fused.columns == oracle.columns == spec.host.output
        assert fused.rows == oracle.rows, spec.name
        assert fused.materialized_rows == oracle.materialized_rows
    specs = [tq.get_query("Q6"), tq.get_query("Q1")]
    batch = port_db.execute(specs)
    assert port_db.last_batch_stats["n_dispatches"] == 1
    for spec, got in zip(specs, batch):
        assert got.aggregates == port_db.execute(spec).aggregates


# --------------------------------------------------------------------------
# The selectivity model's fallback
# --------------------------------------------------------------------------
def _raise_on(monkeypatch, queries_mod, bad):
    """Patch ``queries_mod.eval_pred`` to raise for the conjunct ``bad``
    (by identity) and evaluate everything else as before."""
    real = queries_mod.eval_pred

    def eval_pred(cols, p):
        if p is bad:
            raise TypeError("conjunct not evaluable on the host")
        return real(cols, p)
    monkeypatch.setattr(queries_mod, "eval_pred", eval_pred)


def test_conjunct_selectivity_falls_back_like_reference(tables,
                                                        monkeypatch):
    """A conjunct whose host ``eval_pred`` raises counts as selectivity
    1.0 in both packages; the other conjuncts keep their fractions."""
    pytest.importorskip("jax")
    from repro.db import database as rdb
    from repro.db import queries as rq
    cols = tables["lineitem"]
    n = len(next(iter(cols.values())))
    port_pred = tq.get_query("Q6").filter_only().filters["lineitem"]
    ref_pred = rq.get_query("Q6").filter_only().filters["lineitem"]
    assert len(port_pred.ps) == 4
    clean = tdb._conjunct_selectivities(cols, port_pred)
    assert clean == rdb._conjunct_selectivities(cols, ref_pred, n)
    _raise_on(monkeypatch, tq, port_pred.ps[2])
    _raise_on(monkeypatch, rq, ref_pred.ps[2])
    got = tdb._conjunct_selectivities(cols, port_pred)
    want = rdb._conjunct_selectivities(cols, ref_pred, n)
    assert got == want
    assert got[2] == 1.0 and clean[2] < 1.0
    assert got[:2] + got[3:] == clean[:2] + clean[3:]


def test_execute_survives_a_conjunct_the_host_cannot_evaluate(
        port_db, monkeypatch):
    """FUSED ``execute`` of Q6 returns the same masks and aggregates with
    one conjunct's host evaluation raising; only that conjunct's modelled
    selectivity becomes 1.0."""
    spec = tq.get_query("Q6").filter_only()
    clean = port_db.execute(spec)
    _raise_on(monkeypatch, tq, spec.filters["lineitem"].ps[2])
    got = port_db.execute(spec)
    np.testing.assert_array_equal(got.relations["lineitem"].mask,
                                  clean.relations["lineitem"].mask)
    assert got.aggregates == clean.aggregates
    sels = got.relations["lineitem"].filter_attr_sels
    want = list(clean.relations["lineitem"].filter_attr_sels)
    want[2] = 1.0
    assert sels == want
