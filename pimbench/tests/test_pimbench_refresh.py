"""RF1/RF2 replayed by the program and by the reference's own copy agree:
the rows each refresh changes, the live rows after it, and the answers
of queries over the mutated relations."""
import numpy as np

from pimbench import adapter, compare, reference, templates
from pimbench.refresh import MUTABLE, VersionedTables
from pimbench.tests import _small


def _rows(cols):
    keys = sorted(cols)
    return sorted(zip(*[np.asarray(cols[k]).tolist() for k in keys]))


def test_refresh_pairs_replayed_by_both_sides_agree():
    from repro_torch.db.database import PimDatabase
    t = _small.tables()
    db = PimDatabase({r: dict(c) for r, c in t.items()}, device="cpu")
    # 300 orders a refresh, a tenth of the 3,000 that sf 0.002 holds.
    stream = VersionedTables(t, _small.SF, _small.SEED, orders_per_sf=150_000)
    tq = {n: templates.load_template(n) for n in ("Q1", "Q6", "Q21")}
    rng = np.random.default_rng(5)
    for k in range(1, 5):
        rf = stream.make(k)
        assert rf["kind"] == ("RF1" if k % 2 else "RF2")
        st = db.apply(adapter.refresh_mutations(rf))
        assert sum(s["n_rows"] for s in st.values()) == rf["n_rows"] > 0
        tables, live = stream.view(k)
        slots = {}
        for rel in MUTABLE:
            ref = {c: v[live[rel]] for c, v in tables[rel].items()}
            assert _rows(db.tables[rel]) == _rows(ref)
            slots[rel], wrong = compare.locate(
                tables[rel], len(t[rel]["o_orderkey" if rel == "orders"
                                       else "l_orderkey"]),
                live[rel], *adapter.stored_rows(db, rel))
            assert wrong == 0, (k, rel)
        stale = []
        for name, tmpl in tq.items():
            q = templates.bind(tmpl, "pim", templates.draw_params(tmpl, rng))
            got = adapter.answer(q, db.execute(adapter.query_spec(q)))
            d = compare.diff(got, reference.evaluate(q, tables, live), slots)
            assert not any(d.values()), (k, name, d)
            old = reference.evaluate(q, *stream.view(k - 1))
            stale.append(any(compare.diff(got, old, slots).values()))
        assert any(stale), k           # the comparison sees the refresh


def test_refresh_data_is_a_function_of_seed_and_number():
    t = _small.tables()
    a = VersionedTables(t, _small.SF, 9).make(1)
    b = VersionedTables(t, _small.SF, 9).make(1)
    for rel in a["rows"]:
        for c in a["rows"][rel]:
            assert np.array_equal(a["rows"][rel][c], b["rows"][rel][c])
    n = a["rows"]["orders"]["o_orderkey"]
    assert n.min() > t["orders"]["o_orderkey"].max()
    per = np.bincount(a["rows"]["lineitem"]["l_orderkey"] - n.min())
    assert per.min() >= 1 and per.max() <= 7
