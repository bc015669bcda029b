"""Every template, rendered into the program's QuerySpec and run on the
CPU, equals the plain reference; at the Clause 2.4 validation parameters
it also equals the program's own spec of the query."""
import numpy as np
import pytest

from pimbench import adapter, compare, reference, templates
from pimbench.tests import _small

NAMES = sorted(p.stem for p in templates.QUERY_DIR.glob("*.json"))
CASES = [(n, "pim") for n in NAMES] + [
    (n, "end_to_end") for n in NAMES if "host" in templates.load_template(n)]


@pytest.fixture(scope="module")
def db():
    from repro_torch.db.database import PimDatabase
    t = _small.tables()
    return PimDatabase({r: dict(c) for r, c in t.items()}, device="cpu")


def _assert_same(got, ref):
    assert compare.diff(got, ref) == {
        "mask_bits_wrong": 0, "agg_wrong": 0, "rows_wrong": 0}


def test_every_mix_names_templates_that_exist_in_a_scope_they_have():
    import json
    for path in sorted((templates.QUERY_DIR.parent / "traffic").glob("*.json")):
        mix = json.loads(path.read_text())
        for entry in mix["templates"]:
            assert (entry["query"], entry["scope"]) in CASES, (path, entry)


@pytest.mark.parametrize("name,scope", CASES)
def test_template_at_drawn_parameters_equals_the_reference(db, name, scope):
    t = templates.load_template(name)
    rng = np.random.default_rng([_small.SEED, len(name)])
    for _ in range(3):
        q = templates.bind(t, scope, templates.draw_params(t, rng))
        got = adapter.answer(q, db.execute(adapter.query_spec(q)))
        _assert_same(got, reference.evaluate(q, _small.tables()))


@pytest.mark.parametrize("name,scope", CASES)
def test_template_at_validation_parameters_equals_the_programs_query(
        db, name, scope):
    from repro_torch.db import queries as Q
    t = templates.load_template(name)
    q = templates.bind(t, scope, t["validation"])
    spec = Q.get_query(name)
    if scope == "pim":
        spec = spec.filter_only()
    own = adapter.answer(q, db.execute(spec))
    _assert_same(own, reference.evaluate(q, _small.tables()))
    _assert_same(adapter.answer(q, db.execute(adapter.query_spec(q))),
                 reference.evaluate(q, _small.tables()))


def test_parameters_stay_inside_their_clause_ranges():
    rng = np.random.default_rng(_small.SEED)
    seen = set()
    for _ in range(200):
        p = templates.draw_params(templates.load_template("Q6"), rng)
        assert "1993-01-01" <= p["date"] <= "1997-01-01"
        assert p["date"].endswith("-01-01")
        assert 2 <= p["discount"] <= 9 and p["quantity"] in (24, 25)
        seen.add((p["date"], p["discount"], p["quantity"]))
    assert len(seen) > 40
    for _ in range(50):
        p = templates.draw_params(templates.load_template("Q16"), rng)
        assert len(set(p["sizes"])) == 8 and min(p["sizes"]) >= 1
        p = templates.draw_params(templates.load_template("Q1"), rng)
        assert "1998-08-03" <= p["cutoff"] <= "1998-10-02"


def test_reference_sums_are_exact_beyond_int64_partials():
    v = np.full(10, 2 ** 61, np.int64)
    assert reference.exact_sum(v) == 10 * 2 ** 61
    assert reference.exact_sum(np.array([], np.int64)) == 0
