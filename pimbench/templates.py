"""Query templates as data: loading, substitution parameters, binding.

A template is ``pimbench/queries/<name>.json``. It states a TPC-H query's
relation filters, its aggregates (with group predicates) and, for the
queries that run end to end, its host plan (scans, joins, residual
filters, projections, group-by, order and limit), with the substitution
parameters of TPC-H Clause 2.4 as named draws. :func:`bind` draws the
parameters from a NumPy generator and resolves every literal, giving a
:class:`BoundQuery` that holds only integers. The adapter
(``adapter.py``) renders a bound query into the program's ``QuerySpec``;
the reference (``reference.py``) evaluates the same bound query with
NumPy. Nothing here imports the program.

JSON forms of a bound tree (literals already integers):

* predicates: ``{"cmp": op, "col": c, "value": v}``,
  ``{"cmp": op, "col": c, "col2": c2}``, ``{"between": c, "lo": v,
  "hi": v}`` (inclusive), ``{"in": c, "values": [v, ...]}``,
  ``{"not": p}``, ``{"and": [p, ...]}``, ``{"or": [p, ...]}``;
  ``op`` is one of eq ne lt le gt ge;
* expressions: ``{"col": c}``, ``{"lit": v}``, ``{"mul": [e, e]}``,
  ``{"add": [e, e]}``, ``{"rsub": [v, e]}`` (v minus e);
* host plan nodes: ``{"scan": rel, "columns": [...]}``, ``{"join":
  [left, right], "keys": [lk, rk]}`` (inner equi-join), ``{"filter":
  child, "pred": p}``, ``{"project": child, "exprs": [[name, e_or_p],
  ...]}`` (a predicate yields a 0/1 column), ``{"group": child, "keys":
  [...], "aggs": [[name, op, col], ...]}``, ``{"order": child, "keys":
  [[col, descending], ...], "limit": n_or_null}``.

Literal forms in a template: an integer; ``{"param": name}`` with an
optional ``"months": m`` (date parameters: add calendar months first) and
``"plus": k``; ``{"date": "YYYY-MM-DD"}``; ``{"vocab": V, "value": s}``
(index in a ``tpch_schema.VOCABS`` list); ``{"container": "SM CASE"}``;
``{"type": "PROMO ANODIZED TIN"}``. An ``in`` list is a list of literals
or one ``{"param": name}`` whose value is a list.

Parameter kinds: ``int`` (uniform in [lo, hi]), ``choice`` (an index
into ``vocab``), ``sample`` (``k`` distinct of [lo, hi]),
``region_nations`` (the nation keys of one uniformly drawn region),
``day`` (a day in [from, to]), ``month`` (the
first day of a month in [from, to], "YYYY-MM"), ``year`` (1 January of a
year in [from, to]), ``days_before`` (``date`` minus a number of days in
[lo, hi]). Dates are kept as ISO strings and become day offsets from
1992-01-01 (the schema's encoding) where a literal reads them.
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import tpch_schema as S

QUERY_DIR = Path(__file__).resolve().parent / "queries"

PRED_KEYS = ("cmp", "between", "in", "not", "and", "or")
SCOPES = ("pim", "end_to_end")


@dataclasses.dataclass(frozen=True)
class BoundQuery:
    """One submission: a template with its parameters drawn and every
    literal resolved. ``scope`` is ``"pim"`` (relation filters, and the
    aggregates of a full query: the paper's scope) or ``"end_to_end"``
    (the filters feed the host plan, whose result rows are the answer)."""
    name: str
    scope: str
    kind: str                                   # "full" | "filter"
    params: Tuple[Tuple[str, object], ...]
    filters: Tuple[Tuple[str, dict], ...]       # (relation, predicate)
    agg_relation: Optional[str] = None
    aggregates: Tuple[dict, ...] = ()           # {"op", "expr", "name"}
    groups: Optional[Tuple[Tuple[str, dict], ...]] = None
    host: Optional[dict] = None                 # {"root": node, "output"}

    @property
    def key(self) -> str:
        """Identity of the answer: template, scope and parameters."""
        return json.dumps([self.name, self.scope, list(self.params)],
                          sort_keys=True)

    def relations(self) -> Tuple[str, ...]:
        """The relations whose filter or scan the query reads on the
        device: the filtered ones, and in end-to-end scope every scanned
        relation of the host plan."""
        rels = [r for r, _ in self.filters]
        if self.scope == "end_to_end":
            for node in walk_plan(self.host["root"]):
                if "scan" in node and node["scan"] not in rels:
                    rels.append(node["scan"])
        return tuple(rels)


def load_template(name: str, query_dir: Path = QUERY_DIR) -> dict:
    with open(query_dir / f"{name}.json") as f:
        t = json.load(f)
    if t["name"] != name:
        raise ValueError(f"{name}.json names itself {t['name']!r}")
    return t


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------
def _iso(d: _dt.date) -> str:
    return d.isoformat()


def _month_index(ym: str) -> int:
    y, m = map(int, ym.split("-"))
    return y * 12 + (m - 1)


def draw_params(template: dict, rng: np.random.Generator) -> Dict[str, object]:
    """Draw every parameter of ``template`` in its listed order."""
    out: Dict[str, object] = {}
    for pname, p in template.get("params", {}).items():
        kind = p["kind"]
        if kind == "int":
            out[pname] = int(rng.integers(p["lo"], p["hi"] + 1))
        elif kind == "choice":
            out[pname] = int(rng.integers(0, len(S.VOCABS[p["vocab"]])))
        elif kind == "sample":
            idx = rng.choice(p["hi"] - p["lo"] + 1, size=p["k"], replace=False)
            out[pname] = [p["lo"] + int(i) for i in idx]
        elif kind == "region_nations":
            r = S.REGIONS[int(rng.integers(0, len(S.REGIONS)))]
            out[pname] = list(S.NATIONS_IN_REGION[r])
        elif kind == "day":
            lo = _dt.date.fromisoformat(p["from"])
            hi = _dt.date.fromisoformat(p["to"])
            off = int(rng.integers(0, (hi - lo).days + 1))
            out[pname] = _iso(lo + _dt.timedelta(days=off))
        elif kind == "month":
            lo, hi = _month_index(p["from"]), _month_index(p["to"])
            mi = int(rng.integers(lo, hi + 1))
            out[pname] = _iso(_dt.date(mi // 12, mi % 12 + 1, 1))
        elif kind == "year":
            out[pname] = _iso(_dt.date(int(rng.integers(p["from"],
                                                        p["to"] + 1)), 1, 1))
        elif kind == "days_before":
            delta = int(rng.integers(p["lo"], p["hi"] + 1))
            out[pname] = _iso(_dt.date.fromisoformat(p["date"])
                              - _dt.timedelta(days=delta))
        else:
            raise ValueError(f"unknown parameter kind {kind!r}")
    return out


def _add_months(iso: str, months: int) -> str:
    d = _dt.date.fromisoformat(iso)
    mi = d.year * 12 + (d.month - 1) + months
    return _iso(_dt.date(mi // 12, mi % 12 + 1, d.day))


def resolve(lit, params: Dict[str, object]):
    """A template literal -> an int (or a list of ints)."""
    if isinstance(lit, bool):
        raise ValueError("boolean literal")
    if isinstance(lit, int):
        return lit
    if isinstance(lit, list):
        return [resolve(x, params) for x in lit]
    if not isinstance(lit, dict):
        raise ValueError(f"bad literal {lit!r}")
    if "param" in lit:
        v = params[lit["param"]]
        if isinstance(v, str):                  # an ISO date
            v = S.date_to_days(_add_months(v, lit.get("months", 0)))
        elif "months" in lit:
            raise ValueError(f"months on a non-date parameter {lit!r}")
        if isinstance(v, list):
            if "plus" in lit:
                raise ValueError(f"plus on a list parameter {lit!r}")
            return [int(x) for x in v]
        return int(v) + lit.get("plus", 0)
    if "date" in lit:
        return S.date_to_days(lit["date"])
    if "vocab" in lit:
        return S.VOCABS[lit["vocab"]].index(lit["value"])
    if "container" in lit:
        return S.container_name_to_id(lit["container"])
    if "type" in lit:
        return S.type_name_to_id(lit["type"])
    raise ValueError(f"bad literal {lit!r}")


def bind_pred(p: dict, params) -> dict:
    if "cmp" in p:
        out = {"cmp": p["cmp"], "col": p["col"]}
        if "col2" in p:
            out["col2"] = p["col2"]
        else:
            out["value"] = resolve(p["value"], params)
        return out
    if "between" in p:
        return {"between": p["between"], "lo": resolve(p["lo"], params),
                "hi": resolve(p["hi"], params)}
    if "in" in p:
        vals = p["values"]
        vals = resolve(vals, params)
        return {"in": p["in"], "values": [int(v) for v in vals]}
    if "not" in p:
        return {"not": bind_pred(p["not"], params)}
    if "and" in p:
        return {"and": [bind_pred(q, params) for q in p["and"]]}
    if "or" in p:
        return {"or": [bind_pred(q, params) for q in p["or"]]}
    raise ValueError(f"bad predicate {p!r}")


def bind_expr(e: dict, params) -> dict:
    if "col" in e:
        return {"col": e["col"]}
    if "lit" in e:
        return {"lit": resolve(e["lit"], params)}
    if "mul" in e:
        return {"mul": [bind_expr(x, params) for x in e["mul"]]}
    if "add" in e:
        return {"add": [bind_expr(x, params) for x in e["add"]]}
    if "rsub" in e:
        return {"rsub": [resolve(e["rsub"][0], params),
                         bind_expr(e["rsub"][1], params)]}
    raise ValueError(f"bad expression {e!r}")


def is_pred(x: dict) -> bool:
    return any(k in x for k in PRED_KEYS)


def bind_node(n: dict, params) -> dict:
    if "scan" in n:
        return {"scan": n["scan"], "columns": list(n["columns"])}
    if "join" in n:
        return {"join": [bind_node(c, params) for c in n["join"]],
                "keys": list(n["keys"])}
    if "filter" in n:
        return {"filter": bind_node(n["filter"], params),
                "pred": bind_pred(n["pred"], params)}
    if "project" in n:
        return {"project": bind_node(n["project"], params),
                "exprs": [[name, bind_pred(x, params) if is_pred(x)
                           else bind_expr(x, params)]
                          for name, x in n["exprs"]]}
    if "group" in n:
        return {"group": bind_node(n["group"], params),
                "keys": list(n["keys"]),
                "aggs": [list(a) for a in n["aggs"]]}
    if "order" in n:
        return {"order": bind_node(n["order"], params),
                "keys": [list(k) for k in n["keys"]],
                "limit": n.get("limit")}
    raise ValueError(f"bad plan node {n!r}")


def walk_plan(n: dict):
    yield n
    for k in ("join",):
        if k in n:
            for c in n[k]:
                yield from walk_plan(c)
    for k in ("filter", "project", "group", "order"):
        if k in n:
            yield from walk_plan(n[k])


def bind(template: dict, scope: str, params: Dict[str, object]) -> BoundQuery:
    """Resolve ``template`` under ``params`` into a :class:`BoundQuery`."""
    if scope not in SCOPES:
        raise ValueError(f"scope {scope!r}")
    if scope == "end_to_end" and "host" not in template:
        raise ValueError(f"{template['name']} has no host plan")
    filters = tuple((rel, bind_pred(p, params))
                    for rel, p in template["filters"].items())
    aggs: Tuple[dict, ...] = ()
    groups = None
    if template["kind"] == "full":
        aggs = tuple({"op": a["op"], "name": a["name"],
                      "expr": (bind_expr(a["expr"], params)
                               if a.get("expr") is not None else None)}
                     for a in template["aggregates"])
        if template.get("groups"):
            groups = tuple((g["label"], bind_pred(g["pred"], params))
                           for g in template["groups"])
    host = None
    if scope == "end_to_end":
        host = {"root": bind_node(template["host"]["root"], params),
                "output": list(template["host"]["output"])}
    return BoundQuery(
        name=template["name"], scope=scope, kind=template["kind"],
        params=tuple(sorted(params.items())), filters=filters,
        agg_relation=template.get("agg_relation"), aggregates=aggs,
        groups=groups, host=host)


def pred_columns(p: dict) -> List[str]:
    """Columns a bound predicate reads, in first-use order."""
    out: List[str] = []

    def walk(q):
        if "cmp" in q:
            out.append(q["col"])
            if "col2" in q:
                out.append(q["col2"])
        elif "between" in q:
            out.append(q["between"])
        elif "in" in q:
            out.append(q["in"])
        elif "not" in q:
            walk(q["not"])
        else:
            for c in q.get("and", q.get("or", [])):
                walk(c)

    walk(p)
    return list(dict.fromkeys(out))


def expr_columns(e: dict) -> List[str]:
    out: List[str] = []

    def walk(x):
        if "col" in x:
            out.append(x["col"])
        elif "mul" in x or "add" in x:
            for c in x.get("mul", x.get("add")):
                walk(c)
        elif "rsub" in x:
            walk(x["rsub"][1])

    walk(e)
    return list(dict.fromkeys(out))
