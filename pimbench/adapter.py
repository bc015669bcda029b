"""Render bound templates and refresh functions into the program's API.

The one place where the benchmark speaks the program's language: a
:class:`~pimbench.templates.BoundQuery` becomes a ``QuerySpec`` of
``repro_torch.db.queries`` (predicates and expressions from
``repro_torch.db.compiler``, host plan nodes from ``repro_torch.db.exec``),
a refresh function becomes ``repro_torch.dml`` mutations, a
``QueryResult`` is read back into the plain answer the comparison uses,
and a relation's bit-planes are read back into the rows it stores.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch import dml
from repro_torch.db import compiler as C
from repro_torch.db import exec as E
from repro_torch.db import queries as Q

from .templates import BoundQuery, is_pred


def pred(p: dict):
    if "cmp" in p:
        right = C.Col(p["col2"]) if "col2" in p else C.Lit(int(p["value"]))
        return C.Cmp(p["cmp"], C.Col(p["col"]), right)
    if "between" in p:
        return C.Between(C.Col(p["between"]), int(p["lo"]), int(p["hi"]))
    if "in" in p:
        return C.InSet(C.Col(p["in"]), tuple(int(v) for v in p["values"]))
    if "not" in p:
        return C.Not(pred(p["not"]))
    if "and" in p:
        return C.And(*[pred(q) for q in p["and"]])
    if "or" in p:
        return C.Or(*[pred(q) for q in p["or"]])
    raise ValueError(p)


def expr(e: dict):
    if "col" in e:
        return C.Col(e["col"])
    if "lit" in e:
        return C.Lit(int(e["lit"]))
    if "mul" in e:
        return C.Mul(expr(e["mul"][0]), expr(e["mul"][1]))
    if "add" in e:
        return C.AddE(expr(e["add"][0]), expr(e["add"][1]))
    if "rsub" in e:
        return C.RSubImm(int(e["rsub"][0]), expr(e["rsub"][1]))
    raise ValueError(e)


def plan(n: dict):
    if "scan" in n:
        return E.PimScan(n["scan"], tuple(n["columns"]))
    if "join" in n:
        return E.HashJoin(plan(n["join"][0]), plan(n["join"][1]),
                          n["keys"][0], n["keys"][1])
    if "filter" in n:
        return E.Filter(plan(n["filter"]), pred(n["pred"]))
    if "project" in n:
        return E.Project(plan(n["project"]), tuple(
            (name, pred(x) if is_pred(x) else expr(x))
            for name, x in n["exprs"]))
    if "group" in n:
        return E.GroupAgg(plan(n["group"]), tuple(n["keys"]), tuple(
            E.HostAgg(name, op, col) for name, op, col in n["aggs"]))
    if "order" in n:
        return E.OrderLimit(plan(n["order"]),
                            tuple((c, bool(d)) for c, d in n["keys"]),
                            n["limit"])
    raise ValueError(n)


def query_spec(q: BoundQuery) -> Q.QuerySpec:
    """The program's ``QuerySpec`` of one bound query."""
    spec = Q.QuerySpec(q.name, q.kind, {r: pred(p) for r, p in q.filters})
    if q.kind == "full":
        spec.agg_relation = q.agg_relation
        spec.aggregates = [C.Agg(a["op"], None if a["expr"] is None
                                 else expr(a["expr"]), a["name"])
                           for a in q.aggregates]
        if q.groups is not None:
            spec.groups = [(label, pred(g)) for label, g in q.groups]
    if q.scope == "end_to_end":
        spec.host = E.HostStage(plan(q.host["root"]),
                                tuple(q.host["output"]))
    return spec


def answer(q: BoundQuery, res) -> Dict[str, object]:
    """The plain answer of a ``QueryResult``: masks and aggregates in the
    paper's scope, result rows end to end."""
    if q.scope == "end_to_end":
        return {"columns": tuple(res.columns), "rows": list(res.rows)}
    return {"masks": {r: np.asarray(rr.mask, bool)
                      for r, rr in res.relations.items()},
            "aggs": res.aggregates}


def refresh_mutations(rf: dict) -> List[object]:
    """``repro_torch.dml`` mutations of one refresh function (``refresh``
    module): RF1 inserts its orders and their lineitems, RF2 deletes a
    range of order keys from both relations."""
    if rf["kind"] == "RF1":
        return [dml.Insert(rel, {a: v for a, v in cols.items()})
                for rel, cols in rf["rows"].items()]
    lo, hi = rf["keys"]
    return [dml.Delete("orders", pred=C.Between(C.Col("o_orderkey"), lo, hi)),
            dml.Delete("lineitem",
                       pred=C.Between(C.Col("l_orderkey"), lo, hi))]


def _unpack(planes: np.ndarray, n: int) -> np.ndarray:
    """Values of records ``[0, n)`` of (n_bits, words) int32 bit-planes:
    bit ``b`` of record ``r`` is bit ``r % 32`` of word ``r // 32`` of
    plane ``b``."""
    words = np.ascontiguousarray(planes).view(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    out = np.zeros((words.shape[1], 32), np.uint32)
    for b in range(words.shape[0]):
        out |= ((words[b, :, None] >> shifts) & np.uint32(1)) << np.uint32(b)
    return out.ravel()[:n].astype(np.int64)


def stored_rows(db, rel: str):
    """The rows the program stores for ``rel`` on its device, slot by slot
    up to the relation's watermark, read back from the bit-planes:
    ``({column: values}, valid)``."""
    r = db.relations[rel]
    n = int(r.n_records)
    cols = {a: _unpack(p.cpu().numpy(), n) for a, p in r.planes.items()}
    valid = _unpack(r.valid.cpu().numpy()[None], n).astype(bool)
    return cols, valid
