"""The plain reference: a bound query evaluated with NumPy alone.

It reads the generated columns (and, for the refresh cell, which rows are
live at a given state) and the bound template, and nothing the program
made. Integer arithmetic is exact: sums are taken in int64 where the
largest possible total fits and in Python integers where it may not; a
product that could leave int64 raises rather than wrap.

The answer of a query in the paper's scope is ``{"masks": {relation:
bool array}, "aggs": {group: {name: value}}}``: ``count`` and ``sum`` are
ints, ``avg`` the exact ``(sum, count)`` pair (``None`` for an empty
group), ``min``/``max`` ints (``None`` when empty). End to end it is
``{"columns": (...), "rows": [tuple, ...]}``, the host plan's result,
with ``"selected"``: the rows each scanned relation hands the host.

``precision="float32"`` computes every expression and sum in float32
instead: the control, a reference that breaks the configuration's
exactness guarantee (see ``control.py``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .templates import BoundQuery, is_pred

_I63 = 2 ** 62


class Ctx:
    """Evaluation context: the columns and the arithmetic."""

    def __init__(self, precision: str = "exact"):
        if precision not in ("exact", "float32"):
            raise ValueError(precision)
        self.f32 = precision == "float32"

    # -- expressions --------------------------------------------------------
    def expr(self, cols: Dict[str, np.ndarray], e: dict):
        if "col" in e:
            v = cols[e["col"]]
            return v.astype(np.float32) if self.f32 else v.astype(np.int64, copy=False)
        if "lit" in e:
            return np.float32(e["lit"]) if self.f32 else np.int64(e["lit"])
        if "mul" in e:
            a, b = (self.expr(cols, x) for x in e["mul"])
            if not self.f32:
                _check_fits(a, b)
            return a * b
        if "add" in e:
            a, b = (self.expr(cols, x) for x in e["add"])
            return a + b
        if "rsub" in e:
            imm = np.float32(e["rsub"][0]) if self.f32 else np.int64(e["rsub"][0])
            return imm - self.expr(cols, e["rsub"][1])
        raise ValueError(e)

    def total(self, v):
        if self.f32:
            return float(np.sum(np.asarray(v, np.float32), dtype=np.float32))
        return exact_sum(v)

    # -- predicates ---------------------------------------------------------
    def pred(self, cols: Dict[str, np.ndarray], p: dict) -> np.ndarray:
        if "cmp" in p:
            a = cols[p["col"]]
            b = cols[p["col2"]] if "col2" in p else np.int64(p["value"])
            op = p["cmp"]
            if op == "eq":
                return a == b
            if op == "ne":
                return a != b
            if op == "lt":
                return a < b
            if op == "le":
                return a <= b
            if op == "gt":
                return a > b
            if op == "ge":
                return a >= b
            raise ValueError(op)
        if "between" in p:
            a = cols[p["between"]]
            return (a >= p["lo"]) & (a <= p["hi"])
        if "in" in p:
            a = cols[p["in"]]
            out = np.zeros(a.shape, bool)
            for v in p["values"]:
                out |= a == v
            return out
        if "not" in p:
            return ~self.pred(cols, p["not"])
        if "and" in p:
            out = self.pred(cols, p["and"][0])
            for q in p["and"][1:]:
                out &= self.pred(cols, q)
            return out
        if "or" in p:
            out = self.pred(cols, p["or"][0])
            for q in p["or"][1:]:
                out |= self.pred(cols, q)
            return out
        raise ValueError(p)


def exact_sum(v) -> int:
    """The exact integer sum of an int64 array."""
    v = np.asarray(v)
    if v.size == 0:
        return 0
    m = int(np.abs(v).max())
    if m == 0:
        return 0
    step = max(1, _I63 // m)
    if step >= v.size:
        return int(v.sum(dtype=np.int64))
    return sum(int(v[i:i + step].sum(dtype=np.int64))
               for i in range(0, v.size, step))


def _absmax(x) -> int:
    a = np.asarray(x)
    return int(np.abs(a).max()) if a.size else 0


def _check_fits(a, b) -> None:
    if _absmax(a) * _absmax(b) >= 2 ** 63:
        raise OverflowError("a product of the query could leave int64")


# --------------------------------------------------------------------------
# The paper's scope: masks and aggregates
# --------------------------------------------------------------------------
def _aggregate(ctx: Ctx, cols, mask: np.ndarray, a: dict):
    op = a["op"]
    n = int(np.count_nonzero(mask))
    if op == "count":
        return n
    vals = ctx.expr(cols, a["expr"])
    vals = np.broadcast_to(vals, mask.shape)[mask]
    if op == "sum":
        return ctx.total(vals)
    if op == "avg":
        return None if n == 0 else (ctx.total(vals), n)
    if op in ("min", "max"):
        if n == 0:
            return None
        v = vals.min() if op == "min" else vals.max()
        return float(v) if ctx.f32 else int(v)
    raise ValueError(op)


def _scope_answer(ctx: Ctx, q: BoundQuery, tables, live) -> dict:
    masks: Dict[str, np.ndarray] = {}
    aggs: Dict[str, Dict[str, object]] = {}
    for rel, p in q.filters:
        cols = tables[rel]
        m = ctx.pred(cols, p)
        if live is not None and rel in live:
            m &= live[rel]
        masks[rel] = m
        if q.kind == "full" and rel == q.agg_relation:
            for label, g in (q.groups or (("all", None),)):
                gm = m if g is None else m & ctx.pred(cols, g)
                aggs[label] = {a["name"]: _aggregate(ctx, cols, gm, a)
                               for a in q.aggregates}
    return {"masks": masks, "aggs": aggs}


# --------------------------------------------------------------------------
# End to end: the host plan
# --------------------------------------------------------------------------
def _take(t: Dict[str, np.ndarray], idx) -> Dict[str, np.ndarray]:
    return {k: v[idx] for k, v in t.items()}


def _n(t: Dict[str, np.ndarray]) -> int:
    return int(next(iter(t.values())).shape[0]) if t else 0


def _unique_index(keys: np.ndarray) -> Optional[np.ndarray]:
    """A dense key -> row table when ``keys`` are distinct non-negative
    ints, else None."""
    if keys.size == 0:
        return np.full(1, -1, np.int64)
    if keys.min() < 0 or keys.max() > 64 * keys.size + 1_000_000:
        return None
    table = np.full(int(keys.max()) + 1, -1, np.int64)
    table[keys] = np.arange(keys.size)
    if np.count_nonzero(table >= 0) != keys.size:
        return None                          # a repeated key
    return table


def _probe(table: np.ndarray, keys: np.ndarray):
    """(probe rows, build rows) of the matches of ``keys`` in ``table``."""
    inside = (keys >= 0) & (keys < table.size)
    hit = np.full(keys.shape, -1, np.int64)
    hit[inside] = table[keys[inside]]
    probe = np.flatnonzero(hit >= 0)
    return probe, hit[probe]


def _join(lt, rt, lk, rk):
    clash = set(lt) & set(rt)
    if clash:
        raise ValueError(f"join columns on both sides: {sorted(clash)}")
    lv, rv = lt[lk], rt[rk]
    table = _unique_index(rv)
    if table is not None:
        li, ri = _probe(table, lv)
    else:
        table = _unique_index(lv)
        if table is None:
            raise ValueError("join with repeated keys on both sides")
        ri, li = _probe(table, rv)
    out = _take(lt, li)
    out.update(_take(rt, ri))
    return out


def _group(ctx: Ctx, t, keys, aggs):
    """Group by ``keys`` (sorted, each run of equal keys one group; no keys:
    one global group, also over no rows) and aggregate each group."""
    n = _n(t)
    if keys:
        order = np.lexsort([t[k] for k in reversed(keys)])
        sk = [t[k][order] for k in keys]
        change = np.zeros(n, bool)
        change[:1] = True
        for v in sk:
            change[1:] |= v[1:] != v[:-1]
        starts = np.flatnonzero(change)
        out = {k: v[starts] for k, v in zip(keys, sk)}
    else:
        order = np.arange(n)
        starts = np.zeros(1, np.int64)
        out = {}
    counts = np.diff(np.append(starts, n))
    for name, op, col in aggs:
        if op == "count":
            out[name] = counts.astype(np.int64)
            continue
        vals = t[col][order]
        if ctx.f32:
            vals = vals.astype(np.float32)
        cells: List[object] = []
        if n == 0:
            cells = [0 if op == "sum" else None] * starts.size
        elif op in ("sum", "avg"):
            if ctx.f32 or _absmax(vals) * int(counts.max()) < _I63:
                sums = [float(x) if ctx.f32 else int(x)
                        for x in np.add.reduceat(vals, starts)]
            else:
                bounds = np.append(starts, n)
                sums = [ctx.total(vals[bounds[g]:bounds[g + 1]])
                        for g in range(starts.size)]
            cells = sums if op == "sum" else [
                s / c for s, c in zip(sums, counts.tolist())]
        elif op in ("min", "max"):
            red = np.minimum if op == "min" else np.maximum
            cells = [float(x) if ctx.f32 else int(x)
                     for x in red.reduceat(vals, starts)]
        else:
            raise ValueError(op)
        out[name] = np.asarray(cells, object)
    return out


def _order(t, keys, limit):
    n = _n(t)
    if n and keys:
        sort_cols = [(-t[c] if desc else t[c]) for c, desc in reversed(keys)]
        t = _take(t, np.lexsort(sort_cols))
    if limit is not None:
        t = _take(t, slice(0, min(limit, n)))
    return t


def _node(ctx: Ctx, q: BoundQuery, n: dict, tables, live, counts):
    if "scan" in n:
        rel = n["scan"]
        cols = tables[rel]
        sel = None
        filt = dict(q.filters).get(rel)
        if filt is not None:
            sel = ctx.pred(cols, filt)
        if live is not None and rel in live:
            sel = live[rel] if sel is None else sel & live[rel]
        if sel is None:
            counts[rel] = _n(cols)
            return {c: cols[c] for c in n["columns"]}
        idx = np.flatnonzero(sel)
        counts[rel] = int(idx.size)
        return {c: cols[c][idx] for c in n["columns"]}
    if "join" in n:
        return _join(_node(ctx, q, n["join"][0], tables, live, counts),
                     _node(ctx, q, n["join"][1], tables, live, counts), *n["keys"])
    if "filter" in n:
        t = _node(ctx, q, n["filter"], tables, live, counts)
        return _take(t, np.flatnonzero(ctx.pred(t, n["pred"])))
    if "project" in n:
        t = dict(_node(ctx, q, n["project"], tables, live, counts))
        rows = _n(t)
        for name, x in n["exprs"]:
            v = (ctx.pred(t, x).astype(np.int64) if is_pred(x)
                 else ctx.expr(t, x))
            t[name] = np.broadcast_to(v, (rows,)).copy()
        return t
    if "group" in n:
        return _group(ctx, _node(ctx, q, n["group"], tables, live, counts),
                      n["keys"], n["aggs"])
    if "order" in n:
        return _order(_node(ctx, q, n["order"], tables, live, counts), n["keys"],
                      n["limit"])
    raise ValueError(n)


def _cell(v):
    if v is None:
        return None
    if isinstance(v, (float, np.floating)):
        return float(v)
    return int(v)


def evaluate(q: BoundQuery, tables, live=None, precision: str = "exact"
             ) -> Dict[str, object]:
    """The answer of ``q`` over ``tables`` ({relation: {column: int64
    array}}); ``live`` ({relation: bool array}) marks the rows present at
    the state the answer is taken at, all rows where it is None."""
    ctx = Ctx(precision)
    if q.scope != "end_to_end":
        return _scope_answer(ctx, q, tables, live)
    counts: Dict[str, int] = {}
    t = _node(ctx, q, q.host["root"], tables, live, counts)
    cols = tuple(q.host["output"])
    rows = [tuple(_cell(t[c][i]) for c in cols) for i in range(_n(t))]
    return {"columns": cols, "rows": rows, "selected": counts}
