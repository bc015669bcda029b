"""The least time the card could take for a window's queries.

Counted from the bound templates and the columns' widths alone, never from
the program's compiled tapes, so the bound reads the same work whatever
implements it. The peaks are one NVIDIA H100 SXM's:

* bytes: 3.35 TB/s of HBM3 (NVIDIA's data sheet);
* logic: 16.73 T 32-bit word operations/s, 64 a clock per SM (CUDA C++
  Programming Guide, compute capability 9.0, 32-bit integer and bitwise
  operations) x 132 SMs x 1,980 MHz (the boost clock);
* popcounts: 4.182 T/s, 16 a clock per SM at the same clock and SMs.

A relation of ``n`` rows has ``W = ceil(n / 32)`` words a bit-plane, and
an attribute of width ``w`` (the bit length of its largest value: the
schema's leading-zero suppression) has ``w`` planes.

**fused_program** (one launch a relation and admission window): bytes are
every plane of every column that a query of the window reads on that
relation, once, plus the valid plane, plus one mask plane written per
query (``W * 4`` bytes each). Operations a word, with identical predicate
leaves and expressions of one window counted once:

* a comparison of a ``w``-bit column with a constant: ``w`` logic ops for
  eq/ne, ``2w`` for lt/le/gt/ge; of two columns: ``2w`` and ``3w``
  (``w`` the wider); ``between``: two comparisons; ``in`` over ``k``
  values: ``k`` equalities and ``k - 1`` ORs; ``not``: 1; ``and``/``or``
  of ``m``: ``m - 1``; the AND with the valid plane: 1;
* a group: its predicate and 1 AND with the filter mask;
* an expression's value planes: a product of ``a`` and ``b`` bits
  ``a * b`` ANDs (the partial products; the adds are not counted) giving
  ``a + b`` bits; a sum ``max(a, b)`` ops giving ``max(a, b) + 1`` bits;
  ``v - e`` ``w`` ops giving ``bit_length(v)`` bits; a column none;
* ``sum`` of a ``w``-bit value under a group mask: ``w`` ANDs and ``w``
  popcounts; ``count``: 1 popcount; ``avg``: both; ``min``/``max``: ``w``
  ANDs and ``w`` popcounts.

The bound of a launch is max(bytes / 3.35e12, logic * W / 16.73e12,
popcounts * W / 4.182e12) seconds.

**materialize** (one launch a relation an end-to-end query scans): the
planes of the columns it hands the host and the mask are read once, and
each selected row's values are written once at their bit widths
(``rows * sum(w) / 8`` bytes); bytes / 3.35e12 seconds.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Set, Tuple

import numpy as np

from .templates import BoundQuery, expr_columns, pred_columns, walk_plan

HBM_BYTES_S = 3.35e12
LOGIC_OPS_S = 64 * 132 * 1.980e9
POPCOUNT_S = 16 * 132 * 1.980e9


def widths(tables: Dict[str, Dict[str, np.ndarray]]) -> Dict[str, Dict[str, int]]:
    """{relation: {column: bits}} of the generated columns."""
    return {rel: {c: max(1, int(np.asarray(v).max(initial=0)).bit_length())
                  for c, v in cols.items()}
            for rel, cols in tables.items()}


def _key(x) -> str:
    return json.dumps(x, sort_keys=True)


class _Ops:
    """Logic ops and popcounts a word, with repeated work counted once."""

    def __init__(self, w: Dict[str, int]):
        self.w = w
        self.logic = 0
        self.pop = 0
        self.seen: Set[str] = set()

    def _once(self, x) -> bool:
        k = _key(x)
        if k in self.seen:
            return False
        self.seen.add(k)
        return True

    def pred(self, p: dict) -> None:
        if "cmp" in p:
            if self._once(p):
                w = self.w[p["col"]]
                two = p["cmp"] in ("eq", "ne")
                if "col2" in p:
                    w = max(w, self.w[p["col2"]])
                    self.logic += (2 if two else 3) * w
                else:
                    self.logic += (1 if two else 2) * w
        elif "between" in p:
            if self._once(p):
                self.logic += 4 * self.w[p["between"]]
        elif "in" in p:
            if self._once(p):
                k = len(p["values"])
                self.logic += k * self.w[p["in"]] + max(0, k - 1)
        elif "not" in p:
            self.pred(p["not"])
            self.logic += 1
        else:
            kids = p.get("and", p.get("or"))
            for q in kids:
                self.pred(q)
            self.logic += len(kids) - 1

    def expr(self, e: dict) -> int:
        """Count the value planes of ``e``; returns its width."""
        if "col" in e:
            return self.w[e["col"]]
        if "lit" in e:
            return max(1, int(e["lit"]).bit_length())
        if "rsub" in e:
            w = self.expr(e["rsub"][1])
            if self._once(e):
                self.logic += w
            return max(1, int(e["rsub"][0]).bit_length())
        a, b = (self.expr(x) for x in e.get("mul", e.get("add")))
        if "mul" in e:
            if self._once(e):
                self.logic += a * b
            return a + b
        if self._once(e):
            self.logic += max(a, b)
        return max(a, b) + 1


def _filter_columns(q: BoundQuery, rel: str) -> List[str]:
    cols: List[str] = []
    for r, p in q.filters:
        if r == rel:
            cols += pred_columns(p)
    if q.kind == "full" and q.agg_relation == rel:
        for _, g in (q.groups or ()):
            cols += pred_columns(g)
        for a in q.aggregates:
            if a["expr"] is not None:
                cols += expr_columns(a["expr"])
    return cols


def fused_bound_s(queries: Iterable[BoundQuery], n_rows: Dict[str, int],
                  w: Dict[str, Dict[str, int]]) -> float:
    """Bound of one admission window: one launch a relation it touches."""
    per_rel: Dict[str, Tuple[Set[str], int, _Ops]] = {}
    for q in queries:
        for rel in q.relations():
            cols, n_masks, ops = per_rel.setdefault(
                rel, (set(), 0, _Ops(w[rel])))
            cols.update(_filter_columns(q, rel))
            filt = dict(q.filters).get(rel)
            if filt is not None:
                ops.pred(filt)
            ops.logic += 1                          # AND with valid
            if q.kind == "full" and q.agg_relation == rel:
                for _, g in (q.groups or ((None, None),)):
                    if g is not None:
                        ops.pred(g)
                        ops.logic += 1
                    for a in q.aggregates:
                        if a["op"] == "count":
                            ops.pop += 1
                            continue
                        vw = ops.expr(a["expr"])
                        ops.logic += vw
                        ops.pop += vw + (1 if a["op"] == "avg" else 0)
            per_rel[rel] = (cols, n_masks + 1, ops)
    total = 0.0
    for rel, (cols, n_masks, ops) in per_rel.items():
        words = -(-int(n_rows[rel]) // 32)
        planes = sum(w[rel][c] for c in cols) + 1 + n_masks
        total += max(planes * words * 4 / HBM_BYTES_S,
                     ops.logic * words / LOGIC_OPS_S,
                     ops.pop * words / POPCOUNT_S)
    return total


def materialize_bound_s(q: BoundQuery, selected: Dict[str, int],
                        n_rows: Dict[str, int],
                        w: Dict[str, Dict[str, int]]) -> float:
    """Bound of an end-to-end query's materialize launches."""
    if q.scope != "end_to_end":
        return 0.0
    total = 0.0
    for node in walk_plan(q.host["root"]):
        if "scan" not in node:
            continue
        rel = node["scan"]
        words = -(-int(n_rows[rel]) // 32)
        bits = sum(w[rel][c] for c in node["columns"])
        total += ((bits + 1) * words * 4
                  + int(selected[rel]) * bits / 8) / HBM_BYTES_S
    return total
