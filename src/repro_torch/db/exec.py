"""Host-side relational executor over PIM filter masks.

The paper's full-query speedups come from a split execution model: the
PIM side evaluates selections in the array and hands the host *only the
selected records*; the host completes the query — joins, residual
predicates, grouped aggregation, ordering (arXiv:2302.01675,
arXiv:2307.00658). This module is that host side, structured as
composable relational-plan nodes (the shape of ``lsst.daf.relation``'s
operation tree, realised on NumPy columns):

    PimScan -> HashJoin -> Filter -> Project -> GroupAgg -> OrderLimit

``PimScan`` leaves are fed by the fused executor's ``Materialize``
output (compacted, bit-transposed column values — ``kernels/
materialize``); ``TableScan`` reads DRAM-resident relations (nation/
region) directly. Predicates and expressions reuse the ``db.compiler``
AST, so a host-stage residual predicate is written in the same algebra
as the PIM filters it refines (TPC-H Q19's per-branch quantity ranges).

``split_query`` is the planner: it walks a ``QuerySpec``'s host plan,
pairs every ``PimScan`` with the spec's PIM predicate for that relation
(or a scan-all mask when the relation is unfiltered), and returns the
PIM stage — (relation, predicate, columns) triples the database compiles
into filter+materialize programs — alongside the host stage.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .compiler import And, Between, Cmp, InSet, Not, Or

# Predicate node types: a Project entry that is one of these yields a 0/1
# flag column (SUM(CASE WHEN ...) style) instead of an arithmetic value.
_PRED_TYPES = (Cmp, Between, InSet, Not, And, Or)


# --------------------------------------------------------------------------
# Tables: named, equal-length int64 columns
# --------------------------------------------------------------------------
@dataclasses.dataclass
class HostTable:
    """A host-resident batch of rows (decoded integer columns)."""

    columns: Dict[str, np.ndarray]

    @property
    def n_rows(self) -> int:
        if not self.columns:
            return 0
        return int(next(iter(self.columns.values())).shape[0])

    def take(self, idx: np.ndarray) -> "HostTable":
        return HostTable({k: v[idx] for k, v in self.columns.items()})


# --------------------------------------------------------------------------
# Plan nodes
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PimScan:
    """Leaf: the materialized (mask-selected) columns of a PIM relation."""

    relation: str
    columns: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class TableScan:
    """Leaf: a DRAM-resident relation (nation/region), scanned directly."""

    relation: str
    columns: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class HashJoin:
    """Inner equi-join; both key columns are int64."""

    left: "PlanNode"
    right: "PlanNode"
    left_key: str
    right_key: str


@dataclasses.dataclass(frozen=True)
class Filter:
    """Residual predicate (a ``db.compiler`` Pred over the child's
    columns) — e.g. the per-branch quantity ranges the PIM-side superset
    filter of TPC-H Q19 cannot express relation-locally."""

    child: "PlanNode"
    pred: object


@dataclasses.dataclass(frozen=True)
class Project:
    """Append computed columns, evaluated in order (later exprs may read
    earlier ones). Each expr is a ``db.compiler`` Expr, or a Pred (which
    yields a 0/1 int column — SUM(CASE WHEN ...) style flags)."""

    child: "PlanNode"
    exprs: Tuple[Tuple[str, object], ...]


@dataclasses.dataclass(frozen=True)
class HostAgg:
    name: str
    op: str                       # sum | count | avg | min | max
    col: Optional[str] = None     # None for count


@dataclasses.dataclass(frozen=True)
class GroupAgg:
    """Hash group-by + aggregation. Empty ``keys`` = one global group
    (emitted even over zero input rows: count 0, sum 0, avg/min/max
    ``None`` — the empty-group contract)."""

    child: "PlanNode"
    keys: Tuple[str, ...]
    aggs: Tuple[HostAgg, ...]


@dataclasses.dataclass(frozen=True)
class OrderLimit:
    """Sort by ``keys`` ((column, descending) pairs, first = primary),
    then keep the first ``limit`` rows (all when None)."""

    child: "PlanNode"
    keys: Tuple[Tuple[str, bool], ...]
    limit: Optional[int] = None


PlanNode = Union[PimScan, TableScan, HashJoin, Filter, Project, GroupAgg,
                 OrderLimit]


@dataclasses.dataclass(frozen=True)
class HostStage:
    """One query's host half: the plan plus the output column order."""

    root: PlanNode
    output: Tuple[str, ...]


# --------------------------------------------------------------------------
# Planner: QuerySpec -> (PIM stage, host stage)
# --------------------------------------------------------------------------
def walk_plan(node: PlanNode):
    yield node
    for f in ("child", "left", "right"):
        sub = getattr(node, f, None)
        if sub is not None:
            yield from walk_plan(sub)


def split_query(spec) -> Tuple[List[Tuple[str, object, Tuple[str, ...]]],
                               HostStage]:
    """Split a QuerySpec into its PIM stage and host stage.

    The PIM stage is one (relation, predicate, columns) triple per
    ``PimScan`` leaf: the database compiles each into a fused
    filter+materialize program (predicate ``None`` -> scan-all mask, for
    relations the host needs but the query does not filter — the valid
    plane still masks padding records). The host stage is the spec's
    plan, executed over the materialized tables.
    """
    if spec.host is None:
        raise ValueError(f"{spec.name} has no host stage; use run_pim")
    pim_stage = []
    seen = set()
    for node in walk_plan(spec.host.root):
        if isinstance(node, PimScan):
            if node.relation in seen:
                raise ValueError(f"duplicate PimScan of {node.relation}")
            seen.add(node.relation)
            pim_stage.append((node.relation, spec.filters.get(node.relation),
                              node.columns))
    return pim_stage, spec.host


# --------------------------------------------------------------------------
# Execution
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ExecContext:
    """materialized: PIM-relation name -> HostTable (from Materialize);
    tables: the raw generator columns, for DRAM-resident TableScans."""

    materialized: Dict[str, HostTable]
    tables: Dict[str, Dict[str, np.ndarray]]


def _hash_join(lt: HostTable, rt: HostTable, lk: str, rk: str) -> HostTable:
    """Vectorized inner equi-join: sort the right side once, then expand
    each left row across its matching right-row range. Column names must
    be disjoint (TPC-H attrs are relation-prefixed); silent shadowing of
    a doubly-scanned relation's columns would be wrong data, so collide
    loudly and make the planner rename."""
    overlap = set(lt.columns) & set(rt.columns)
    if overlap:
        raise ValueError(
            f"hash join column collision: {sorted(overlap)} appear on "
            "both sides; project/rename before joining")
    lv = np.asarray(lt.columns[lk])
    rv = np.asarray(rt.columns[rk])
    order = np.argsort(rv, kind="stable")
    rs = rv[order]
    lo = np.searchsorted(rs, lv, side="left")
    hi = np.searchsorted(rs, lv, side="right")
    cnt = hi - lo
    total = int(cnt.sum())
    li = np.repeat(np.arange(lv.shape[0]), cnt)
    within = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    ri = order[np.repeat(lo, cnt) + within]
    out = {k: v[li] for k, v in lt.columns.items()}
    out.update((k, v[ri]) for k, v in rt.columns.items())
    return HostTable(out)


def _group_agg(t: HostTable, keys: Tuple[str, ...],
               aggs: Tuple[HostAgg, ...]) -> HostTable:
    n = t.n_rows
    if keys:
        key_mat = np.stack([np.asarray(t.columns[k], np.int64)
                            for k in keys], axis=1)
        uniq, inv = np.unique(key_mat, axis=0, return_inverse=True)
        n_groups = uniq.shape[0]
        out = {k: uniq[:, i] for i, k in enumerate(keys)}
    else:
        inv = np.zeros(n, np.int64)
        n_groups = 1
        out = {}
    counts = np.bincount(inv, minlength=n_groups).astype(np.int64)
    for a in aggs:
        if a.op == "count":
            out[a.name] = counts.copy()
            continue
        vals = np.asarray(t.columns[a.col], np.int64)
        if a.op in ("sum", "avg"):
            s = np.zeros(n_groups, np.int64)
            np.add.at(s, inv, vals)              # exact int accumulation
            if a.op == "sum":
                out[a.name] = s
            else:
                # Empty-group avg is None, never 0/0 (see db.database).
                out[a.name] = np.asarray(
                    [None if c == 0 else sv / c
                     for sv, c in zip(s, counts)], object)
        elif a.op in ("min", "max"):
            fill = np.iinfo(np.int64).max if a.op == "min" \
                else np.iinfo(np.int64).min
            m = np.full(n_groups, fill, np.int64)
            ufunc = np.minimum if a.op == "min" else np.maximum
            ufunc.at(m, inv, vals)
            out[a.name] = np.asarray(
                [None if c == 0 else int(mv)
                 for mv, c in zip(m, counts)], object)
        else:
            raise ValueError(a.op)
    return HostTable(out)


def _order_limit(t: HostTable, keys, limit) -> HostTable:
    if t.n_rows and keys:
        # lexsort: last key is primary; descending int keys negate.
        sort_cols = []
        for col, desc in reversed(keys):
            v = np.asarray(t.columns[col], np.int64)
            sort_cols.append(-v if desc else v)
        idx = np.lexsort(sort_cols)
        t = t.take(idx)
    if limit is not None:
        t = t.take(np.arange(min(limit, t.n_rows)))
    return t


def execute(node: PlanNode, ctx: ExecContext) -> HostTable:
    from . import queries as Q   # lazy: queries imports this module

    if isinstance(node, PimScan):
        t = ctx.materialized[node.relation]
        return HostTable({c: t.columns[c] for c in node.columns})
    if isinstance(node, TableScan):
        cols = ctx.tables[node.relation]
        return HostTable({c: np.asarray(cols[c], np.int64)
                          for c in node.columns})
    if isinstance(node, HashJoin):
        return _hash_join(execute(node.left, ctx), execute(node.right, ctx),
                          node.left_key, node.right_key)
    if isinstance(node, Filter):
        t = execute(node.child, ctx)
        return t.take(np.flatnonzero(Q.eval_pred(t.columns, node.pred)))
    if isinstance(node, Project):
        t = execute(node.child, ctx)
        cols = dict(t.columns)
        for name, expr in node.exprs:
            if isinstance(expr, _PRED_TYPES):
                v = Q.eval_pred(cols, expr).astype(np.int64)
            else:
                v = Q.eval_expr(cols, expr)
            cols[name] = np.broadcast_to(np.asarray(v, np.int64),
                                         (t.n_rows,)).copy()
        return HostTable(cols)
    if isinstance(node, GroupAgg):
        return _group_agg(execute(node.child, ctx), node.keys, node.aggs)
    if isinstance(node, OrderLimit):
        return _order_limit(execute(node.child, ctx), node.keys, node.limit)
    raise TypeError(node)


def run_host_stage(host: HostStage, ctx: ExecContext) -> HostTable:
    t = execute(host.root, ctx)
    return HostTable({c: t.columns[c] for c in host.output})


def baseline_context(tables: Dict[str, Dict[str, np.ndarray]],
                     spec) -> ExecContext:
    """The NumPy column-scan stand-in for the PIM stage: evaluate each
    PimScan's predicate with the baseline oracle and gather the selected
    rows directly. Running the same host stage over this context checks
    the PIM filter + materialize half end to end."""
    from . import queries as Q

    mat: Dict[str, HostTable] = {}
    for rel, pred, cols in split_query(spec)[0]:
        t = tables[rel]
        if pred is None:
            sel = slice(None)
        else:
            sel = Q.eval_pred(t, pred)
        mat[rel] = HostTable({c: np.asarray(t[c], np.int64)[sel]
                              for c in cols})
    return ExecContext(mat, tables)
