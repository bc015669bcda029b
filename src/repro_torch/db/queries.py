"""The paper's evaluated TPC-H query set (Table 2).

Full queries (filter + aggregate entirely in PIM): Q1, Q6, Q22_sub.
Filter-only queries (PIM filters; the rest of the query runs on the host
and is out of scope, exactly as in the paper): Q2-Q5, Q7, Q8, Q10-Q12,
Q14-Q17, Q19-Q21. Q9/Q13/Q18 filter only non-PIM text attributes and are
not evaluated (paper §5.1).

Predicates use the TPC-H validation parameters. Every value is already
PIM-encoded (dict ids, scaled cents, day offsets) via `schema.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import exec as E
from . import schema as S
from .compiler import (Agg, AddE, And, Between, Cmp, Col, InSet, Lit, Mul,
                       Not, Or, RSubImm)

D = S.date_to_days
NK = S.NATION_KEY

# revenue = l_extendedprice * (1 - l_discount), at cents x percent scale
# (schema.decode_revenue turns it back into currency).
REVENUE = Mul(Col("l_extendedprice"), RSubImm(100, Col("l_discount")))


@dataclasses.dataclass
class QuerySpec:
    name: str
    kind: str                                 # "full" | "filter"
    filters: Dict[str, object]                # relation -> Pred
    agg_relation: Optional[str] = None
    aggregates: Sequence[Agg] = ()
    groups: Optional[List[Tuple[str, object]]] = None   # (label, Pred)
    # Host half of the end-to-end split (exec.HostStage): PIM filters +
    # materialization feed this plan; None = the paper's filter-only scope.
    host: Optional[E.HostStage] = None

    def filter_only(self) -> "QuerySpec":
        """The paper-scope copy of this spec: PIM filters, groups and
        aggregates only, host stage dropped. ``PimDatabase.execute``
        routes on ``host``, so this is how a caller asks for the mask/
        aggregate run of a query that also ships a host stage (the old
        ``run_pim`` behaviour)."""
        if self.host is None:
            return self
        return dataclasses.replace(self, host=None)

    def pim_relations(self) -> Tuple[str, ...]:
        """Names of the PIM relations this spec's array stage touches —
        the filtered relations, plus (for end-to-end specs) every
        scan-all relation the host plan materializes. Serving-layer
        result caches key on these relations' content versions."""
        if self.host is None:
            return tuple(self.filters)
        return tuple(rel for rel, _, _ in E.split_query(self)[0])


def _q1() -> QuerySpec:
    cutoff = D("1998-12-01") - 90
    disc_price = Mul(Col("l_extendedprice"), RSubImm(100, Col("l_discount")))
    charge = Mul(disc_price, AddE(Col("l_tax"), Lit(100)))
    groups = []
    for irf, rf in enumerate(S.RETURNFLAGS):
        for ils, ls in enumerate(S.LINESTATUS):
            groups.append((f"{rf}/{ls}", And(
                Cmp("eq", Col("l_returnflag"), Lit(irf)),
                Cmp("eq", Col("l_linestatus"), Lit(ils)))))
    return QuerySpec(
        "Q1", "full",
        filters={"lineitem": Cmp("le", Col("l_shipdate"), Lit(cutoff))},
        agg_relation="lineitem",
        aggregates=[
            Agg("sum", Col("l_quantity"), "sum_qty"),
            Agg("sum", Col("l_extendedprice"), "sum_base_price"),
            Agg("sum", disc_price, "sum_disc_price"),
            Agg("sum", charge, "sum_charge"),
            Agg("avg", Col("l_quantity"), "avg_qty"),
            Agg("avg", Col("l_discount"), "avg_disc"),
            Agg("count", None, "count_order"),
        ],
        groups=groups)


def _q6() -> QuerySpec:
    return QuerySpec(
        "Q6", "full",
        filters={"lineitem": And(
            Cmp("ge", Col("l_shipdate"), Lit(D("1994-01-01"))),
            Cmp("lt", Col("l_shipdate"), Lit(D("1995-01-01"))),
            Between(Col("l_discount"), 5, 7),
            Cmp("lt", Col("l_quantity"), Lit(24)))},
        agg_relation="lineitem",
        aggregates=[Agg("sum", Mul(Col("l_extendedprice"), Col("l_discount")),
                        "revenue")])


def _q22() -> QuerySpec:
    ccs = (13, 31, 23, 29, 30, 18, 17)
    return QuerySpec(
        "Q22_sub", "full",
        filters={"customer": And(
            Cmp("gt", Col("c_acctbal"), Lit(S.ACCTBAL_OFFSET)),  # > 0.00
            InSet(Col("c_phone_cc"), ccs))},
        agg_relation="customer",
        aggregates=[Agg("avg", Col("c_acctbal"), "avg_acctbal")])


def _filter_only() -> List[QuerySpec]:
    qs: List[QuerySpec] = []
    qs.append(QuerySpec("Q2", "filter", {
        "part": And(Cmp("eq", Col("p_size"), Lit(15)),
                    Cmp("eq", Col("p_type_syl3"),
                        Lit(S.TYPE_SYL3.index("BRASS")))),
        "supplier": InSet(Col("s_nationkey"),
                          tuple(S.NATIONS_IN_REGION["EUROPE"])),
    }))
    qs.append(QuerySpec("Q3", "filter", {
        "customer": Cmp("eq", Col("c_mktsegment"),
                        Lit(S.SEGMENTS.index("BUILDING"))),
        "orders": Cmp("lt", Col("o_orderdate"), Lit(D("1995-03-15"))),
        "lineitem": Cmp("gt", Col("l_shipdate"), Lit(D("1995-03-15"))),
    }))
    qs.append(QuerySpec("Q4", "filter", {
        "orders": And(Cmp("ge", Col("o_orderdate"), Lit(D("1993-07-01"))),
                      Cmp("lt", Col("o_orderdate"), Lit(D("1993-10-01")))),
        "lineitem": Cmp("lt", Col("l_commitdate"), Col("l_receiptdate")),
    }))
    qs.append(QuerySpec("Q5", "filter", {
        "supplier": InSet(Col("s_nationkey"),
                          tuple(S.NATIONS_IN_REGION["ASIA"])),
        "customer": InSet(Col("c_nationkey"),
                          tuple(S.NATIONS_IN_REGION["ASIA"])),
        "orders": And(Cmp("ge", Col("o_orderdate"), Lit(D("1994-01-01"))),
                      Cmp("lt", Col("o_orderdate"), Lit(D("1995-01-01")))),
    }))
    fr_de = (NK["FRANCE"], NK["GERMANY"])
    qs.append(QuerySpec("Q7", "filter", {
        "supplier": InSet(Col("s_nationkey"), fr_de),
        "customer": InSet(Col("c_nationkey"), fr_de),
        "lineitem": Between(Col("l_shipdate"), D("1995-01-01"), D("1996-12-31")),
    }))
    qs.append(QuerySpec("Q8", "filter", {
        "part": Cmp("eq", Col("p_type"),
                    Lit(S.type_name_to_id("ECONOMY ANODIZED STEEL"))),
        "orders": Between(Col("o_orderdate"), D("1995-01-01"), D("1996-12-31")),
        "customer": InSet(Col("c_nationkey"),
                          tuple(S.NATIONS_IN_REGION["AMERICA"])),
    }))
    qs.append(QuerySpec("Q10", "filter", {
        "orders": And(Cmp("ge", Col("o_orderdate"), Lit(D("1993-10-01"))),
                      Cmp("lt", Col("o_orderdate"), Lit(D("1994-01-01")))),
        "lineitem": Cmp("eq", Col("l_returnflag"),
                        Lit(S.RETURNFLAGS.index("R"))),
    }))
    qs.append(QuerySpec("Q11", "filter", {
        "supplier": Cmp("eq", Col("s_nationkey"), Lit(NK["GERMANY"])),
    }))
    qs.append(QuerySpec("Q12", "filter", {
        "lineitem": And(
            InSet(Col("l_shipmode"), (S.SHIPMODES.index("MAIL"),
                                      S.SHIPMODES.index("SHIP"))),
            Cmp("lt", Col("l_commitdate"), Col("l_receiptdate")),
            Cmp("lt", Col("l_shipdate"), Col("l_commitdate")),
            Cmp("ge", Col("l_receiptdate"), Lit(D("1994-01-01"))),
            Cmp("lt", Col("l_receiptdate"), Lit(D("1995-01-01")))),
    }))
    qs.append(QuerySpec("Q14", "filter", {
        "lineitem": And(Cmp("ge", Col("l_shipdate"), Lit(D("1995-09-01"))),
                        Cmp("lt", Col("l_shipdate"), Lit(D("1995-10-01")))),
    }))
    qs.append(QuerySpec("Q15", "filter", {
        "lineitem": And(Cmp("ge", Col("l_shipdate"), Lit(D("1996-01-01"))),
                        Cmp("lt", Col("l_shipdate"), Lit(D("1996-04-01")))),
    }))
    qs.append(QuerySpec("Q16", "filter", {
        "part": And(Cmp("ne", Col("p_brand"), Lit(S.brand_name_to_id("Brand#45"))),
                    Not(Cmp("eq", Col("p_type_syl12"),
                            Lit(S.TYPE_SYL1.index("MEDIUM") * len(S.TYPE_SYL2)
                                + S.TYPE_SYL2.index("POLISHED")))),
                    InSet(Col("p_size"), (49, 14, 23, 45, 19, 3, 36, 9))),
    }))
    qs.append(QuerySpec("Q17", "filter", {
        "part": And(Cmp("eq", Col("p_brand"), Lit(S.brand_name_to_id("Brand#23"))),
                    Cmp("eq", Col("p_container"),
                        Lit(S.container_name_to_id("MED BOX")))),
    }))
    air = (S.SHIPMODES.index("AIR"), S.SHIPMODES.index("REG AIR"))
    deliver = S.SHIPINSTRUCT.index("DELIVER IN PERSON")
    qs.append(QuerySpec("Q19", "filter", {
        "part": Or(
            And(Cmp("eq", Col("p_brand"), Lit(S.brand_name_to_id("Brand#12"))),
                InSet(Col("p_container"),
                      tuple(S.container_name_to_id(c) for c in
                            ("SM CASE", "SM BOX", "SM PACK", "SM PKG"))),
                Between(Col("p_size"), 1, 5)),
            And(Cmp("eq", Col("p_brand"), Lit(S.brand_name_to_id("Brand#23"))),
                InSet(Col("p_container"),
                      tuple(S.container_name_to_id(c) for c in
                            ("MED BAG", "MED BOX", "MED PKG", "MED PACK"))),
                Between(Col("p_size"), 1, 10)),
            And(Cmp("eq", Col("p_brand"), Lit(S.brand_name_to_id("Brand#34"))),
                InSet(Col("p_container"),
                      tuple(S.container_name_to_id(c) for c in
                            ("LG CASE", "LG BOX", "LG PACK", "LG PKG"))),
                Between(Col("p_size"), 1, 15))),
        "lineitem": And(InSet(Col("l_shipmode"), air),
                        Cmp("eq", Col("l_shipinstruct"), Lit(deliver)),
                        Between(Col("l_quantity"), 1, 30)),
    }))
    qs.append(QuerySpec("Q20", "filter", {
        "supplier": Cmp("eq", Col("s_nationkey"), Lit(NK["CANADA"])),
        "lineitem": And(Cmp("ge", Col("l_shipdate"), Lit(D("1994-01-01"))),
                        Cmp("lt", Col("l_shipdate"), Lit(D("1995-01-01")))),
    }))
    qs.append(QuerySpec("Q21", "filter", {
        "supplier": Cmp("eq", Col("s_nationkey"), Lit(NK["SAUDI ARABIA"])),
        "orders": Cmp("eq", Col("o_orderstatus"),
                      Lit(S.ORDERSTATUS.index("F"))),
        "lineitem": Cmp("gt", Col("l_receiptdate"), Col("l_commitdate")),
    }))
    return qs


# --------------------------------------------------------------------------
# Host stages: the join/aggregate/order half of formerly filter-only
# queries (PIM selection + host completion, arXiv:2302.01675 §3). Column
# values stay PIM-encoded ints end to end; decoding is presentation-only.
# --------------------------------------------------------------------------
def _host_q3() -> E.HostStage:
    """Q3: shipping priority — 3-way join, revenue per order, top 10.
    (TPC-H orders by revenue only; o_orderdate is the deterministic
    tie-break both the executor and the oracle apply.)"""
    j = E.HashJoin(
        E.HashJoin(E.PimScan("customer", ("c_custkey",)),
                   E.PimScan("orders", ("o_orderkey", "o_custkey",
                                        "o_orderdate", "o_shippriority")),
                   "c_custkey", "o_custkey"),
        E.PimScan("lineitem", ("l_orderkey", "l_extendedprice",
                               "l_discount")),
        "o_orderkey", "l_orderkey")
    agg = E.GroupAgg(E.Project(j, (("revenue", REVENUE),)),
                     ("l_orderkey", "o_orderdate", "o_shippriority"),
                     (E.HostAgg("revenue", "sum", "revenue"),))
    root = E.OrderLimit(agg, (("revenue", True), ("o_orderdate", False),
                              ("l_orderkey", False)), 10)
    return E.HostStage(root, ("l_orderkey", "revenue", "o_orderdate",
                              "o_shippriority"))


def _host_q5() -> E.HostStage:
    """Q5: local supplier volume — revenue per nation (customer and
    supplier in the same ASIA nation), descending."""
    j = E.HashJoin(
        E.HashJoin(
            E.HashJoin(E.PimScan("customer", ("c_custkey", "c_nationkey")),
                       E.PimScan("orders", ("o_orderkey", "o_custkey")),
                       "c_custkey", "o_custkey"),
            E.PimScan("lineitem", ("l_orderkey", "l_suppkey",
                                   "l_extendedprice", "l_discount")),
            "o_orderkey", "l_orderkey"),
        E.PimScan("supplier", ("s_suppkey", "s_nationkey")),
        "l_suppkey", "s_suppkey")
    f = E.Filter(j, Cmp("eq", Col("c_nationkey"), Col("s_nationkey")))
    agg = E.GroupAgg(E.Project(f, (("revenue", REVENUE),)),
                     ("s_nationkey",),
                     (E.HostAgg("revenue", "sum", "revenue"),))
    root = E.OrderLimit(agg, (("revenue", True), ("s_nationkey", False)),
                        None)
    return E.HostStage(root, ("s_nationkey", "revenue"))


def _host_q10() -> E.HostStage:
    """Q10: returned-item reporting — revenue per customer over 'R'
    lineitems of one quarter's orders, top 20 (c_custkey tie-break)."""
    j = E.HashJoin(
        E.HashJoin(E.PimScan("customer", ("c_custkey", "c_nationkey",
                                          "c_acctbal")),
                   E.PimScan("orders", ("o_orderkey", "o_custkey")),
                   "c_custkey", "o_custkey"),
        E.PimScan("lineitem", ("l_orderkey", "l_extendedprice",
                               "l_discount")),
        "o_orderkey", "l_orderkey")
    agg = E.GroupAgg(E.Project(j, (("revenue", REVENUE),)),
                     ("c_custkey", "c_nationkey", "c_acctbal"),
                     (E.HostAgg("revenue", "sum", "revenue"),))
    root = E.OrderLimit(agg, (("revenue", True), ("c_custkey", False)), 20)
    return E.HostStage(root, ("c_custkey", "revenue", "c_acctbal",
                              "c_nationkey"))


def _host_q12() -> E.HostStage:
    """Q12: shipping modes and order priority — SUM(CASE) flag counts per
    ship mode (URGENT/HIGH vs the rest)."""
    high = InSet(Col("o_orderpriority"),
                 (S.PRIORITIES.index("1-URGENT"), S.PRIORITIES.index("2-HIGH")))
    j = E.HashJoin(E.PimScan("lineitem", ("l_orderkey", "l_shipmode")),
                   E.PimScan("orders", ("o_orderkey", "o_orderpriority")),
                   "l_orderkey", "o_orderkey")
    proj = E.Project(j, (("high", high), ("low", Not(high))))
    agg = E.GroupAgg(proj, ("l_shipmode",),
                     (E.HostAgg("high_line_count", "sum", "high"),
                      E.HostAgg("low_line_count", "sum", "low")))
    root = E.OrderLimit(agg, (("l_shipmode", False),), None)
    return E.HostStage(root, ("l_shipmode", "high_line_count",
                              "low_line_count"))


def _host_q14() -> E.HostStage:
    """Q14: promotion effect — PROMO revenue share of one month. The two
    exact sums come back as a single global group; the percentage is
    decode-time (schema.decode_revenue / promo_share)."""
    promo_lo = S.type_id(S.TYPE_SYL1.index("PROMO"), 0, 0)
    promo_hi = S.type_id(S.TYPE_SYL1.index("PROMO"),
                         len(S.TYPE_SYL2) - 1, len(S.TYPE_SYL3) - 1)
    j = E.HashJoin(E.PimScan("lineitem", ("l_partkey", "l_extendedprice",
                                          "l_discount")),
                   E.PimScan("part", ("p_partkey", "p_type")),
                   "l_partkey", "p_partkey")
    proj = E.Project(j, (("revenue", REVENUE),
                         ("is_promo", Between(Col("p_type"),
                                              promo_lo, promo_hi)),
                         ("promo_revenue", Mul(Col("revenue"),
                                               Col("is_promo")))))
    agg = E.GroupAgg(proj, (),
                     (E.HostAgg("promo_revenue", "sum", "promo_revenue"),
                      E.HostAgg("revenue", "sum", "revenue")))
    return E.HostStage(agg, ("promo_revenue", "revenue"))


def _host_q19() -> E.HostStage:
    """Q19: discounted revenue — the PIM filters are the relation-local
    supersets (qty 1-30, all three brand/container/size branches); the
    host applies the residual per-branch predicate that ties each brand
    to its exact quantity range after the join."""
    def branch(brand, containers, size_hi, qty_lo, qty_hi):
        return And(
            Cmp("eq", Col("p_brand"), Lit(S.brand_name_to_id(brand))),
            InSet(Col("p_container"),
                  tuple(S.container_name_to_id(c) for c in containers)),
            Between(Col("p_size"), 1, size_hi),
            Between(Col("l_quantity"), qty_lo, qty_hi))

    residual = Or(
        branch("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"),
               5, 1, 11),
        branch("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"),
               10, 10, 20),
        branch("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"),
               15, 20, 30))
    j = E.HashJoin(E.PimScan("lineitem", ("l_partkey", "l_quantity",
                                          "l_extendedprice", "l_discount")),
                   E.PimScan("part", ("p_partkey", "p_brand", "p_container",
                                      "p_size")),
                   "l_partkey", "p_partkey")
    agg = E.GroupAgg(E.Project(E.Filter(j, residual),
                               (("revenue", REVENUE),)),
                     (), (E.HostAgg("revenue", "sum", "revenue"),))
    return E.HostStage(agg, ("revenue",))


_HOST_STAGES = {"Q3": _host_q3, "Q5": _host_q5, "Q10": _host_q10,
                "Q12": _host_q12, "Q14": _host_q14, "Q19": _host_q19}


def all_queries() -> List[QuerySpec]:
    qs = [_q1(), _q6(), _q22()] + _filter_only()
    for q in qs:
        build = _HOST_STAGES.get(q.name)
        if build is not None:
            q.host = build()
    return qs


def get_query(name: str) -> QuerySpec:
    for q in all_queries():
        if q.name == name:
            return q
    raise KeyError(name)


# --------------------------------------------------------------------------
# Numpy oracle (doubles as the in-memory column-store baseline semantics)
# --------------------------------------------------------------------------
def eval_expr(cols: Dict[str, np.ndarray], e) -> np.ndarray:
    if isinstance(e, Col):
        return cols[e.name].astype(np.int64)
    if isinstance(e, Lit):
        return np.int64(e.value)
    if isinstance(e, Mul):
        return eval_expr(cols, e.a) * eval_expr(cols, e.b)
    if isinstance(e, AddE):
        return eval_expr(cols, e.a) + eval_expr(cols, e.b)
    if isinstance(e, RSubImm):
        return np.int64(e.imm) - eval_expr(cols, e.e)
    raise TypeError(e)


def eval_pred(cols: Dict[str, np.ndarray], p) -> np.ndarray:
    if isinstance(p, Cmp):
        a = eval_expr(cols, p.left)
        b = (np.int64(p.right.value) if isinstance(p.right, Lit)
             else eval_expr(cols, p.right))
        return {"eq": a == b, "ne": a != b, "lt": a < b, "le": a <= b,
                "gt": a > b, "ge": a >= b}[p.op]
    if isinstance(p, Between):
        a = eval_expr(cols, p.col)
        return (a >= p.lo) & (a <= p.hi)
    if isinstance(p, InSet):
        a = eval_expr(cols, p.col)
        return np.isin(a, np.asarray(p.values, np.int64))
    if isinstance(p, Not):
        return ~eval_pred(cols, p.p)
    if isinstance(p, And):
        out = eval_pred(cols, p.ps[0])
        for q in p.ps[1:]:
            out = out & eval_pred(cols, q)
        return out
    if isinstance(p, Or):
        out = eval_pred(cols, p.ps[0])
        for q in p.ps[1:]:
            out = out | eval_pred(cols, q)
        return out
    raise TypeError(p)


def eval_aggregate(cols: Dict[str, np.ndarray], mask: np.ndarray, agg: Agg):
    if agg.op == "count":
        return int(mask.sum())
    vals = eval_expr(cols, agg.expr)[mask]
    if agg.op == "sum":
        return int(vals.sum())
    if agg.op == "avg":
        # Empty-group avg is None (matches _finalize_aggs), not (0, 0).
        n = int(mask.sum())
        return None if n == 0 else (int(vals.sum()), n)
    if agg.op == "min":
        return int(vals.min()) if vals.size else None
    if agg.op == "max":
        return int(vals.max()) if vals.size else None
    raise ValueError(agg.op)
