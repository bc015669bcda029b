"""TPC-H schema subset with PIM encodings (paper §5.1).

Attributes are encoded exactly the way the paper prepares them for the PIM
copy: *dictionary encoding* for categorical attributes (equality-only
predicates survive the encoding) and *leading-zero suppression* for
numerics (all comparisons/arithmetic survive). Decimals are scaled to
integers (cents / basis points); dates become days since 1992-01-01. The
large text attributes (NAME/ADDRESS/COMMENT) are excluded from the PIM
copy, as in the paper.
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
from typing import Dict, List

EPOCH = _dt.date(1992, 1, 1)


def date_to_days(iso: str) -> int:
    y, m, d = map(int, iso.split("-"))
    return (_dt.date(y, m, d) - EPOCH).days


# Dictionary vocabularies (fixed by the TPC-H spec).
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [  # (name, regionkey)
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
NATION_KEY = {name: i for i, (name, _) in enumerate(NATIONS)}
NATIONS_IN_REGION = {
    r: [i for i, (_, rk) in enumerate(NATIONS) if rk == ri]
    for ri, r in enumerate(REGIONS)
}

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
SHIPINSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
RETURNFLAGS = ["R", "A", "N"]
LINESTATUS = ["O", "F"]
ORDERSTATUS = ["F", "O", "P"]

TYPE_SYL1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_SYL2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_SYL3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
# p_type = syl1 + syl2 + syl3 (150 combos). Encoded as one dict id plus the
# syllable ids so that LIKE '%BRASS' / LIKE 'MEDIUM POLISHED%' stay
# equality predicates after encoding (paper: dictionary encoding allows
# equality comparisons).
CONTAINER_SYL1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_SYL2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
BRAND_COUNT = 25  # Brand#11..Brand#55 (5x5)


def type_id(s1: int, s2: int, s3: int) -> int:
    return (s1 * len(TYPE_SYL2) + s2) * len(TYPE_SYL3) + s3


def container_id(c1: int, c2: int) -> int:
    return c1 * len(CONTAINER_SYL2) + c2


def type_name_to_id(name: str) -> int:
    a, b, c = name.split(" ")
    return type_id(TYPE_SYL1.index(a), TYPE_SYL2.index(b), TYPE_SYL3.index(c))


def container_name_to_id(name: str) -> int:
    a, b = name.split(" ")
    return container_id(CONTAINER_SYL1.index(a), CONTAINER_SYL2.index(b))


def brand_name_to_id(name: str) -> int:
    """Brand#MN with M,N in 1..5 -> dense id (M-1)*5 + (N-1) in [0, 25)."""
    mn = int(name.split("#")[1])
    m, n = divmod(mn, 10)
    return (m - 1) * 5 + (n - 1)


@dataclasses.dataclass(frozen=True)
class Attr:
    name: str
    encoding: str           # "lzs" | "dict"
    description: str = ""


@dataclasses.dataclass(frozen=True)
class Relation:
    name: str
    attrs: List[Attr]
    in_pim: bool = True
    # Paper Table 1 record counts at SF=1000 (used by the paper-scale model)
    records_at_sf1000: float = 0

    def attr_names(self) -> List[str]:
        return [a.name for a in self.attrs]


SCHEMA: Dict[str, Relation] = {
    "lineitem": Relation("lineitem", [
        Attr("l_orderkey", "lzs"), Attr("l_partkey", "lzs"),
        Attr("l_suppkey", "lzs"), Attr("l_quantity", "lzs"),
        Attr("l_extendedprice", "lzs", "cents"),
        Attr("l_discount", "lzs", "percent 0-10"),
        Attr("l_tax", "lzs", "percent 0-8"),
        Attr("l_returnflag", "dict"), Attr("l_linestatus", "dict"),
        Attr("l_shipdate", "lzs", "days"), Attr("l_commitdate", "lzs"),
        Attr("l_receiptdate", "lzs"), Attr("l_shipinstruct", "dict"),
        Attr("l_shipmode", "dict"),
    ], records_at_sf1000=6e9),
    "orders": Relation("orders", [
        Attr("o_orderkey", "lzs"), Attr("o_custkey", "lzs"),
        Attr("o_orderstatus", "dict"), Attr("o_totalprice", "lzs", "cents"),
        Attr("o_orderdate", "lzs", "days"), Attr("o_orderpriority", "dict"),
        Attr("o_shippriority", "lzs"),
    ], records_at_sf1000=1.5e9),
    "customer": Relation("customer", [
        Attr("c_custkey", "lzs"), Attr("c_nationkey", "lzs"),
        Attr("c_acctbal", "lzs", "cents, offset +100000"),
        Attr("c_mktsegment", "dict"), Attr("c_phone_cc", "lzs", "10-34"),
    ], records_at_sf1000=1.5e8),
    "part": Relation("part", [
        Attr("p_partkey", "lzs"), Attr("p_brand", "dict"),
        Attr("p_type", "dict"), Attr("p_type_syl2", "dict"),
        Attr("p_type_syl3", "dict"), Attr("p_type_syl12", "dict"),
        Attr("p_size", "lzs", "1-50"), Attr("p_container", "dict"),
        Attr("p_retailprice", "lzs", "cents"),
    ], records_at_sf1000=2e8),
    "supplier": Relation("supplier", [
        Attr("s_suppkey", "lzs"), Attr("s_nationkey", "lzs"),
        Attr("s_acctbal", "lzs", "cents, offset +100000"),
    ], records_at_sf1000=1e7),
    "partsupp": Relation("partsupp", [
        Attr("ps_partkey", "lzs"), Attr("ps_suppkey", "lzs"),
        Attr("ps_availqty", "lzs"), Attr("ps_supplycost", "lzs", "cents"),
    ], records_at_sf1000=8e8),
    # Small relations stay in DRAM (paper: NATION/REGION not in PIM).
    "nation": Relation("nation", [
        Attr("n_nationkey", "lzs"), Attr("n_regionkey", "lzs"),
    ], in_pim=False, records_at_sf1000=25),
    "region": Relation("region", [
        Attr("r_regionkey", "lzs"),
    ], in_pim=False, records_at_sf1000=5),
}

# Money offsets: acctbal in [-999.99, 9999.99] -> store cents + 100_000 so
# bit-sliced values are non-negative (leading-zero suppression needs that).
ACCTBAL_OFFSET = 100_000


# --------------------------------------------------------------------------
# Value decoding (PIM encoding -> presentation values)
# --------------------------------------------------------------------------
# The inverse of the offline encoding above, used when end-to-end query
# results leave the engine: scaled cents -> currency, day offsets -> ISO
# dates, dictionary ids -> strings. Encoded (integer) values stay the
# exact comparison/aggregation domain; decoding is presentation only.

def days_to_date(days: int) -> str:
    return (EPOCH + _dt.timedelta(days=int(days))).isoformat()


def type_id_to_name(tid: int) -> str:
    s12, s3 = divmod(int(tid), len(TYPE_SYL3))
    s1, s2 = divmod(s12, len(TYPE_SYL2))
    return f"{TYPE_SYL1[s1]} {TYPE_SYL2[s2]} {TYPE_SYL3[s3]}"


def container_id_to_name(cid: int) -> str:
    c1, c2 = divmod(int(cid), len(CONTAINER_SYL2))
    return f"{CONTAINER_SYL1[c1]} {CONTAINER_SYL2[c2]}"


def brand_id_to_name(bid: int) -> str:
    m, n = divmod(int(bid), 5)
    return f"Brand#{(m + 1) * 10 + (n + 1)}"


DICT_VOCABS = {
    "l_returnflag": RETURNFLAGS, "l_linestatus": LINESTATUS,
    "l_shipmode": SHIPMODES, "l_shipinstruct": SHIPINSTRUCT,
    "o_orderstatus": ORDERSTATUS, "o_orderpriority": PRIORITIES,
    "c_mktsegment": SEGMENTS,
}
_DATE_ATTRS = {"l_shipdate", "l_commitdate", "l_receiptdate", "o_orderdate"}
_CENTS_ATTRS = {"l_extendedprice", "o_totalprice", "p_retailprice",
                "ps_supplycost"}
_OFFSET_CENTS_ATTRS = {"c_acctbal", "s_acctbal"}
_NATION_ATTRS = {"c_nationkey", "s_nationkey", "n_nationkey"}


def decode_value(attr: str, v: int):
    """Decode one PIM-encoded attribute value for presentation.

    De-scales cents (incl. the acctbal offset), maps day offsets to ISO
    dates, and reverses every dictionary encoding; unencoded integers
    pass through. Derived ``revenue``-style columns are money at
    cents x percent scale and decode via :func:`decode_revenue`.
    """
    v = int(v)
    if attr in _CENTS_ATTRS:
        return v / 100.0
    if attr in _OFFSET_CENTS_ATTRS:
        return (v - ACCTBAL_OFFSET) / 100.0
    if attr in _DATE_ATTRS:
        return days_to_date(v)
    if attr in DICT_VOCABS:
        return DICT_VOCABS[attr][v]
    if attr in _NATION_ATTRS:
        return NATIONS[v][0]
    if attr == "p_brand":
        return brand_id_to_name(v)
    if attr == "p_type":
        return type_id_to_name(v)
    if attr == "p_container":
        return container_id_to_name(v)
    return v


def decode_revenue(v: int) -> float:
    """cents x percent (extendedprice * (100 - discount)) -> currency."""
    return int(v) / 10_000.0
