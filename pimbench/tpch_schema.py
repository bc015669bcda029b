"""TPC-H vocabularies and encodings, frozen for the benchmark.

Copied from ``src/repro_torch/db/schema.py`` at commit 851f7b5 (the file
last changed in fa9a71b): the dictionary vocabularies, the day-offset date
encoding and the id helpers that the generator and the query templates
use (``VOCABS`` names the vocabularies templates index). Later edits to
the program's schema do not move the yardstick.
"""
from __future__ import annotations

import datetime as _dt

EPOCH = _dt.date(1992, 1, 1)


def date_to_days(iso: str) -> int:
    y, m, d = map(int, iso.split("-"))
    return (_dt.date(y, m, d) - EPOCH).days


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
CONTAINER_SYL1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_SYL2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
BRAND_COUNT = 25  # Brand#11..Brand#55 (5x5)

# acctbal in [-999.99, 9999.99] is stored as cents + 100_000.
ACCTBAL_OFFSET = 100_000

VOCABS = {
    "SEGMENTS": SEGMENTS, "PRIORITIES": PRIORITIES, "SHIPMODES": SHIPMODES,
    "SHIPINSTRUCT": SHIPINSTRUCT, "RETURNFLAGS": RETURNFLAGS,
    "LINESTATUS": LINESTATUS, "ORDERSTATUS": ORDERSTATUS,
    "TYPE_SYL3": TYPE_SYL3,
}


def type_id(s1: int, s2: int, s3: int) -> int:
    return (s1 * len(TYPE_SYL2) + s2) * len(TYPE_SYL3) + s3


def type_name_to_id(name: str) -> int:
    a, b, c = name.split(" ")
    return type_id(TYPE_SYL1.index(a), TYPE_SYL2.index(b), TYPE_SYL3.index(c))


def container_name_to_id(name: str) -> int:
    a, b = name.split(" ")
    return CONTAINER_SYL1.index(a) * len(CONTAINER_SYL2) + CONTAINER_SYL2.index(b)
