"""TPC-H data generator, frozen for the benchmark.

Copied from ``src/repro_torch/db/tpch.py`` at commit 851f7b5 (the file
last changed in fa9a71b), with only its import pointed at the frozen
vocabularies (``tpch_schema``). Both the program and the reference are
handed the columns this returns, so a later change to the program's own
generator does not change the data a cell runs on.

Row counts follow TPC-H Clause 4.2.5: lineitem ~= 6M x SF, orders = 1.5M
x SF, customer = 150k x SF, part = 200k x SF, supplier = 10k x SF,
partsupp = 800k x SF. Values are already PIM-encoded (scaled ints, dict
ids, day offsets).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from . import tpch_schema as S

MAX_DATE = 2556  # 1998-12-31


def _dates(rng, n, lo=0, hi=MAX_DATE - 151):
    return rng.integers(lo, hi, n)


def generate(sf: float = 0.01, seed: int = 42) -> Dict[str, Dict[str, np.ndarray]]:
    """Returns {relation: {attr: int64 column}} for the schema subset."""
    rng = np.random.default_rng(seed)
    n_li = max(1000, int(6_000_000 * sf))
    n_or = max(250, int(1_500_000 * sf))
    n_cu = max(64, int(150_000 * sf))
    n_pa = max(64, int(200_000 * sf))
    n_su = max(16, int(10_000 * sf))
    n_ps = max(128, int(800_000 * sf))

    tables: Dict[str, Dict[str, np.ndarray]] = {}

    # ----- part -----
    s1 = rng.integers(0, len(S.TYPE_SYL1), n_pa)
    s2 = rng.integers(0, len(S.TYPE_SYL2), n_pa)
    s3 = rng.integers(0, len(S.TYPE_SYL3), n_pa)
    c1 = rng.integers(0, len(S.CONTAINER_SYL1), n_pa)
    c2 = rng.integers(0, len(S.CONTAINER_SYL2), n_pa)
    partkey = np.arange(1, n_pa + 1)
    tables["part"] = {
        "p_partkey": partkey,
        "p_brand": rng.integers(0, S.BRAND_COUNT, n_pa),
        "p_type": (s1 * len(S.TYPE_SYL2) + s2) * len(S.TYPE_SYL3) + s3,
        "p_type_syl2": s2,
        "p_type_syl3": s3,
        "p_type_syl12": s1 * len(S.TYPE_SYL2) + s2,
        "p_size": rng.integers(1, 51, n_pa),
        "p_container": c1 * len(S.CONTAINER_SYL2) + c2,
        # retailprice(key) per spec: 90000+((key/10)%20001)+100*(key%1000), cents
        "p_retailprice": 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000),
    }

    # ----- supplier -----
    tables["supplier"] = {
        "s_suppkey": np.arange(1, n_su + 1),
        "s_nationkey": rng.integers(0, 25, n_su),
        "s_acctbal": rng.integers(-99999, 999999, n_su) + S.ACCTBAL_OFFSET,
    }

    # ----- partsupp -----
    tables["partsupp"] = {
        "ps_partkey": rng.integers(1, n_pa + 1, n_ps),
        "ps_suppkey": rng.integers(1, n_su + 1, n_ps),
        "ps_availqty": rng.integers(1, 10000, n_ps),
        "ps_supplycost": rng.integers(100, 100001, n_ps),
    }

    # ----- customer -----
    tables["customer"] = {
        "c_custkey": np.arange(1, n_cu + 1),
        "c_nationkey": rng.integers(0, 25, n_cu),
        "c_acctbal": rng.integers(-99999, 999999, n_cu) + S.ACCTBAL_OFFSET,
        "c_mktsegment": rng.integers(0, len(S.SEGMENTS), n_cu),
        "c_phone_cc": rng.integers(10, 35, n_cu),
    }

    # ----- orders -----
    odate = _dates(rng, n_or)
    tables["orders"] = {
        "o_orderkey": np.arange(1, n_or + 1),
        "o_custkey": rng.integers(1, n_cu + 1, n_or),
        "o_orderstatus": rng.integers(0, len(S.ORDERSTATUS), n_or),
        "o_totalprice": rng.integers(85000, 55528700, n_or),
        "o_orderdate": odate,
        "o_orderpriority": rng.integers(0, len(S.PRIORITIES), n_or),
        "o_shippriority": np.zeros(n_or, np.int64),
    }

    # ----- lineitem -----
    oidx = rng.integers(0, n_or, n_li)                 # parent order
    pkey = rng.integers(1, n_pa + 1, n_li)
    qty = rng.integers(1, 51, n_li)
    retail = tables["part"]["p_retailprice"][pkey - 1]
    extprice = qty * retail                            # cents, < 2^26
    ship = odate[oidx] + rng.integers(1, 122, n_li)    # orderdate+1..121
    commit = odate[oidx] + rng.integers(30, 91, n_li)
    receipt = ship + rng.integers(1, 31, n_li)
    # returnflag: 'R'/'A' if receipt <= currentdate(1995-06-17), else 'N'
    cur = S.date_to_days("1995-06-17")
    rf = np.where(receipt <= cur, rng.integers(0, 2, n_li), 2)
    ls = np.where(ship > cur, 0, 1)                    # 'O' if shipped late
    tables["lineitem"] = {
        "l_orderkey": tables["orders"]["o_orderkey"][oidx],
        "l_partkey": pkey,
        "l_suppkey": rng.integers(1, n_su + 1, n_li),
        "l_quantity": qty,
        "l_extendedprice": extprice,
        "l_discount": rng.integers(0, 11, n_li),
        "l_tax": rng.integers(0, 9, n_li),
        "l_returnflag": rf,
        "l_linestatus": ls,
        "l_shipdate": np.minimum(ship, MAX_DATE),
        "l_commitdate": np.minimum(commit, MAX_DATE),
        "l_receiptdate": np.minimum(receipt, MAX_DATE),
        "l_shipinstruct": rng.integers(0, len(S.SHIPINSTRUCT), n_li),
        "l_shipmode": rng.integers(0, len(S.SHIPMODES), n_li),
    }

    # ----- nation / region (DRAM-resident) -----
    tables["nation"] = {
        "n_nationkey": np.arange(25),
        "n_regionkey": np.asarray([rk for _, rk in S.NATIONS]),
    }
    tables["region"] = {"r_regionkey": np.arange(5)}

    for t in tables.values():
        for k in t:
            t[k] = np.asarray(t[k], np.int64)
    return tables
