"""TPC-H refresh functions (Clause 2.5) and the reference's versioned copy.

Refresh ``k`` (1, 2, 3, ...) is RF1 for odd ``k`` and RF2 for even ``k``,
its data drawn from ``(seed, k)`` alone, so a seed gives the same stream
however many refreshes a run reaches.

* RF1 inserts ``SF x 1,500`` new orders, with keys above every key the
  tables hold, each with 1 to 7 lineitems, their values drawn as the
  frozen generator (``tpch_gen``) draws them.
* RF2 deletes ``SF x 1,500`` orders of the initial population, in key
  order (the j-th RF2 the keys ``[j * n + 1, (j + 1) * n]``), with their
  lineitems.

:class:`VersionedTables` is the reference's own copy: the generated rows
and every inserted row, each with the state it was born at and the state
it died at (state ``s`` = after refresh ``s``), so the tables at any state
can be read back after the window.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from . import tpch_gen
from . import tpch_schema as S

MUTABLE = ("orders", "lineitem")
_NEVER = np.iinfo(np.int32).max


class VersionedTables:
    def __init__(self, tables: Dict[str, Dict[str, np.ndarray]], sf: float,
                 seed: int, orders_per_sf: int = 1500,
                 lineitems_per_order=(1, 7)):
        self.base = tables
        self.seed = seed
        self.n_per_rf = max(1, int(round(sf * orders_per_sf)))
        self.li_range = tuple(lineitems_per_order)
        self.n_customers = tables["customer"]["c_custkey"].shape[0]
        self.n_parts = tables["part"]["p_partkey"].shape[0]
        self.n_suppliers = tables["supplier"]["s_suppkey"].shape[0]
        self.n_orders0 = tables["orders"]["o_orderkey"].shape[0]
        self.max_key0 = int(tables["orders"]["o_orderkey"].max())
        self._chunks: Dict[str, List[Dict[str, np.ndarray]]] = {
            r: [] for r in MUTABLE}
        self._born: Dict[str, List[np.ndarray]] = {r: [] for r in MUTABLE}
        self._deletes: List[tuple] = []         # (state, lo, hi)
        self.state = 0
        self._final = None

    # -- the stream -------------------------------------------------------
    def make(self, k: int) -> dict:
        """Refresh ``k``'s data, recorded into the reference's copy.
        Refreshes are made in order: ``k`` is the next state."""
        if k != self.state + 1:
            raise ValueError(f"refresh {k} after state {self.state}")
        self.state = k
        self._final = None
        rng = np.random.default_rng([self.seed, 3, k])
        if k % 2:
            return self._rf1(k, (k - 1) // 2, rng)
        return self._rf2(k, k // 2 - 1)

    def _rf1(self, k: int, j: int, rng) -> dict:
        n = self.n_per_rf
        keys = self.max_key0 + j * n + 1 + np.arange(n)
        odate = tpch_gen._dates(rng, n)
        orders = {
            "o_orderkey": keys,
            "o_custkey": rng.integers(1, self.n_customers + 1, n),
            "o_orderstatus": rng.integers(0, len(S.ORDERSTATUS), n),
            "o_totalprice": rng.integers(85000, 55528700, n),
            "o_orderdate": odate,
            "o_orderpriority": rng.integers(0, len(S.PRIORITIES), n),
            "o_shippriority": np.zeros(n, np.int64),
        }
        per = rng.integers(self.li_range[0], self.li_range[1] + 1, n)
        oidx = np.repeat(np.arange(n), per)
        m = oidx.size
        pkey = rng.integers(1, self.n_parts + 1, m)
        qty = rng.integers(1, 51, m)
        retail = 90000 + (pkey // 10) % 20001 + 100 * (pkey % 1000)
        ship = odate[oidx] + rng.integers(1, 122, m)
        commit = odate[oidx] + rng.integers(30, 91, m)
        receipt = ship + rng.integers(1, 31, m)
        cur = S.date_to_days("1995-06-17")
        lineitem = {
            "l_orderkey": keys[oidx],
            "l_partkey": pkey,
            "l_suppkey": rng.integers(1, self.n_suppliers + 1, m),
            "l_quantity": qty,
            "l_extendedprice": qty * retail,
            "l_discount": rng.integers(0, 11, m),
            "l_tax": rng.integers(0, 9, m),
            "l_returnflag": np.where(receipt <= cur,
                                     rng.integers(0, 2, m), 2),
            "l_linestatus": np.where(ship > cur, 0, 1),
            "l_shipdate": np.minimum(ship, tpch_gen.MAX_DATE),
            "l_commitdate": np.minimum(commit, tpch_gen.MAX_DATE),
            "l_receiptdate": np.minimum(receipt, tpch_gen.MAX_DATE),
            "l_shipinstruct": rng.integers(0, len(S.SHIPINSTRUCT), m),
            "l_shipmode": rng.integers(0, len(S.SHIPMODES), m),
        }
        rows = {"orders": orders, "lineitem": lineitem}
        for rel, cols in rows.items():
            for c in cols:
                cols[c] = np.asarray(cols[c], np.int64)
            self._chunks[rel].append(cols)
            self._born[rel].append(np.full(len(cols[next(iter(cols))]), k,
                                           np.int32))
        return {"k": k, "kind": "RF1", "rows": rows, "n_rows": n + m}

    def _rf2(self, k: int, j: int) -> dict:
        n = self.n_per_rf
        lo, hi = j * n + 1, min((j + 1) * n, self.n_orders0)
        if lo > hi:
            raise RuntimeError("RF2 ran out of initial orders")
        o = self.base["orders"]["o_orderkey"]
        li = self.base["lineitem"]["l_orderkey"]
        n_rows = (int(np.count_nonzero((o >= lo) & (o <= hi)))
                  + int(np.count_nonzero((li >= lo) & (li <= hi))))
        self._deletes.append((k, lo, hi))
        return {"k": k, "kind": "RF2", "keys": (lo, hi), "n_rows": n_rows}

    # -- the reference's view -----------------------------------------------
    def _finalize(self):
        if self._final is None:
            tables = dict(self.base)
            born, died = {}, {}
            for rel in MUTABLE:
                chunks = [self.base[rel]] + self._chunks[rel]
                tables[rel] = {c: np.concatenate([ch[c] for ch in chunks])
                               for c in self.base[rel]}
                n0 = self.base[rel][next(iter(self.base[rel]))].shape[0]
                born[rel] = np.concatenate(
                    [np.zeros(n0, np.int32)] + self._born[rel])
                died[rel] = np.full(born[rel].shape, _NEVER, np.int32)
            keys = {"orders": tables["orders"]["o_orderkey"],
                    "lineitem": tables["lineitem"]["l_orderkey"]}
            for k, lo, hi in self._deletes:
                for rel in MUTABLE:
                    hit = ((keys[rel] >= lo) & (keys[rel] <= hi)
                           & (born[rel] < k) & (died[rel] == _NEVER))
                    died[rel][hit] = k
            self._final = (tables, born, died)
        return self._final

    def view(self, state: int):
        """(tables, live) at ``state``: ``live`` marks, for each mutable
        relation, the rows present after refresh ``state``."""
        tables, born, died = self._finalize()
        live = {rel: (born[rel] <= state) & (died[rel] > state)
                for rel in MUTABLE}
        return tables, live
