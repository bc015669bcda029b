"""NumPy mutable-table oracle for DML parity checks.

The counterpart of ``repro.dml.oracle``, equal to it apart from this note
and its import lines.

An independent reimplementation of the mutation semantics over plain
column arrays — no bit-planes, no slots, no allocator. Tests and the
``htap_stream`` bench drive the same logical mutation stream through a
:class:`MutableTable` and through ``PimDatabase.apply``, then compare
query results bit-for-bit; the two bookkeeping paths share nothing but
the mutation specs, so agreement is evidence, not tautology.

Logical row ids follow the same scheme the DML layer uses: the initial
load gets ids ``0..n-1``, every inserted row the next monotonic id.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.db import queries as Q

from .mutations import Compact, Delete, Insert, Update


class MutableTable:
    """Mutable columnar table keyed by logical row id."""

    def __init__(self, columns: Mapping[str, np.ndarray]) -> None:
        self.cols: Dict[str, np.ndarray] = {
            name: np.asarray(col, dtype=np.int64).copy()
            for name, col in columns.items()}
        n = next(iter(self.cols.values())).shape[0] if self.cols else 0
        self.ids = np.arange(n, dtype=np.int64)
        self.next_id = n

    # -- state ------------------------------------------------------------
    @property
    def n_rows(self) -> int:
        return int(self.ids.shape[0])

    def columns(self) -> Dict[str, np.ndarray]:
        """Live columns in logical-id order (the ``db.tables`` view)."""
        return dict(self.cols)

    def _select(self, pred=None, row_ids: Optional[Sequence[int]] = None
                ) -> np.ndarray:
        """Boolean mask over the current live rows."""
        if row_ids is not None:
            return np.isin(self.ids, np.asarray(row_ids, dtype=np.int64))
        if pred is not None:
            return np.asarray(Q.eval_pred(self.cols, pred), dtype=bool)
        return np.zeros(self.n_rows, dtype=bool)

    # -- mutations --------------------------------------------------------
    def insert(self, rows: Mapping[str, Sequence[int]]) -> List[int]:
        if set(rows) != set(self.cols):
            raise ValueError(
                f"insert columns {sorted(rows)} != table columns "
                f"{sorted(self.cols)}")
        k = len(np.asarray(next(iter(rows.values()))))
        for name in self.cols:
            vals = np.asarray(rows[name], dtype=np.int64)
            if vals.shape[0] != k:
                raise ValueError(f"insert column {name} length mismatch")
            self.cols[name] = np.concatenate([self.cols[name], vals])
        new_ids = np.arange(self.next_id, self.next_id + k, dtype=np.int64)
        self.ids = np.concatenate([self.ids, new_ids])
        self.next_id += k
        return [int(i) for i in new_ids]

    def delete(self, pred=None, row_ids: Optional[Sequence[int]] = None
               ) -> int:
        mask = self._select(pred, row_ids)
        keep = ~mask
        for name in self.cols:
            self.cols[name] = self.cols[name][keep]
        self.ids = self.ids[keep]
        return int(mask.sum())

    def update(self, assignments: Mapping[str, object], pred=None,
               row_ids: Optional[Sequence[int]] = None) -> int:
        mask = self._select(pred, row_ids)
        k = int(mask.sum())
        for name, val in assignments.items():
            if name not in self.cols:
                raise KeyError(f"unknown column {name!r}")
            v = np.asarray(val, dtype=np.int64)
            self.cols[name][mask] = v if v.ndim == 0 else v[:k]
        return k

    def apply(self, mutation) -> None:
        """Dispatch one mutation spec (Compact is a no-op here: it only
        rearranges physical slots, never logical contents)."""
        if isinstance(mutation, Insert):
            self.insert(mutation.rows)
        elif isinstance(mutation, Delete):
            self.delete(mutation.pred, mutation.row_ids)
        elif isinstance(mutation, Update):
            self.update(mutation.assignments, mutation.pred,
                        mutation.row_ids)
        elif isinstance(mutation, Compact):
            pass
        else:
            raise TypeError(f"not a DML mutation: {mutation!r}")

    # -- query helpers ----------------------------------------------------
    def aggregate(self, pred, aggs) -> tuple:
        """Filter + aggregate over live rows — the oracle for
        ``filter_only`` query specs (order-insensitive, so slot order
        vs logical order never matters)."""
        mask = (np.ones(self.n_rows, dtype=bool) if pred is None
                else np.asarray(Q.eval_pred(self.cols, pred), dtype=bool))
        return tuple(Q.eval_aggregate(self.cols, mask, agg) for agg in aggs)
