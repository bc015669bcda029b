"""Mutation specs — the DML surface of ``PimDatabase.apply``.

The counterpart of ``repro.dml.mutations``, equal to it apart from this note
and its import lines.

Each mutation names its target relation and carries the *encoded*
integer values (the same dict-id / cents / day-offset domain
``db.tpch.generate`` produces and ``db.schema`` decodes). Selection is
either an explicit list of logical row ids (stable across slot moves
and compaction) or a ``db.compiler`` predicate — the same AST the query
filters use, evaluated over the relation's live rows.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Insert:
    """Append rows. ``rows`` maps every relation attribute to an equal-
    length sequence of encoded values."""
    relation: str
    rows: Mapping[str, Sequence[int]]


@dataclasses.dataclass(frozen=True)
class Delete:
    """Clear the valid bit of the selected rows. Exactly one of ``pred``
    (compiler predicate over live rows) or ``row_ids`` (logical ids)
    selects; both ``None`` deletes nothing."""
    relation: str
    pred: Optional[object] = None
    row_ids: Optional[Sequence[int]] = None


@dataclasses.dataclass(frozen=True)
class Update:
    """Assign new encoded values to the selected rows.

    In-place plane rewrite when every assigned value fits its
    attribute's bit width ("widths permit"); otherwise delete+insert —
    the row moves through the allocator to a fresh slot and the
    attribute's plane stack is widened (zero-extended) to hold the new
    value, a deliberate layout change that recompiles dependent
    programs. ``assignments`` maps attr -> scalar (applied to every
    selected row) or per-row sequence.
    """
    relation: str
    assignments: Mapping[str, object]
    pred: Optional[object] = None
    row_ids: Optional[Sequence[int]] = None


@dataclasses.dataclass(frozen=True)
class Compact:
    """Garbage-collect deleted rows: repack every live row into the
    lowest slots (logical order), clear the rest, reset the watermark.
    Wear counters persist — compaction is itself write pressure."""
    relation: str


Mutation = (Insert, Delete, Update, Compact)


def mutation_relation(m) -> str:
    if not isinstance(m, Mutation):
        raise TypeError(f"not a DML mutation: {m!r}")
    return m.relation
