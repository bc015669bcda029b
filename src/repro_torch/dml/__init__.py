"""Mutable relations with an endurance-aware write model.

The counterpart of ``repro.dml``. DELETE = valid-plane clears, INSERT =
append-segment tail writes, UPDATE = in-place plane rewrite (or
delete+insert when widths demand a layout change), COMPACT = GC repack.
Every mutation is an ISA-level write program (``isa.PlaneWrite`` /
``isa.ValidClear``) executed on the relation's device, so the cost model
and the endurance analysis meter real per-cell write pressure, and a
rotation-based wear-leveling allocator flattens the busiest-row profile
against first-fit.
"""
from .apply import MutationStats, RelationDml
from .mutations import (Compact, Delete, Insert, Mutation, Update,
                        mutation_relation)
from .oracle import MutableTable
from .segments import GROWTH_SLOTS, AppendSegments, SlotEvent, replay

__all__ = [
    "AppendSegments", "Compact", "Delete", "GROWTH_SLOTS", "Insert",
    "MutableTable", "Mutation", "MutationStats", "RelationDml",
    "SlotEvent", "Update", "mutation_relation", "replay",
]
