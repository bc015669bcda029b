"""Trace-level write pressure: the cell writes each instruction costs the
busiest crossbar row (``isa.row_write_ops``, Table 3/4 semantics),
attributed to the destination register whose planes absorb them.

``db.database.cost_report`` feeds :func:`write_profile`'s
``busiest_row_ops`` into ``cost_model.endurance_ops_per_cell``, so the
§6.4 lifetime estimate tracks the trace. The reference's ``endurance``
verifier pass over the same profile (its hotspot report and warning, and
its ``register_pass``) comes with the verifier (ROADMAP A9).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

from repro_torch.core import isa


@dataclasses.dataclass(frozen=True)
class WriteProfile:
    """Static per-register write pressure of one ISA trace."""
    per_register: Tuple[Tuple[str, float], ...]   # (dest, writes) desc
    busiest_row_ops: float                        # total, whole trace

    def top(self, n: int = 3) -> Tuple[Tuple[str, float], ...]:
        return self.per_register[:n]


def write_profile(instrs: Sequence[isa.PimInstruction]) -> WriteProfile:
    """Accumulate ``row_write_ops`` per destination register."""
    per: Dict[str, float] = {}
    total = 0.0
    for ins in instrs:
        ops = ins.row_write_ops()
        per[ins.dest] = per.get(ins.dest, 0.0) + ops
        total += ops
    ranked = tuple(sorted(per.items(), key=lambda kv: (-kv[1], kv[0])))
    return WriteProfile(ranked, total)
