"""Trace-level endurance / write-pressure analysis (pass ``endurance``),
the counterpart of ``repro.analysis.endurance``.

The cost model's §6.4 endurance estimate was derived from *class
aggregates* (total filter cycles, total reduce cycles, ...). This pass
walks the actual ISA trace instead: every instruction contributes its
``row_write_ops()`` — the cell writes it costs the busiest crossbar row
under the Table 3/4 semantics (column-wise cycles write one cell per row;
row-wise reduce/transform cycles amortize across rows) — attributed to
the *destination* register whose planes absorb the conditioning.

:func:`write_profile` is the public API: ``db.database.cost_report``
feeds its ``busiest_row_ops`` into ``cost_model.endurance_ops_per_cell``
so the lifetime estimate tracks the trace rather than the aggregate
approximation. The pass itself reports (``info``) the program's total
write pressure and its hotspot registers, and warns when a single
register concentrates most of a heavy program's writes — the §6.4 wear
anti-pattern (one accumulator rewritten all query long) that row
remapping cannot help with inside one program.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.core import isa

from .diagnostics import Diagnostic
from .passes import PassContext, register_pass

#: A single register absorbing more than this share of a program's writes
#: (and more than _HOTSPOT_MIN_OPS total) is flagged as a wear hotspot.
_HOTSPOT_SHARE = 0.5
_HOTSPOT_MIN_OPS = 5000.0


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


def _d(sev: str, msg: str, i=None, kind=None, reg=None) -> Diagnostic:
    return Diagnostic("endurance", sev, msg, instr_index=i, instr_kind=kind,
                      register=reg)


@register_pass("endurance")
def run(ctx: PassContext) -> List[Diagnostic]:
    profile = write_profile(ctx.instrs)
    diags: List[Diagnostic] = [
        _d("info",
           f"trace write pressure: {profile.busiest_row_ops:.1f} "
           f"busiest-row cell writes over {len(ctx.instrs)} instructions")
    ]
    for reg, ops in profile.top(3):
        diags.append(_d("info",
                        f"write hotspot: {ops:.1f} cell writes "
                        f"({ops / max(profile.busiest_row_ops, 1e-9):.0%} "
                        "of the trace)", reg=reg))
    if profile.per_register:
        reg, ops = profile.per_register[0]
        share = ops / max(profile.busiest_row_ops, 1e-9)
        if share > _HOTSPOT_SHARE and ops > _HOTSPOT_MIN_OPS:
            diags.append(_d("warning",
                            f"register '{reg}' absorbs {share:.0%} of the "
                            f"program's cell writes ({ops:.1f} ops): wear "
                            "concentrates on its planes and intra-program "
                            "row remapping cannot spread it", reg=reg))
    return diags
