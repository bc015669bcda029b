"""Def-use verifier (pass ``defuse``), the counterpart of
``repro.analysis.defuse``.

Replays the program against the *actual* execution schedule of the
target backend — grouped ReduceSums read their operands at the job's
``exec_at``, arith-batch members read at the batch anchor, and the
``frees_by_instr`` schedule drops registers as the lowering does — and
checks:

* def-before-use: every read names a prior dest, ``__valid__``, or a
  relation attribute;
* use-after-free: no read (including a deferred job's reads) of a
  register the free schedule already dropped;
* double-free / free-of-undefined / free-of-kept-output;
* ``Materialize`` mask-pin consistency: a materialize mask must be in
  the ``keep`` set or the kernel readout would not carry it;
* dead registers (defined, never read, not an output) and leaked
  registers (live at program end without being an output) — warnings;
* duplicate/shadowed destinations (register reassignment, or a dest
  shadowing a relation attribute) — warnings; the batch-legality pass
  escalates them to errors when they break a plan.
"""
from __future__ import annotations

from typing import Dict, List, Set

from repro_torch.core import program as prog

from .diagnostics import Diagnostic
from .passes import PassContext, register_pass


def _d(sev: str, msg: str, i=None, kind=None, reg=None) -> Diagnostic:
    return Diagnostic("defuse", sev, msg, instr_index=i, instr_kind=kind,
                      register=reg)


@register_pass("defuse")
def run(ctx: PassContext) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    instrs = ctx.instrs
    defined: Dict[str, int] = {"__valid__": -1}
    freed: Dict[str, int] = {}
    read_ever: Set[str] = set()

    batch_at = {}
    batched = frozenset()
    if ctx.arith is not None:
        batch_at = {b[0]: b for b in ctx.arith.batches}
        batched = ctx.arith.batched_indices
    jobs_at: Dict[int, list] = {}
    deferred_sums = ctx.plan is not None
    if ctx.plan is not None:
        for job in ctx.plan.sum_jobs:
            jobs_at.setdefault(job.exec_at, []).append(job)

    def check_read(r: str, i: int, kind: str, what: str) -> None:
        read_ever.add(r)
        if r not in defined and not ctx.is_source(r):
            diags.append(_d("error",
                            f"{what} reads '{r}' which is neither a prior "
                            "dest nor a relation attribute", i, kind, r))
        elif r in freed:
            diags.append(_d("error",
                            f"{what} reads '{r}' after its free at "
                            f"instruction {freed[r]}", i, kind, r))

    for i, ins in enumerate(instrs):
        kind = ins.kind
        # -- reads at this position under the backend's schedule ----------
        if deferred_sums and kind == "ReduceSum":
            pass                 # operands read at the grouped job's exec_at
        elif i in batch_at:
            for j in batch_at[i]:
                for r in prog.instruction_reads(instrs[j]):
                    check_read(r, i, instrs[j].kind,
                               f"arith-batch member (instruction {j})")
        elif i in batched:
            pass                 # already read at its batch's anchor
        else:
            for r in prog.instruction_reads(ins):
                check_read(r, i, kind, "instruction")

        if kind == "Materialize" and ins.mask != "__valid__" \
                and ins.mask not in ctx.keep:
            diags.append(_d("error",
                            f"materialize mask '{ins.mask}' is not pinned "
                            "in keep: the free schedule may drop it before "
                            "the readout kernel consumes it",
                            i, kind, ins.mask))

        # -- destination bookkeeping --------------------------------------
        # DML write kinds program relation storage, not a register: the
        # dest is an attribute (or the valid plane) by design, so the
        # shadow/duplicate/dead-register bookkeeping does not apply —
        # the kinds pass validates the target instead.
        is_write = kind in ("PlaneWrite", "ValidClear")
        dest = ins.dest
        if not is_write and (i not in batched or i in batch_at):
            if dest in defined and dest != "__valid__":
                diags.append(_d("warning",
                                f"duplicate dest '{dest}' (first defined at "
                                f"instruction {defined[dest]}): register "
                                "reassignment disables reduce grouping and "
                                "arith batching", i, kind, dest))
            elif ctx.is_source(dest):
                diags.append(_d("warning",
                                f"dest '{dest}' shadows a relation "
                                "attribute: later reads resolve to the "
                                "register, not the source planes",
                                i, kind, dest))
            if dest in freed:
                del freed[dest]      # name reuse after free: fresh value
            defined[dest] = i
            if i in batch_at:        # batch members all define at the anchor
                for j in batch_at[i][1:]:
                    defined[instrs[j].dest] = j

        # -- deferred grouped reads, then this position's frees -----------
        for job in jobs_at.get(i, ()):
            for r in (job.attr, *job.masks):
                check_read(r, i, "ReduceSum",
                           f"grouped reduce job (exec_at {job.exec_at})")
        if ctx.frees is not None and i < len(ctx.frees):
            for r in ctx.frees[i]:
                if r in freed:
                    diags.append(_d("error",
                                    f"double free of '{r}' (first freed at "
                                    f"instruction {freed[r]})", i, kind, r))
                elif r not in defined:
                    sev = "warning" if ctx.is_source(r) else "error"
                    what = ("relation attribute (free is a no-op)"
                            if ctx.is_source(r) else "undefined register")
                    diags.append(_d(sev, f"free of {what} '{r}'",
                                    i, kind, r))
                elif r in ctx.keep:
                    diags.append(_d("error",
                                    f"free of kept output '{r}'",
                                    i, kind, r))
                else:
                    freed[r] = i

    # -- end-of-program: dead and leaked registers -------------------------
    reg_kind = ctx.analysis.reg_kind if ctx.analysis is not None else {}
    for name, i in defined.items():
        if name == "__valid__" or name in ctx.keep:
            continue
        if reg_kind.get(name) in ("scalar", "values"):
            continue             # host-side outputs, not plane registers
        kind = instrs[i].kind
        if name not in read_ever:
            diags.append(_d("warning",
                            f"dead register '{name}': defined but never "
                            "read and not an output", i, kind, name))
        if ctx.frees is not None and name not in freed:
            diags.append(_d("warning",
                            f"leaked register '{name}': still live at "
                            "program end without being an output (its "
                            "planes are never reused)", i, kind, name))
    return diags
