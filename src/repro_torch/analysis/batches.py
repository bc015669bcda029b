"""Batch-legality prover (pass ``batches``), the counterpart of
``repro.analysis.batches``.

Independently re-proves the two soundness claims the fused lowering relies
on, instead of trusting the planners that made them:

* **Arith batches** (``plan_arith``): a batch executes every member at
  the *first* member's position, so the proof obligation is that no
  member reads another member's dest and every operand each member reads
  was produced strictly before the anchor. Both planners also require
  single-assignment — if any dest is reassigned, a non-empty plan is
  itself an error.

* **Grouped reduces** (``plan_reduces``): a SumJob defers its members'
  popcounts to the *last* member's position, so between a member and the
  job's ``exec_at`` nothing may redefine the shared source plane stack or
  any member's group mask (including a register dest that *shadows* a
  source attribute — a hazard ``plan_reduces``' own liveness extension
  cannot see). Job bookkeeping is cross-checked too: every ReduceSum
  dest resolves through ``dest_slot`` to a job whose attr/mask/width
  match the instruction, ``exec_at`` is the max member index, and the
  popcount / MIN-MAX accumulator column ranges are in-bounds and
  pairwise disjoint.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.core import program as prog

from .diagnostics import Diagnostic
from .passes import PassContext, register_pass


def _d(sev: str, msg: str, i=None, kind=None, reg=None) -> Diagnostic:
    return Diagnostic("batches", sev, msg, instr_index=i, instr_kind=kind,
                      register=reg)


@register_pass("batches")
def run(ctx: PassContext) -> List[Diagnostic]:
    if ctx.plan is None and ctx.arith is None:
        return []                        # eager backend: nothing to prove
    diags: List[Diagnostic] = []
    instrs = ctx.instrs

    producer: Dict[str, int] = {}
    reassigned = False
    for i, ins in enumerate(instrs):
        if ins.dest in producer:
            reassigned = True
        producer[ins.dest] = i

    if reassigned:
        # Neither deferral nor batching is sound without single
        # assignment; the planners must have emitted degenerate plans.
        if ctx.arith is not None and ctx.arith.batches:
            diags.append(_d("error",
                            "arith batches planned for a non-SSA program: "
                            "early execution may read a stale value",
                            ctx.arith.batches[0][0],
                            instrs[ctx.arith.batches[0][0]].kind))
        if ctx.plan is not None:
            for job in ctx.plan.sum_jobs:
                at = instrs[job.exec_at] if job.exec_at < len(instrs) \
                    else None
                if len(job.masks) > 1 or at is None or \
                        at.kind != "ReduceSum" or at.attr != job.attr:
                    diags.append(_d("error",
                                    f"grouped reduce job over '{job.attr}' "
                                    "defers popcounts in a non-SSA program",
                                    job.exec_at, "ReduceSum", job.attr))
        return diags

    # -- arith batches: independence at the anchor --------------------------
    if ctx.arith is not None:
        for batch in ctx.arith.batches:
            anchor = batch[0]
            dests = {instrs[j].dest for j in batch}
            if list(batch) != sorted(batch):
                diags.append(_d("error",
                                f"arith batch {batch} is not in ascending "
                                "instruction order", anchor,
                                instrs[anchor].kind))
            for j in batch:
                ins = instrs[j]
                if ins.kind not in prog._DERIVED_KINDS:
                    diags.append(_d("error",
                                    f"arith batch member {j} is {ins.kind}, "
                                    "not a derived-arith instruction",
                                    j, ins.kind, ins.dest))
                    continue
                for r in prog.instruction_reads(ins):
                    if r in dests and r != ins.dest:
                        diags.append(_d("error",
                                        f"batch member {j} reads '{r}', the "
                                        "dest of another member: members "
                                        "are not independent", j, ins.kind,
                                        r))
                    elif producer.get(r, -1) >= anchor and \
                            r not in dests:
                        diags.append(_d("error",
                                        f"batch member {j} reads '{r}' "
                                        f"produced at instruction "
                                        f"{producer[r]}, at/after the "
                                        f"batch anchor {anchor}: early "
                                        "execution would read an undefined "
                                        "value", j, ins.kind, r))

    # -- grouped reduces: deferral safety + bookkeeping ---------------------
    if ctx.plan is not None:
        plan = ctx.plan
        jobs_members: List[List[Tuple[int, "object"]]] = \
            [[] for _ in plan.sum_jobs]
        for i, ins in enumerate(instrs):
            if ins.kind != "ReduceSum":
                continue
            slot = plan.dest_slot.get(ins.dest)
            if slot is None:
                diags.append(_d("error",
                                f"ReduceSum dest '{ins.dest}' has no slot "
                                "in the reduce plan: its readout would be "
                                "missing", i, ins.kind, ins.dest))
                continue
            j, gidx = slot
            job = plan.sum_jobs[j]
            jobs_members[j].append((i, ins))
            if job.attr != ins.attr:
                diags.append(_d("error",
                                f"dest '{ins.dest}' slotted into a job "
                                f"over '{job.attr}' but reduces "
                                f"'{ins.attr}'", i, ins.kind, ins.dest))
            if gidx >= len(job.masks) or job.masks[gidx] != ins.mask:
                diags.append(_d("error",
                                f"dest '{ins.dest}' slot points at mask "
                                f"column {gidx} of job {j}, which is not "
                                f"its mask '{ins.mask}'", i, ins.kind,
                                ins.dest))

        for j, job in enumerate(plan.sum_jobs):
            members = jobs_members[j]
            if not members:
                diags.append(_d("error",
                                f"reduce job {j} over '{job.attr}' has no "
                                "member instructions", job.exec_at,
                                "ReduceSum", job.attr))
                continue
            want_exec = max(i for i, _ in members)
            if job.exec_at != want_exec:
                diags.append(_d("error",
                                f"reduce job {j} executes at "
                                f"{job.exec_at}, not at its last member "
                                f"({want_exec}): a later member's mask "
                                "state would be missed", job.exec_at,
                                "ReduceSum", job.attr))
            for i, ins in members:
                for r in (ins.attr, ins.mask):
                    for k in range(i + 1, max(job.exec_at, i) + 1):
                        if instrs[k].dest == r:
                            diags.append(_d(
                                "error",
                                f"deferred popcount of member {i} is "
                                f"unsound: '{r}' is overwritten at "
                                f"instruction {k}, before the job "
                                f"executes at {job.exec_at}",
                                i, ins.kind, r))
                            break

        # Accumulator column layout: in-bounds, pairwise disjoint.
        ranges: List[Tuple[int, int, str]] = []
        for j, job in enumerate(plan.sum_jobs):
            lo, hi = job.col_start, job.col_start + job.n_cols
            if lo < 0 or hi > plan.n_pc_cols:
                diags.append(_d("error",
                                f"reduce job {j} columns [{lo}, {hi}) "
                                f"exceed the popcount accumulator "
                                f"({plan.n_pc_cols} cols)", job.exec_at,
                                "ReduceSum", job.attr))
            ranges.append((lo, hi, f"sum job {j}"))
        _check_disjoint(ranges, "popcount accumulator", diags)

        ranges = []
        for j, job in enumerate(plan.mm_jobs):
            lo, hi = job.col_start, job.col_start + job.width + 1
            if lo < 0 or hi > plan.n_mm_cols:
                diags.append(_d("error",
                                f"min/max job {j} columns [{lo}, {hi}) "
                                f"exceed the candidate buffer "
                                f"({plan.n_mm_cols} cols)", job.exec_at,
                                "ReduceMinMax", job.dest))
            if job.exec_at >= len(instrs) or \
                    instrs[job.exec_at].dest != job.dest:
                diags.append(_d("error",
                                f"min/max job {j} exec_at {job.exec_at} "
                                f"does not point at its own ReduceMinMax "
                                f"('{job.dest}')", job.exec_at,
                                "ReduceMinMax", job.dest))
            ranges.append((lo, hi, f"min/max job {j}"))
        _check_disjoint(ranges, "min/max candidate buffer", diags)
    return diags


def _check_disjoint(ranges: List[Tuple[int, int, str]], what: str,
                    diags: List[Diagnostic]) -> None:
    for n, (lo, hi, name) in enumerate(sorted(ranges)):
        if n and lo < prev_hi:
            diags.append(_d("error",
                            f"{name} columns [{lo}, {hi}) overlap "
                            f"{prev_name} in the {what}"))
        prev_hi, prev_name = hi, name
