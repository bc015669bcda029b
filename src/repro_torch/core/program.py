"""Program-level fused execution: one kernel launch per relation program.

The counterpart of ``repro.core.program``. :func:`compile_program` takes
the full ``isa.PimInstruction`` list a :class:`~repro_torch.db.compiler.
Compiler` emits for one relation (predicate DAG + valid-AND +
aggregates), plans it exactly as the reference does (``analyze_program``,
``plan_reduces``, ``plan_arith``, ``frees_by_instr``) and lowers it ONCE
into a plane-op tape (``kernels.program``): the :class:`BitwiseEvaluator`
runs over symbolic plane handles following the reference Pallas kernel's
schedule, and every bitwise op it performs becomes a tape entry.
:func:`run_program` then launches the tape as ONE kernel over the stacked
source planes and weights the popcounts exactly on the host. Each
``Materialize`` instruction is one more launch, of the materialize kernel
(``kernels.materialize``), over its attributes' planes and a mask the
program kernel stored; its values stay on the device until
``ProgramResult.materialized`` copies the selected prefix.

:func:`link_programs` merges several queries' programs over one relation
into one SSA program (shared subexpressions value-numbered away, colliding
registers renamed); compiled with its ``query_slots``, it is still one
launch, and :meth:`ProgramResult.query` reads each query's outputs back
under its own register names.

On a tape-cache miss :func:`compile_program` first runs the static
verifier (``analysis.passes.verify_compile``, the ``"fused"`` backend) over
the plan, so a program the passes reject raises
``ProgramVerificationError`` before any tape is recorded or launched.

Compiled with a ``mesh`` (``core.distributed``), the same tape runs on a
relation split over the mesh's shard axes: one program launch a shard over
that shard's words, the shards' popcounts summed, their MIN/MAX candidates
combined, each shard's masks and materialized values left on its device
until the host reads them (``ProgramResult`` stitches them in shard
order). ``n_dispatches`` stays 1, the reference's logical count.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import math
import os
import threading
from typing import (Callable, Dict, FrozenSet, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.kernels import materialize as kmat
from repro_torch.kernels import program as kprog
from . import bitslice, isa, spans
from . import engine as eng
from .distributed import Mesh, combine_minmax_candidates, mesh_shard_axes

_REDUCE_KINDS = ("ReduceSum", "ReduceMinMax")
_DERIVED_KINDS = ("AddImm", "Add", "Subtract", "Multiply")


# --------------------------------------------------------------------------
# Static analysis: operand reads, register kinds, liveness
# --------------------------------------------------------------------------
def instruction_reads(ins: isa.PimInstruction) -> List[str]:
    """Register/attribute names an instruction reads, in operand order."""
    k = ins.kind
    if k in ("EqualImm", "NotEqualImm", "LessThanImm", "GreaterThanImm",
             "AddImm"):
        return [ins.attr]
    if k in ("Equal", "LessThan", "Add", "Subtract"):
        return [ins.attr_a, ins.attr_b]
    if k == "Multiply":
        return [ins.attr_a] + ([ins.attr_b] if ins.attr_b else [])
    if k in ("BitwiseAnd", "BitwiseOr"):
        return [ins.src_a, ins.src_b]
    if k == "BitwiseNot":
        return [ins.src]
    if k in ("SetReset", "PlaneWrite", "ValidClear"):
        return []
    if k in _REDUCE_KINDS:
        return [ins.attr, ins.mask]
    if k == "Materialize":
        return [*ins.attrs, ins.mask]
    if k == "ColumnTransform":
        return [ins.mask]
    raise ValueError(f"unknown instruction {k}")


@dataclasses.dataclass(frozen=True)
class ProgramAnalysis:
    """Liveness / plane-usage facts about one instruction program."""
    source_attrs: Tuple[str, ...]          # relation attributes read
    reg_kind: Mapping[str, str]            # register -> mask|derived|scalar
    widths: Mapping[str, int]              # register -> planes it occupies
    last_use: Mapping[str, int]            # register -> last reading instr
    peak_live_planes: int                  # max simultaneously-live planes
    total_reg_planes: int                  # planes if nothing were freed


def analyze_program(instrs: Sequence[isa.PimInstruction],
                    relation: eng.PimRelation,
                    keep: Sequence[str] = ()) -> ProgramAnalysis:
    """Classify registers, find source attributes, compute liveness.

    ``keep`` registers are pinned live through the end of the program
    (the outputs the caller will read).
    """
    reg_kind: Dict[str, str] = {"__valid__": "mask"}
    widths: Dict[str, int] = {"__valid__": 1}
    last_use: Dict[str, int] = {}
    source: List[str] = []
    for i, ins in enumerate(instrs):
        for r in instruction_reads(ins):
            if r in reg_kind:
                last_use[r] = i
            else:
                if r not in relation.planes:
                    from repro_torch.analysis import ProgramVerificationError
                    raise ProgramVerificationError.single(
                        "analyze",
                        f"reads '{r}' which is neither a prior dest nor a "
                        "relation attribute", instr_index=i,
                        instr_kind=ins.kind, register=r)
                if r not in source:
                    source.append(r)
        k = ins.kind
        if k in ("PlaneWrite", "ValidClear"):
            continue
        if k in _REDUCE_KINDS:
            reg_kind[ins.dest] = "scalar"
            widths[ins.dest] = 0
        elif k == "Materialize":
            reg_kind[ins.dest] = "values"
            widths[ins.dest] = 0
        elif k in _DERIVED_KINDS:
            reg_kind[ins.dest] = "derived"
            widths[ins.dest] = ins.n_bits
        elif k == "BitwiseNot" and reg_kind.get(ins.src) != "mask":
            # Attribute NOT (the imm - attr path): multi-plane result.
            reg_kind[ins.dest] = "derived"
            widths[ins.dest] = ins.n_bits
        else:
            reg_kind[ins.dest] = "mask"
            widths[ins.dest] = 1
    for r in keep:
        last_use[r] = len(instrs)

    # Peak live planes: forward sweep, registers die after their last use.
    live: Dict[str, int] = {}
    peak = 0
    for i, ins in enumerate(instrs):
        if ins.kind in ("PlaneWrite", "ValidClear"):
            continue
        if reg_kind.get(ins.dest) != "scalar":
            live[ins.dest] = widths[ins.dest]
        peak = max(peak, sum(live.values()))
        for r in instruction_reads(ins):
            if r in live and last_use.get(r) == i:
                del live[r]
    total = sum(w for n, w in widths.items() if n != "__valid__")
    return ProgramAnalysis(tuple(source), reg_kind, widths, last_use,
                           peak, total)


# --------------------------------------------------------------------------
# Shared evaluator for the non-reduce ISA subset
# --------------------------------------------------------------------------
class BitwiseEvaluator:
    """Executes the bitwise/arithmetic ISA subset on plane values — here
    the tape recorder's symbolic plane handles (``kernels.program``),
    which turn every op into a tape entry, so the per-immediate op
    specialisation (Algorithm 1) happens while recording. Reduces are the
    caller's job. Mirrors the reference ``Engine.execute`` semantics bit
    for bit, including unrepresentable-immediate short-circuits.
    """

    def __init__(self, plane_source: Callable[[str], object], valid):
        self._source = plane_source
        self.masks: Dict[str, object] = {"__valid__": valid}
        self.derived: Dict[str, object] = {}
        self._valid = valid

    def planes(self, name: str):
        if name in self.derived:
            return self.derived[name]
        if name in self.masks:
            return self.masks[name][None]
        return self._source(name)

    def free(self, name: str) -> None:
        """Drop a dead register."""
        if name != "__valid__":
            self.derived.pop(name, None)
            self.masks.pop(name, None)

    def _zeros(self):
        return torch.zeros_like(self._valid)

    def _ones(self):
        return torch.full_like(self._valid, -1)

    def execute(self, instr: isa.PimInstruction) -> None:
        kind = instr.kind
        if kind in ("EqualImm", "NotEqualImm", "LessThanImm",
                    "GreaterThanImm"):
            p = self.planes(instr.attr)
            if instr.imm >= (1 << len(p)):
                # Unrepresentable immediate: the comparison is constant.
                m = (self._ones() if kind in ("NotEqualImm", "LessThanImm")
                     else self._zeros())
            elif kind == "EqualImm":
                m = eng.eq_imm_planes(p, instr.imm)
            elif kind == "NotEqualImm":
                m = ~eng.eq_imm_planes(p, instr.imm)
            else:
                lt, eq = eng.cmp_imm_planes(p, instr.imm)
                if kind == "LessThanImm":
                    m = (lt | eq) if instr.or_equal else lt
                else:
                    m = ~lt if instr.or_equal else ~(lt | eq)
            self.masks[instr.dest] = m
        elif kind == "Equal":
            _, eq = eng.cmp_planes(self.planes(instr.attr_a),
                                   self.planes(instr.attr_b))
            self.masks[instr.dest] = eq
        elif kind == "LessThan":
            lt, eq = eng.cmp_planes(self.planes(instr.attr_a),
                                    self.planes(instr.attr_b))
            self.masks[instr.dest] = (lt | eq) if instr.or_equal else lt
        elif kind == "BitwiseAnd":
            self.masks[instr.dest] = (self.masks[instr.src_a]
                                      & self.masks[instr.src_b])
        elif kind == "BitwiseOr":
            self.masks[instr.dest] = (self.masks[instr.src_a]
                                      | self.masks[instr.src_b])
        elif kind == "BitwiseNot":
            if instr.src in self.masks:
                self.masks[instr.dest] = ~self.masks[instr.src]
            else:
                self.derived[instr.dest] = ~eng.extend_planes(
                    self.planes(instr.src), instr.n_bits)
        elif kind == "SetReset":
            self.masks[instr.dest] = (self._ones() if instr.value
                                      else self._zeros())
        elif kind == "AddImm":
            self.derived[instr.dest] = eng.add_imm_planes(
                self.planes(instr.attr), instr.imm, instr.n_bits)
        elif kind == "Add":
            self.derived[instr.dest] = eng.add_planes(
                self.planes(instr.attr_a), self.planes(instr.attr_b),
                instr.n_bits)
        elif kind == "Subtract":
            self.derived[instr.dest] = eng.sub_planes(
                self.planes(instr.attr_a), self.planes(instr.attr_b),
                instr.n_bits)
        elif kind == "Multiply":
            if instr.imm is not None:
                self.derived[instr.dest] = eng.mul_imm_planes_csa(
                    self.planes(instr.attr_a), instr.imm, instr.n_bits)
            else:
                self.derived[instr.dest] = eng.mul_planes_csa(
                    self.planes(instr.attr_a), self.planes(instr.attr_b),
                    instr.n_bits)
        elif kind == "ColumnTransform":
            self.masks[instr.dest] = self.masks[instr.mask]
        else:
            raise ValueError(f"non-bitwise instruction {kind} "
                             "must be handled by the caller")

    # -- carry-save arithmetic batching ------------------------------------
    def _arith_terms(self, instr: isa.PimInstruction):
        """Decompose one derived-arith instruction into its carry-save
        addend list: ``(terms, carry_in, out_bits)``. Immediates become
        constant plane stacks; subtract contributes the inverted operand
        with the ``+1`` as the final pass's carry-in."""
        kind = instr.kind
        w = instr.n_bits
        if kind == "AddImm":
            return ([self.planes(instr.attr),
                     eng.imm_planes(instr.imm, w, self._valid)], 0, w)
        if kind == "Add":
            return ([self.planes(instr.attr_a), self.planes(instr.attr_b)],
                    0, w)
        if kind == "Subtract":
            nb = ~eng.extend_planes(self.planes(instr.attr_b), w)
            return ([self.planes(instr.attr_a), nb], 1, w)
        if kind == "Multiply":
            pa = self.planes(instr.attr_a)
            if instr.imm is not None:
                pps = eng.mul_partial_products(pa, None, instr.imm, w)
            else:
                pps = eng.mul_partial_products(pa, self.planes(instr.attr_b),
                                               None, w)
            return (pps, 0, w)
        raise ValueError(f"not a derived-arith instruction: {kind}")

    def execute_arith_batch(self, batch: Sequence[isa.PimInstruction]) -> None:
        """Evaluate independent derived-arith instructions together at the
        batch's anchor: each member's addends CSA-reduce to a (sum, carry)
        pair, then one carry-propagate pass per member. The reference
        stacks those passes into one vectorised pass for XLA; per plane
        op it is the same ripple, so the bits are identical."""
        for ins in batch:
            terms, cin, w = self._arith_terms(ins)
            if not terms:
                self.derived[ins.dest] = torch.stack([self._zeros()] * w)
            elif len(terms) == 1 and not cin:
                self.derived[ins.dest] = eng.extend_planes(terms[0], w)
            else:
                s, c = eng.csa_reduce(terms, w)
                self.derived[ins.dest] = eng.add_planes(s, c, w,
                                                        carry_in=cin)


def _reduce_minmax_bits(planes, mask, is_max: bool,
                        rec: "kprog.TapeRecorder", col_start: int) -> None:
    """MSB-first MIN/MAX narrowing, recorded on the tape. Per tile the
    kernel writes bit ``b`` of the tile's extremum at column
    ``col_start + b`` and whether the tile selects anything at
    ``col_start + width``; :func:`combine_minmax_candidates` reduces the
    tiles and the host maps found=False (empty selection) to None."""
    cand = mask
    for b in range(len(planes) - 1, -1, -1):
        cand = rec.narrow(cand, planes[b], is_max, col_start + b)
    rec.any(mask, col_start + len(planes))


# --------------------------------------------------------------------------
# Reduce planning: grouped popcounts + in-kernel MIN/MAX jobs
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SumJob:
    """All ReduceSums over one source plane stack, coalesced.

    The popcount executes once, at instruction index ``exec_at`` (the last
    member's position), against the whole stack of ``masks``. Columns
    ``[col_start, col_start + width * len(masks))`` of the popcount
    accumulator hold the per-(bit, group) partials, bit-major: column
    ``col_start + b * len(masks) + g`` is (bit b, mask g).
    """
    attr: str
    masks: Tuple[str, ...]           # unique mask registers, stack order
    width: int                       # planes of the shared operand
    exec_at: int                     # instruction index the job runs at
    col_start: int

    @property
    def n_cols(self) -> int:
        return self.width * len(self.masks)


@dataclasses.dataclass(frozen=True)
class MinMaxJob:
    """One ReduceMinMax, lowered into the kernel at its own position:
    ``width`` candidate bits plus a found flag per tile at columns
    ``[col_start, col_start + width]`` of the per-tile MIN/MAX output."""
    dest: str
    attr: str
    mask: str
    width: int
    is_max: bool
    exec_at: int
    col_start: int


@dataclasses.dataclass(frozen=True)
class ReducePlan:
    """Grouped reduce jobs + liveness extended across job deferral."""
    sum_jobs: Tuple[SumJob, ...]
    mm_jobs: Tuple[MinMaxJob, ...]
    dest_slot: Mapping[str, Tuple[int, int]]  # sum dest -> (job, mask idx)
    last_use: Mapping[str, int]               # analysis.last_use, extended
    n_pc_cols: int                            # popcount accumulator columns
    n_mm_cols: int                            # per-tile MIN/MAX columns
    plane_reads: int                          # agg plane reads/pass, grouped
    plane_reads_ungrouped: int                # one read per ReduceSum/MinMax


def plan_reduces(instrs: Sequence[isa.PimInstruction],
                 analysis: ProgramAnalysis,
                 widths: Mapping[str, int]) -> ReducePlan:
    """Coalesce ReduceSums sharing a source plane stack into grouped jobs.

    Grouping defers a member's popcount to the last member's position,
    which is only sound while registers are single-assignment; if a
    destination is ever reassigned, every reduce becomes a singleton job
    at its own position. Identical (attr, mask) pairs share one
    accumulator column.
    """
    seen_dests: set = set()
    ssa = True
    for ins in instrs:
        if ins.dest in seen_dests:
            ssa = False
        seen_dests.add(ins.dest)

    def op_width(ins) -> int:
        if analysis.reg_kind.get(ins.attr) == "mask":
            return 1
        return analysis.widths.get(ins.attr, widths.get(ins.attr, ins.n_bits))

    members: Dict[str, List[Tuple[int, str, str]]] = {}
    order: List[str] = []
    job_width: Dict[str, int] = {}
    mm_jobs: List[MinMaxJob] = []
    ungrouped = 0
    mm_col = 0
    for i, ins in enumerate(instrs):
        if ins.kind == "ReduceSum":
            w = op_width(ins)
            ungrouped += w
            key = ins.attr if ssa else f"{ins.attr}@{i}"
            if key not in members:
                members[key] = []
                order.append(key)
                job_width[key] = w
            members[key].append((i, ins.dest, ins.mask))
        elif ins.kind == "ReduceMinMax":
            w = op_width(ins)
            ungrouped += w
            mm_jobs.append(MinMaxJob(ins.dest, ins.attr, ins.mask, w,
                                     ins.is_max, i, mm_col))
            mm_col += w + 1                   # bits + found flag
    sum_jobs: List[SumJob] = []
    dest_slot: Dict[str, Tuple[int, int]] = {}
    last_use: Dict[str, int] = dict(analysis.last_use)
    col = 0
    for j, key in enumerate(order):
        masks: List[str] = []
        for i, dest, mask in members[key]:
            if mask not in masks:
                masks.append(mask)
            dest_slot[dest] = (j, masks.index(mask))
        exec_at = max(i for i, _, _ in members[key])
        attr = instrs[members[key][0][0]].attr
        job = SumJob(attr, tuple(masks), job_width[key], exec_at, col)
        sum_jobs.append(job)
        col += job.n_cols
        for r in (attr, *masks):             # operands live until the job
            if r in analysis.reg_kind:       # registers only, never the
                last_use[r] = max(last_use.get(r, -1), exec_at)  # sources
    plane_reads = sum(s.width for s in sum_jobs) + sum(m.width
                                                       for m in mm_jobs)
    return ReducePlan(tuple(sum_jobs), tuple(mm_jobs), dest_slot, last_use,
                      col, mm_col, plane_reads, ungrouped)


# --------------------------------------------------------------------------
# Arithmetic planning: carry-save lowering + plane-group batching
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ArithPlan:
    """How the derived-arith instructions lower to carry-save trees.

    ``batches`` are runs of mutually independent derived instructions
    that execute together at the first member's position. Depth counters
    measure serialized plane-op chains (a ripple step is depth 1 per bit;
    a 3:2 compressor level is depth 1 regardless of width). ``steps``
    counts the lowering-internal op kinds for
    ``cost_model.classify_lowering``; they never add Table 4 ISA cycles.
    """
    batches: Tuple[Tuple[int, ...], ...]   # instruction-index runs, len >= 2
    depth_csa: int                         # serialized depth, CSA + batching
    depth_ripple: int                      # same program, ripple lowering
    steps: Tuple[Tuple[str, int], ...]     # internal kind -> count

    @property
    def batched_indices(self) -> FrozenSet[int]:
        return frozenset(i for b in self.batches for i in b)


def _arith_addend_count(ins: isa.PimInstruction,
                        op_width: Callable[[str], int]) -> int:
    """Number of carry-save addends an instruction contributes."""
    if ins.kind == "Multiply":
        w = ins.n_bits
        if ins.imm is not None:
            return sum(1 for b in range(w) if (ins.imm >> b) & 1)
        return min(op_width(ins.attr_b), w)
    return 2                                     # a + b / a + imm / a + ~b


def plan_arith(instrs: Sequence[isa.PimInstruction],
               analysis: ProgramAnalysis,
               widths: Mapping[str, int]) -> ArithPlan:
    """Plan the carry-save lowering of every derived-arith instruction.

    A batch executes at its *first* member's position; a later derived
    instruction may join an open batch when every operand it reads was
    produced before that position (source attributes always qualify).
    Early execution is sound under single-assignment; batching is
    disabled otherwise.
    """
    producer: Dict[str, int] = {}
    ssa = True
    for i, ins in enumerate(instrs):
        if ins.dest in producer:
            ssa = False
        producer[ins.dest] = i

    def op_width(name: str) -> int:
        if analysis.reg_kind.get(name) == "mask":
            return 1
        return analysis.widths.get(name, widths.get(name, 1))

    batches: List[Tuple[int, ...]] = []
    if ssa:
        open_start: Optional[int] = None
        members: List[int] = []
        for i, ins in enumerate(instrs):
            if ins.kind not in _DERIVED_KINDS:
                continue
            joins = open_start is not None and all(
                producer.get(r, -1) < open_start
                for r in instruction_reads(ins))
            if joins:
                members.append(i)
            else:
                if len(members) > 1:
                    batches.append(tuple(members))
                open_start, members = i, [i]
        if len(members) > 1:
            batches.append(tuple(members))

    in_batch = {i for b in batches for i in b}
    depth_csa = 0
    depth_ripple = 0
    csa_compressions = 0
    carry_propagate_bits = 0
    copy_throughs = 0

    def member_stats(ins: isa.PimInstruction) -> Tuple[int, int]:
        """(csa tree levels, addend count) of one instruction."""
        k = _arith_addend_count(ins, op_width)
        return eng.csa_tree_levels(k), k

    for i, ins in enumerate(instrs):
        if ins.kind not in _DERIVED_KINDS:
            continue
        levels, k = member_stats(ins)
        w = ins.n_bits
        depth_ripple += max(0, k - 1) * w
        csa_compressions += max(0, k - 2)
        if k <= 1:
            copy_throughs += 1
        elif i not in in_batch:
            depth_csa += levels + w
            carry_propagate_bits += w
    for b in batches:
        stats = [member_stats(instrs[i]) for i in b]
        live = [(lv, instrs[i].n_bits) for (lv, k), i in zip(stats, b)
                if k > 1]
        if live:
            depth_csa += max(lv for lv, _ in live) + max(w for _, w in live)
            carry_propagate_bits += max(w for _, w in live)
    steps = (("csa_compress", csa_compressions),
             ("carry_propagate", carry_propagate_bits),
             ("copy_through", copy_throughs))
    return ArithPlan(tuple(batches), depth_csa, depth_ripple, steps)


def frees_by_instr(n_instrs: int, last_use: Mapping[str, int],
                   keep: FrozenSet[str]) -> Tuple[Tuple[str, ...], ...]:
    """frees[i] = registers whose (plan-extended) last use is instruction
    ``i`` — dropped right after it executes."""
    frees: List[List[str]] = [[] for _ in range(n_instrs)]
    for r, i in last_use.items():
        if 0 <= i < n_instrs and r not in keep and r != "__valid__":
            frees[i].append(r)
    return tuple(tuple(sorted(f)) for f in frees)


# --------------------------------------------------------------------------
# Cross-query linking: many programs over one relation -> one SSA program
# --------------------------------------------------------------------------
# Operand field names per instruction kind (the register-valued fields a
# linker must rename); every other dataclass field is static and becomes
# part of the value-numbering key unchanged.
_OPERAND_FIELDS: Dict[str, Tuple[str, ...]] = {
    "EqualImm": ("attr",), "NotEqualImm": ("attr",),
    "LessThanImm": ("attr",), "GreaterThanImm": ("attr",),
    "AddImm": ("attr",),
    "Equal": ("attr_a", "attr_b"), "LessThan": ("attr_a", "attr_b"),
    "Add": ("attr_a", "attr_b"), "Subtract": ("attr_a", "attr_b"),
    "Multiply": ("attr_a", "attr_b"),
    "BitwiseAnd": ("src_a", "src_b"), "BitwiseOr": ("src_a", "src_b"),
    "BitwiseNot": ("src",),
    "SetReset": (),
    "ReduceSum": ("attr", "mask"), "ReduceMinMax": ("attr", "mask"),
    "Materialize": ("mask",),            # plus the attrs tuple, special-cased
    "ColumnTransform": ("mask",),
}
# Kinds whose operand order does not change the value: their key sorts the
# operands, so ``And(a, b)`` dedups against ``And(b, a)``. Multiply is not
# here: its value is symmetric but its Table-4 cycle count is not.
_COMMUTATIVE_KINDS = frozenset(
    {"BitwiseAnd", "BitwiseOr", "Equal", "Add"})


def _linked_key(ins: isa.PimInstruction, rename: Mapping[str, str]) -> tuple:
    """Value-numbering key of one instruction under a register renaming:
    (kind, linked operand names, static fields). Two instructions with
    equal keys compute the same value in the linked program."""
    def rn(v: str) -> str:
        return rename.get(v, v)

    kind = ins.kind
    op_fields = _OPERAND_FIELDS[kind]
    ops: tuple = tuple(rn(getattr(ins, f)) for f in op_fields)
    if kind == "Materialize":
        ops = (tuple(rn(a) for a in ins.attrs),) + ops
    elif kind in _COMMUTATIVE_KINDS:
        ops = tuple(sorted(ops))
    skip = set(op_fields) | {"dest", "attrs"}
    static = tuple((f.name, getattr(ins, f.name))
                   for f in dataclasses.fields(ins) if f.name not in skip)
    return (kind, ops, static)


def _relink_instr(ins: isa.PimInstruction, rename: Mapping[str, str],
                  dest: str) -> isa.PimInstruction:
    """Rebuild one instruction with renamed operands and a new dest."""
    def rn(v: str) -> str:
        return rename.get(v, v)

    kw: Dict[str, object] = {f: rn(getattr(ins, f))
                             for f in _OPERAND_FIELDS[ins.kind]}
    if ins.kind == "Materialize":
        kw["attrs"] = tuple(rn(a) for a in ins.attrs)
    return dataclasses.replace(ins, dest=dest, **kw)


@dataclasses.dataclass(frozen=True)
class QuerySlot:
    """Output wiring of one source program inside a linked program:
    ``reg_map`` maps every register the source program defined to the
    linked register that computes the same value; ``mask_outputs`` are the
    source program's requested masks, already translated."""
    reg_map: Mapping[str, str]
    mask_outputs: Tuple[str, ...]

    def reg(self, name: str) -> str:
        return self.reg_map.get(name, name)


@dataclasses.dataclass(frozen=True)
class LinkedProgram:
    """Result of :func:`link_programs`: one SSA program + per-query slots."""
    instrs: Tuple[isa.PimInstruction, ...]
    mask_outputs: Tuple[str, ...]        # union of all slots', deduped
    slots: Tuple[QuerySlot, ...]
    n_instrs_unlinked: int               # sum of member program lengths
    n_deduped: int                       # instructions removed by CSE

    @property
    def cache_key(self) -> str:
        """Short stable digest of the linked instruction stream + outputs:
        equal for equal-meaning batches (canonical compiles, deterministic
        linking), and the reference's digest for the same batch."""
        return hashlib.sha256(
            repr((self.instrs, self.mask_outputs)).encode()).hexdigest()[:16]


def link_programs(programs: Sequence[Tuple[Sequence[isa.PimInstruction],
                                           Sequence[str]]],
                  relation: Optional[eng.PimRelation] = None
                  ) -> LinkedProgram:
    """Merge several compiled instruction streams over ONE relation into a
    single SSA program fit for one launch.

    ``programs`` is a sequence of ``(instrs, mask_outputs)`` pairs, one per
    query, in batch order. Instructions are value-numbered as they are
    appended: one whose (kind, linked operands, static fields) key was
    already emitted is dropped and its dest aliases the existing register.
    Colliding dest names (un-namespaced compilers both emitting ``t0``) are
    uniquified with a ``q<i>.`` prefix; pass ``relation`` so renames also
    avoid its attribute names. The output stays single-assignment, so
    ``plan_reduces`` groups one query's aggregates with another's and
    ``plan_arith`` batches their arithmetic."""
    reserved = {"__valid__"}
    if relation is not None:
        reserved.update(relation.planes)
    value_table: Dict[tuple, str] = {}
    linked: List[isa.PimInstruction] = []
    used: set = set()
    slots: List[QuerySlot] = []
    total = deduped = 0
    for qi, (instrs, mouts) in enumerate(programs):
        rename: Dict[str, str] = {}
        for ins in instrs:
            total += 1
            key = _linked_key(ins, rename)
            hit = value_table.get(key)
            if hit is not None:
                rename[ins.dest] = hit
                deduped += 1
                continue
            dest = ins.dest
            if dest in used or dest in reserved:
                dest = f"q{qi}.{ins.dest}"
                while dest in used or dest in reserved:
                    dest = "_" + dest
            linked.append(_relink_instr(ins, rename, dest))
            used.add(dest)
            rename[ins.dest] = dest
            value_table[key] = dest
        slots.append(QuerySlot(reg_map=dict(rename),
                               mask_outputs=tuple(rename.get(m, m)
                                                  for m in mouts)))
    mask_outputs = tuple(dict.fromkeys(
        m for s in slots for m in s.mask_outputs))
    return LinkedProgram(tuple(linked), mask_outputs, tuple(slots),
                         total, deduped)


# --------------------------------------------------------------------------
# compile_program / run_program
# --------------------------------------------------------------------------
class LruFnCache:
    """Bounded LRU of lowered programs (tapes) keyed by the full static
    program signature, so recompiling the same query against the same
    layout reuses the recorded tape (PimDatabase constructs a fresh
    Compiler per run). Bounded because the key includes the whole
    instruction tuple: a long-lived process answering ad-hoc queries
    would otherwise keep every tape it ever recorded. ``hits``,
    ``misses`` and ``evictions`` count as the reference's cache counts
    them."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self._data: "collections.OrderedDict[tuple, object]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.capacity = capacity
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: tuple):
        with self._lock:
            fn = self._data.get(key)
            if fn is None:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return fn

    def put(self, key: tuple, fn) -> None:
        with self._lock:
            self._data[key] = fn
            self._data.move_to_end(key)
            self._evict()

    def set_capacity(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        with self._lock:
            self.capacity = capacity
            self._evict()

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def _evict(self) -> None:
        """Drop least-recently-used entries down to ``capacity`` (the
        caller holds the lock)."""
        while len(self._data) > self.capacity:
            self._data.popitem(last=False)
            self.evictions += 1


_FN_CACHE = LruFnCache(
    capacity=int(os.environ.get("REPRO_PROGRAM_CACHE_CAPACITY", "128")))


def set_program_cache_capacity(capacity: int) -> None:
    """Resize the tape LRU (evicts the oldest entries now)."""
    _FN_CACHE.set_capacity(capacity)


def program_cache_stats() -> Dict[str, int]:
    """Hit/miss/eviction counters, size and capacity of the tape LRU, under
    the reference's keys."""
    return {"hits": _FN_CACHE.hits, "misses": _FN_CACHE.misses,
            "evictions": _FN_CACHE.evictions, "size": len(_FN_CACHE),
            "capacity": _FN_CACHE.capacity}


def program_signature(instrs: Tuple[isa.PimInstruction, ...],
                      mask_outputs: Tuple[str, ...],
                      widths: Mapping[str, int],
                      mesh: Optional[Mesh] = None,
                      shard_axes: Optional[Tuple[str, ...]] = None) -> tuple:
    """The static signature a tape is cached under: everything that can
    change the recorded tape — instruction stream, requested outputs and
    the source widths that fix the stacked row layout — and the mesh and
    shard axes, as in the reference (a mesh and no mesh are two entries).
    The relation's word count and content do not shape the tape, and a
    linked program's ``query_slots`` are demux metadata, left out so that a
    recurring batch hits the cache on its linked instructions alone."""
    return (instrs, mask_outputs, tuple(sorted(widths.items())), mesh,
            shard_axes)


@dataclasses.dataclass
class CompiledProgram:
    """A relation program lowered to one kernel launch."""
    instrs: Tuple[isa.PimInstruction, ...]
    mask_outputs: Tuple[str, ...]
    scalar_kinds: Dict[str, tuple]         # dest -> ("sum",)|("minmax", max)
    analysis: ProgramAnalysis
    plan: ReducePlan
    arith: ArithPlan
    tape: "kprog.Tape"
    # Source attribute -> its bit-planes (the reference's plane-read count).
    source_plane_counts: Mapping[str, int]
    # Materialize dest -> the attributes it reads back, in order.
    mat_attrs: Mapping[str, Tuple[str, ...]]
    # Masks the program kernel stores: mask_outputs, then every
    # Materialize mask not among them (except the valid plane).
    kernel_masks: Tuple[str, ...]
    # Source attributes the non-Materialize instructions read: the program
    # kernel's input rows, in analysis.source_attrs order.
    kernel_attrs: Tuple[str, ...]
    # Per-query output wiring of a linked multi-query program (empty for a
    # single query's program).
    query_slots: Tuple[QuerySlot, ...] = ()
    # The mesh and shard axes the program runs over (None: one device).
    mesh: Optional[Mesh] = None
    shard_axes: Optional[Tuple[str, ...]] = None

    @property
    def n_dispatches(self) -> int:
        """Logical dispatches per execution — the fusion headline, 1 as
        in the reference; a sharded run makes :attr:`n_shards` launches."""
        return 1

    @property
    def n_shards(self) -> int:
        """Shards the program runs over: program launches per run."""
        if self.mesh is None:
            return 1
        return math.prod(self.mesh.axis_size(a) for a in self.shard_axes)

    @property
    def n_queries(self) -> int:
        return max(1, len(self.query_slots))

    @property
    def agg_plane_reads(self) -> int:
        """Aggregate-plane tile reads per pass under the grouped plan."""
        return self.plan.plane_reads

    @property
    def source_plane_reads(self) -> int:
        """Source bit-planes streamed per launch."""
        return sum(self.source_plane_counts.values())

    @property
    def total_plane_reads(self) -> int:
        return self.source_plane_reads + self.plan.plane_reads

    @property
    def agg_plane_reads_ungrouped(self) -> int:
        """Same count with one read per ReduceSum/MinMax."""
        return self.plan.plane_reads_ungrouped

    @property
    def n_reduce_jobs(self) -> int:
        return len(self.plan.sum_jobs) + len(self.plan.mm_jobs)

    @property
    def arith_depth_csa(self) -> int:
        return self.arith.depth_csa

    @property
    def arith_depth_ripple(self) -> int:
        return self.arith.depth_ripple

    @property
    def peak_live_planes(self) -> int:
        return self.analysis.peak_live_planes

    @property
    def total_reg_planes(self) -> int:
        return self.analysis.total_reg_planes

    def paper_cycles(self) -> int:
        return sum(i.cycles() for i in self.instrs)


def _stitch(parts: List[np.ndarray], axis: int = 0) -> np.ndarray:
    """The shards' host copies in shard order (one shard: no copy)."""
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=axis)


class ProgramResult:
    """Outputs of one fused launch; exact host-side finalisation."""

    def __init__(self, cp: CompiledProgram, raw: Dict[str, dict],
                 n_records: int):
        self._cp = cp
        self._raw = raw
        self._n = n_records

    def mask_packed(self, name: str) -> np.ndarray:
        """The packed mask, each shard's words copied off its device and
        concatenated in shard order."""
        return _stitch([eng.to_words(m) for m in self._raw["masks"][name]])

    def materialized_count(self, name: str) -> int:
        """Selected-record count of one Materialize output (all shards)."""
        return sum(int(c) for c in self._raw["mat_cnt"][name])

    def materialized(self, name: str) -> Dict[str, np.ndarray]:
        """Decoded column values of one Materialize output: ``{attr:
        (count,) int32 array}`` in record order. Each shard's value buffer
        stays on its device; one sync a shard reads its count and only its
        ``count``-column prefix is copied to the host, the prefixes
        concatenated in shard order."""
        with spans.span("db.readback") as sp:
            dense = _stitch([v[:, :int(c)].cpu().numpy()
                             for v, c in zip(self._raw["mat_vals"][name],
                                             self._raw["mat_cnt"][name])],
                            axis=1)
            sp.set(bytes=dense.nbytes)
        attrs = self._cp.mat_attrs[name]
        return {a: dense[i] for i, a in enumerate(attrs)}

    def mask(self, name: str, n_records: Optional[int] = None) -> np.ndarray:
        n = self._n if n_records is None else n_records
        with spans.span("db.readback") as sp:
            words = self.mask_packed(name)
            sp.set(bytes=words.nbytes)
        with spans.span("db.unpack"):
            return bitslice.unpack_mask(words, n)

    def scalar(self, name: str) -> Optional[int]:
        kind = self._cp.scalar_kinds[name][0]
        if kind == "sum":
            j, k = self._cp.plan.dest_slot[name]
            pcs = self._raw["job_pc"][j][k]
            return sum(int(pcs[b]) << b for b in range(pcs.shape[0]))
        if kind == "minmax":
            if not self._raw["mm_found"][name]:
                return None
            bits = self._raw["mm_bits"][name]
            return sum(int(bits[b]) << b for b in range(bits.shape[0]))
        raise KeyError(name)

    def query(self, q: int) -> "QueryView":
        """Demux view for source query ``q`` of a linked program: the same
        accessors, addressed by the query's own register names."""
        return QueryView(self, self._cp.query_slots[q])


class QueryView:
    """Per-query window onto a linked program's :class:`ProgramResult`."""

    def __init__(self, res: ProgramResult, slot: QuerySlot):
        self._res = res
        self._slot = slot

    @property
    def mask_outputs(self) -> Tuple[str, ...]:
        return self._slot.mask_outputs

    def reg(self, name: str) -> str:
        return self._slot.reg(name)

    def mask_packed(self, name: str) -> np.ndarray:
        return self._res.mask_packed(self.reg(name))

    def mask(self, name: str, n_records: Optional[int] = None) -> np.ndarray:
        return self._res.mask(self.reg(name), n_records)

    def scalar(self, name: str) -> Optional[int]:
        return self._res.scalar(self.reg(name))

    def materialized_count(self, name: str) -> int:
        return self._res.materialized_count(self.reg(name))

    def materialized(self, name: str) -> Dict[str, np.ndarray]:
        return self._res.materialized(self.reg(name))


def compile_program(relation: eng.PimRelation,
                    program: Sequence[isa.PimInstruction],
                    mask_outputs: Sequence[str] = (),
                    query_slots: Sequence[QuerySlot] = (),
                    mesh: Optional[Mesh] = None,
                    shard_axes: Optional[Sequence[str]] = None
                    ) -> CompiledProgram:
    """Plan a whole relation program and lower it to one kernel tape.

    ``mask_outputs`` names the mask registers the host will read; every
    reduce destination automatically becomes a scalar output, every
    ``Materialize`` destination a device-resident value output.
    ``query_slots`` (from :func:`link_programs`) is demux metadata for a
    linked multi-query program; it does not shape the tape and is not part
    of the cache signature. With ``mesh`` the program runs on a relation
    sharded over ``shard_axes`` (default: every mesh axis), one launch a
    shard (:func:`run_program`).
    """
    if mesh is not None:
        shard_axes = mesh_shard_axes(mesh, shard_axes)
    instrs = tuple(program)
    mask_outputs = tuple(mask_outputs)
    scalar_kinds: Dict[str, tuple] = {}
    mat_attrs: Dict[str, Tuple[str, ...]] = {}
    mat_masks: List[str] = []
    for ins in instrs:
        if ins.kind == "ReduceSum":
            scalar_kinds[ins.dest] = ("sum",)
        elif ins.kind == "ReduceMinMax":
            scalar_kinds[ins.dest] = ("minmax", ins.is_max)
        elif ins.kind == "Materialize":
            mat_attrs[ins.dest] = tuple(ins.attrs)
            if ins.mask not in mat_masks:
                mat_masks.append(ins.mask)
    # The materialize kernel reads its mask out of the program kernel, so
    # the program kernel stores it and keeps it live to the end.
    extra = tuple(m for m in mat_masks if m not in mask_outputs)
    keep = mask_outputs + extra
    kernel_masks = mask_outputs + tuple(m for m in extra if m != "__valid__")
    analysis = analyze_program(instrs, relation, keep=keep)
    widths = {a: relation.width_of(a) for a in analysis.source_attrs}
    plan = plan_reduces(instrs, analysis, widths)
    arith = plan_arith(instrs, analysis, widths)
    # Only what the filter/aggregate instructions read rides the program
    # kernel; a Materialize-only attribute's one pass is the materialize
    # kernel's.
    kernel_reads = {r for ins in instrs if ins.kind != "Materialize"
                    for r in instruction_reads(ins)}
    kernel_attrs = tuple(a for a in analysis.source_attrs
                         if a in kernel_reads)

    sig = program_signature(instrs, mask_outputs, widths, mesh, shard_axes)
    tape = _FN_CACHE.get(sig)
    if tape is None:
        # Static verification rides the cache miss: every program is
        # checked once, before its tape is recorded, and warm compiles
        # reuse the cached tape with no added work. Raises
        # ProgramVerificationError on any error finding.
        from repro_torch.analysis import passes  # lazy: it imports us
        with spans.span("db.compile.verify", relation=relation.name,
                        n_instrs=len(instrs)):
            passes.verify_compile(instrs, relation, analysis, plan, arith,
                                  frozenset(keep), "fused")
            tape = _build_tape(instrs, kernel_masks, kernel_attrs, widths,
                               plan, arith)
        _FN_CACHE.put(sig, tape)
    return CompiledProgram(instrs, mask_outputs, scalar_kinds, analysis,
                           plan, arith, tape, dict(widths), mat_attrs,
                           kernel_masks, kernel_attrs, tuple(query_slots),
                           mesh, shard_axes)


def stack_sources(cp: CompiledProgram, relation: eng.PimRelation,
                  shard: int = 0) -> torch.Tensor:
    """The program kernel's input over one shard of ``relation`` (the
    whole of an unsharded one), ``(rows, W / n_shards)``: the planes of
    every attribute in ``cp.kernel_attrs`` (the tape's row order), then
    the valid plane."""
    planes, valid = relation.shards()[shard]
    return torch.cat([planes[a] for a in cp.kernel_attrs] + [valid[None]])


def run_program(cp: CompiledProgram, relation: eng.PimRelation
                ) -> ProgramResult:
    """Execute a compiled program: ONE kernel launch for the whole
    relation program (one a shard on a sharded relation), one materialize
    launch per ``Materialize`` (and shard), then exact host-side weighting
    of the popcounts. The shards' popcounts are summed in int64 and their
    MIN/MAX candidates combined on the first shard's device; masks and
    materialized values stay on each shard's device until
    :class:`ProgramResult` reads them."""
    if (relation.mesh, relation.shard_axes) != (cp.mesh, cp.shard_axes):
        raise ValueError(
            f"program compiled for mesh {cp.mesh} over {cp.shard_axes}, "
            f"relation {relation.name!r} on {relation.mesh} over "
            f"{relation.shard_axes}")
    parts = relation.shards()
    outs = [kprog.fused_program(stack_sources(cp, relation, s), cp.tape)
            for s in range(len(parts))]
    mat_vals: Dict[str, List[torch.Tensor]] = {}
    mat_cnt: Dict[str, List[torch.Tensor]] = {}
    for ins in cp.instrs:
        if ins.kind == "Materialize":
            mat_vals[ins.dest], mat_cnt[ins.dest] = [], []
            for (planes, valid), (masks, _, _) in zip(parts, outs):
                mask = (valid if ins.mask == "__valid__"
                        else masks[cp.kernel_masks.index(ins.mask)])
                v, c = kmat.materialize([planes[a] for a in ins.attrs], mask)
                mat_vals[ins.dest].append(v)
                mat_cnt[ins.dest].append(c)
    dev = parts[0][1].device
    pc = sum(o[1].to(dev) for o in outs).cpu().numpy()
    mm = torch.cat([o[2].to(dev) for o in outs]).cpu()
    job_pc = [pc[job.col_start:job.col_start + job.n_cols]
              .reshape(job.width, len(job.masks)).T
              for job in cp.plan.sum_jobs]
    mm_bits: Dict[str, np.ndarray] = {}
    mm_found: Dict[str, bool] = {}
    for mj in cp.plan.mm_jobs:
        bits, found = combine_minmax_candidates(
            mm[:, mj.col_start:mj.col_start + mj.width],
            mm[:, mj.col_start + mj.width] != 0, mj.is_max)
        mm_bits[mj.dest] = bits.numpy()
        mm_found[mj.dest] = bool(found)
    raw = {"masks": {m: [o[0][k] for o in outs]
                     for k, m in enumerate(cp.mask_outputs)},
           "job_pc": job_pc, "mm_bits": mm_bits, "mm_found": mm_found,
           "mat_vals": mat_vals, "mat_cnt": mat_cnt}
    return ProgramResult(cp, raw, relation.n_records)


# --------------------------------------------------------------------------
# Lowering: the Pallas kernel's program, recorded as a plane-op tape
# --------------------------------------------------------------------------
def _build_tape(instrs, kernel_masks: Tuple[str, ...],
                kernel_attrs: Tuple[str, ...], widths: Mapping[str, int],
                plan: ReducePlan, arith: ArithPlan) -> "kprog.Tape":
    """Record the tape of one program, following the reference Pallas
    kernel's schedule: ReduceSum jobs at their ``exec_at``, CSA batches
    at their anchor, MIN/MAX at its own position, and ``frees`` after each
    instruction; ``Materialize`` is the materialize kernel's and records
    nothing. ``TapeRecorder.finish`` then re-orders the recorded DAG for
    few live slots. Rows: ``kernel_attrs`` in order, then the valid
    plane; the STOREs write ``kernel_masks`` in order."""
    frees = frees_by_instr(len(instrs), plan.last_use,
                           frozenset(kernel_masks))
    attr_rows: Dict[str, Tuple[int, int]] = {}
    r0 = 0
    for a in kernel_attrs:
        attr_rows[a] = (r0, r0 + widths[a])
        r0 += widths[a]
    rec = kprog.TapeRecorder()
    ev = BitwiseEvaluator(lambda a: rec.rows(*attr_rows[a]), rec.row(r0))

    jobs_at: Dict[int, List[SumJob]] = {}
    for job in plan.sum_jobs:
        jobs_at.setdefault(job.exec_at, []).append(job)
    mm_at = {mj.exec_at: mj for mj in plan.mm_jobs}
    batch_at = {b[0]: b for b in arith.batches}
    batched = arith.batched_indices

    for i, ins in enumerate(instrs):
        if ins.kind == "ReduceSum":
            pass                       # runs at its grouped job's exec_at
        elif ins.kind == "ReduceMinMax":
            mj = mm_at[i]
            _reduce_minmax_bits(ev.planes(mj.attr)[:mj.width],
                                ev.masks[mj.mask], mj.is_max, rec,
                                mj.col_start)
        elif ins.kind == "Materialize":
            pass                       # the materialize kernel's launch
        elif i in batch_at:
            ev.execute_arith_batch([instrs[j] for j in batch_at[i]])
        elif i in batched:
            pass                       # ran with its batch at batch_at
        else:
            ev.execute(ins)
        for job in jobs_at.get(i, ()):
            # ONE read of each aggregate plane for the whole mask stack.
            p = ev.planes(job.attr)
            g = len(job.masks)
            for b in range(job.width):
                for k, m in enumerate(job.masks):
                    rec.popcount(ev.masks[m], p[b], job.col_start + b * g + k)
        for r in frees[i]:
            ev.free(r)
    for k, name in enumerate(kernel_masks):
        rec.store(ev.masks[name], k)
    return rec.finish(n_rows=r0 + 1, n_masks=len(kernel_masks),
                      n_pc=plan.n_pc_cols, n_mm=plan.n_mm_cols)
