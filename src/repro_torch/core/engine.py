"""Bulk-bitwise word primitives and the device-resident relation.

The counterpart of ``repro.core.engine`` in PyTorch. A plane stack is an
``(n_bits, W)`` ``torch.int32`` tensor carrying the uint32 bit pattern of
``core.bitslice`` (all-ones words are ``-1``); a single plane or mask is a
``(W,)`` tensor. Every primitive here is bitwise, so int32 and uint32
agree bit for bit; the only shift-dependent code is the SWAR popcount in
``kernels.common``, which masks each right shift.

The primitives touch their operands only through ``& | ^ ~``, indexing,
``len``/``shape[0]`` and ``torch.stack``/``torch.cat``/``torch.zeros_like``/
``torch.full_like``. The tape recorder of ``kernels.program`` runs these
same functions over symbolic plane handles that implement exactly that
surface (``__torch_function__``), so the CUDA kernel's instruction tape
and the plain PyTorch path come from one lowering.

:class:`Engine` is the reference's eager instruction-at-a-time engine,
the bit-level oracle of ``Engine.EAGER``: its immediate predicates go
through ``kernels.ops`` (the CUDA kernels on a CUDA relation), the rest
runs as torch ops, as the reference runs it in jnp. It also executes the
DML writes (``PlaneWrite``, ``ValidClear``) of ``dml``: a masked merge of
host-built row masks, as torch ops on the relation's device (the
reference computes it in jnp outside any kernel), through the
process-wide write-fault hook of ``faults`` when one is installed. Not
ported yet: ``PimRelation.shard`` (ROADMAP A14).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops
# The bit-serial comparators against an immediate (Algorithm 1), kept
# under their engine names for ``core.program``'s evaluator: the plain
# versions of the eq_imm/cmp_imm kernels.
from repro_torch.kernels.bitwise_filter import (  # noqa: F401
    cmp_imm_torch as cmp_imm_planes, eq_imm_torch as eq_imm_planes)
from repro_torch.kernels.common import popcount
from . import bitslice, isa


# --------------------------------------------------------------------------
# Constant planes
# --------------------------------------------------------------------------
def _zero(plane):
    return torch.zeros_like(plane)


def _ones(plane):
    return torch.full_like(plane, -1)


# --------------------------------------------------------------------------
# Bit-serial comparators over planes (MSB-first; one word = 32 records)
# --------------------------------------------------------------------------
def cmp_planes(pa, pb):
    """(lt, eq) masks for attribute-vs-attribute comparison (a ? b)."""
    n = max(len(pa), len(pb))
    zero = _zero(pa[0])
    lt = zero
    eq = _ones(pa[0])
    for b in range(n - 1, -1, -1):
        a = pa[b] if b < len(pa) else zero
        c = pb[b] if b < len(pb) else zero
        lt = lt | (eq & ~a & c)
        eq = eq & ~(a ^ c)
    return lt, eq


# --------------------------------------------------------------------------
# Bit-serial arithmetic
# --------------------------------------------------------------------------
def add_planes(pa, pb, out_bits: int, carry_in: int = 0):
    """Ripple-carry bit-serial addition over planes -> (out_bits, W).

    ``carry_in`` seeds the carry chain (0 or 1): two's-complement subtract
    folds its ``+1`` here instead of paying a second ripple pass.
    """
    zero = _zero(pa[0])
    carry = _ones(pa[0]) if carry_in else zero
    outs = []
    for b in range(out_bits):
        a = pa[b] if b < len(pa) else zero
        c = pb[b] if b < len(pb) else zero
        outs.append(a ^ c ^ carry)
        carry = (a & c) | (carry & (a ^ c))
    return torch.stack(outs)


def add_imm_planes(pa, imm: int, out_bits: int):
    """Immediate-specialised adder (carry chain simplifies per imm bit)."""
    zero = _zero(pa[0])
    carry = zero
    outs = []
    for b in range(out_bits):
        a = pa[b] if b < len(pa) else zero
        if (imm >> b) & 1:
            outs.append(~(a ^ carry))
            carry = a | carry
        else:
            outs.append(a ^ carry)
            carry = a & carry
    return torch.stack(outs)


def extend_planes(p, out_bits: int):
    """Zero-extend (or truncate) a plane stack to exactly ``out_bits``."""
    n = len(p)
    if n == out_bits:
        return p
    if n > out_bits:
        return p[:out_bits]
    return torch.stack(list(p) + [_zero(p[0])] * (out_bits - n))


def shift_planes(pa, b: int, out_bits: int):
    """(pa << b) truncated to ``out_bits`` planes (a multiply partial
    product before gating)."""
    return torch.stack([_zero(pa[0])] * min(b, out_bits)
                       + list(pa[:max(0, out_bits - b)]))


def imm_planes(imm: int, n_bits: int, like):
    """An immediate as a constant plane stack (all-ones / all-zeros per
    bit), planes shaped like the plane ``like``. Only used inside batched
    CSA reductions; the tape recorder folds the constants away, so the
    immediate never occupies a slot."""
    return torch.stack([_ones(like) if (imm >> b) & 1 else _zero(like)
                        for b in range(n_bits)])


def mul_partial_products(pa, pb, imm: Optional[int], out_bits: int) -> List:
    """The shift-add partial products of a multiply, ungated-by-accumulate:
    immediate multiplies contribute one shifted copy of ``pa`` per set imm
    bit; attribute multiplies gate ``pa << b`` with plane ``pb[b]``."""
    pps: List = []
    if imm is not None:
        b = 0
        while (imm >> b) and b < out_bits:
            if (imm >> b) & 1:
                pps.append(shift_planes(pa, b, out_bits))
            b += 1
    else:
        for b in range(min(len(pb), out_bits)):
            pps.append(shift_planes(pa, b, out_bits) & pb[b][None])
    return pps


# --------------------------------------------------------------------------
# Carry-save (3:2 compressor) arithmetic — Wallace-style reduction
# --------------------------------------------------------------------------
def csa_compress3(a, b, c):
    """One 3:2 compressor level over equal-shape plane stacks.

    Returns ``(sum, carry)`` with the carry stack already shifted up one
    bit plane (the top carry drops: arithmetic is mod 2^n).
    """
    s = a ^ b ^ c
    maj = (a & b) | (c & (a ^ b))
    return s, torch.cat([torch.zeros_like(maj[:1]), maj[:-1]])


def csa_tree_levels(k: int) -> int:
    """3:2 compressor levels needed to reduce ``k`` addends to 2 (mirrors
    ``csa_reduce``'s loop exactly; change the two together)."""
    levels = 0
    while k > 2:
        k = 2 * (k // 3) + k % 3
        levels += 1
    return levels


def csa_reduce(terms: Sequence, out_bits: int):
    """Reduce any number of addend plane stacks to a (sum, carry) pair via
    a log-depth 3:2 compressor tree; the caller finishes with ONE
    carry-propagate pass."""
    work = [extend_planes(t, out_bits) for t in terms]
    if not work:
        raise ValueError("csa_reduce needs at least one term")
    while len(work) > 2:
        nxt: List = []
        tail = len(work) % 3
        for i in range(0, len(work) - tail, 3):
            nxt.extend(csa_compress3(work[i], work[i + 1], work[i + 2]))
        nxt.extend(work[len(work) - tail:])
        work = nxt
    if len(work) == 1:
        work.append(torch.zeros_like(work[0]))
    return work[0], work[1]


def add_planes_csa(terms: Sequence, out_bits: int, carry_in: int = 0):
    """Sum any number of plane stacks: CSA tree + one final ripple pass."""
    if not terms:
        raise ValueError("add_planes_csa needs at least one term")
    if len(terms) == 1 and not carry_in:
        return extend_planes(terms[0], out_bits)
    s, c = csa_reduce(terms, out_bits)
    return add_planes(s, c, out_bits, carry_in=carry_in)


def mul_imm_planes_csa(pa, imm: int, out_bits: int):
    """Immediate multiply, carry-save: ALL partial products reduced in a
    log-depth 3:2 tree, then one carry-propagate pass."""
    pps = mul_partial_products(pa, None, imm, out_bits)
    if not pps:
        return torch.stack([_zero(pa[0])] * out_bits)
    return add_planes_csa(pps, out_bits)


def mul_planes_csa(pa, pb, out_bits: int):
    """Attribute multiply, carry-save (see ``mul_imm_planes_csa``)."""
    pps = mul_partial_products(pa, pb, None, out_bits)
    if not pps:
        return torch.stack([_zero(pa[0])] * out_bits)
    return add_planes_csa(pps, out_bits)


def _ripple_accumulate(pps: Sequence, out_bits: int, like) -> torch.Tensor:
    """Shift-add accumulation: one full ripple pass per extra partial
    product; the first seeds the accumulator directly (copy-through)."""
    acc = None
    for pp in pps:
        acc = (extend_planes(pp, out_bits) if acc is None
               else add_planes(acc, pp, out_bits))
    if acc is None:
        return torch.stack([_zero(like)] * out_bits)
    return acc


def mul_imm_planes(pa, imm: int, out_bits: int) -> torch.Tensor:
    """Shift-add multiply by an immediate, ripple-carry (the eager oracle
    over the same partial products the carry-save path reduces)."""
    return _ripple_accumulate(mul_partial_products(pa, None, imm, out_bits),
                              out_bits, pa[0])


def mul_planes(pa, pb, out_bits: int) -> torch.Tensor:
    """Bit-serial shift-add multiply, ripple-carry: partial product b is
    ``(pa << b) & pb[b]``."""
    return _ripple_accumulate(mul_partial_products(pa, pb, None, out_bits),
                              out_bits, pa[0])


def sub_planes(pa, pb, out_bits: int):
    """a - b (two's complement), assuming a >= b for unsigned semantics.
    The ``+1`` of the complement rides the adder's carry-in."""
    return add_planes(pa, ~extend_planes(pb, out_bits), out_bits, carry_in=1)


# --------------------------------------------------------------------------
# Aggregation (paper Fig. 7 reduce; masked per §4.2)
# --------------------------------------------------------------------------
def popcount_total(v: torch.Tensor) -> torch.Tensor:
    """Total set bits of the words ``v`` as a 0-d int64 tensor."""
    return popcount(v).sum(dtype=torch.int64)


def reduce_count(mask: torch.Tensor) -> torch.Tensor:
    return popcount_total(mask)


def reduce_sum_bits(planes: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-bit masked popcounts ``pc[b] = popcount(plane_b & mask)``,
    ``(n_bits,)`` int64; the 2^b weighting stays with the caller."""
    return popcount(planes & mask).sum(dim=-1, dtype=torch.int64)


def reduce_sum(planes: torch.Tensor, mask: torch.Tensor) -> int:
    """SUM = sum over b of 2^b * popcount(plane_b & mask), weighted in
    Python ints (exact at any width: the host combine of Fig. 7)."""
    pcs = reduce_sum_bits(planes, mask).tolist()
    return sum(int(pc) << b for b, pc in enumerate(pcs))


def _narrow(planes: torch.Tensor, mask: torch.Tensor, is_max: bool
            ) -> Tuple[int, bool]:
    """MSB-first candidate narrowing; one host sync per bit. Over an
    empty mask MIN gives all ones and MAX zero, with ``found`` False."""
    cand = mask
    value = 0
    for b in range(len(planes) - 1, -1, -1):
        t = cand & (planes[b] if is_max else ~planes[b])
        if bool((t != 0).any()):
            cand = t
            value |= int(is_max) << b
        else:
            cand = cand & (~planes[b] if is_max else planes[b])
            value |= int(not is_max) << b
    return value, bool((mask != 0).any())


def reduce_min(planes: torch.Tensor, mask: torch.Tensor) -> Tuple[int, bool]:
    """MIN over the masked records: ``(value, found)``."""
    return _narrow(planes, mask, is_max=False)


def reduce_max(planes: torch.Tensor, mask: torch.Tensor) -> Tuple[int, bool]:
    """MAX over the masked records: ``(value, found)``."""
    return _narrow(planes, mask, is_max=True)


def reduce_sum_bits_grouped(planes: torch.Tensor,
                            masks: torch.Tensor) -> torch.Tensor:
    """Per-(group, bit) masked popcounts for a stack of group masks:
    out[g, b] = popcount(plane_b & mask_g), one read of each aggregate
    plane for every group.

    planes: (n_bits, W); masks: (n_groups, W) -> (n_groups, n_bits) int64
    (exact; the 2^b weighting stays with the caller in Python ints).
    """
    return popcount(masks[:, None, :] & planes[None, :, :]).sum(
        dim=-1, dtype=torch.int64)


# --------------------------------------------------------------------------
# DML write primitives (``dml``): row-targeted plane programming.
# The controller receives (rows, values) in the PIM request (Algorithm 1
# style — values steer the write phases, they are never staged as a
# bit-plane) and programs the listed crossbar rows. Here that becomes a
# word-level masked merge: host-built touch/value bitvectors (numpy
# uint32, as the reference builds them), uploaded as int32 words to the
# relation's device, one bulk ``(plane & ~touch) | vals`` per plane stack.
# --------------------------------------------------------------------------
#: Bytes the write primitives have moved from the host to a device (the
#: touch and value words of every PlaneWrite/ValidClear executed there).
upload_bytes = 0


def write_touch_mask(rows: np.ndarray, n_words: int) -> np.ndarray:
    """(W,) uint32 bitvector with the listed record slots set."""
    rows = np.asarray(rows, np.int64)
    touch = np.zeros(n_words, np.uint32)
    if rows.size == 0:
        return touch
    word = rows // bitslice.WORD_BITS
    shift = (rows % bitslice.WORD_BITS).astype(np.uint32)
    np.bitwise_or.at(touch, word, np.uint32(1) << shift)
    return touch


def plane_write_masks(rows, values, n_bits: int,
                      n_words: int) -> Tuple[np.ndarray, np.ndarray]:
    """(touch (W,), vals (n_bits, W)) uint32 masks of one PlaneWrite.

    Rows must be distinct within one instruction (the DML layer dedupes
    keeping the last write); repeated rows would OR their value bits.
    """
    rows = np.asarray(rows, np.int64)
    touch = write_touch_mask(rows, n_words)
    vals = np.zeros((n_bits, n_words), np.uint32)
    if rows.size == 0:
        return touch, vals
    v = np.asarray(values, np.uint64)
    word = rows // bitslice.WORD_BITS
    shift = (rows % bitslice.WORD_BITS).astype(np.uint32)
    for b in range(n_bits):
        bits = ((v >> np.uint64(b)) & np.uint64(1)).astype(np.uint32)
        np.bitwise_or.at(vals[b], word, bits << shift)
    return touch, vals


def _upload(words: np.ndarray, device) -> torch.Tensor:
    """Host uint32 words onto ``device`` as int32, counted in
    ``upload_bytes`` when ``device`` is not the host."""
    global upload_bytes
    t = to_planes(words, device)
    if t.device.type != "cpu":
        upload_bytes += words.nbytes
    return t


def apply_plane_write(planes: torch.Tensor, touch: np.ndarray,
                      vals: np.ndarray) -> torch.Tensor:
    """Masked merge of new row values into an (n_bits, W) plane stack, on
    the stack's device."""
    t = _upload(touch, planes.device)
    return (planes & ~t[None, :]) | _upload(vals, planes.device)


# Device-fault injection hook (``repro_torch.faults``): when installed,
# every DATA plane write is routed through it — dead rows drop their
# touch/value bits from the host masks before they go up (the write never
# programs the row, modeling endurance-exhausted cells), and stuck-at
# cells force their value back after the merge, on the planes' device.
# The valid plane is exempt by model choice: it is the one plane the
# controller can always program (an SLC-style healthier region), so
# quarantining a faulty row via ValidClear always succeeds.
_WRITE_FAULT_HOOK = None


def install_write_fault_hook(hook):
    """Install (or, with ``None``, remove) the process-wide write-fault
    hook.  Returns the previously installed hook so callers can restore
    it; the hook must provide ``filter_plane_write(rel, attr, touch,
    vals) -> (touch, vals)`` on the numpy masks and ``force_stuck(rel,
    attr, planes) -> planes`` on the merged tensor."""
    global _WRITE_FAULT_HOOK
    prev = _WRITE_FAULT_HOOK
    _WRITE_FAULT_HOOK = hook
    return prev


# --------------------------------------------------------------------------
# Relation store
# --------------------------------------------------------------------------
def to_planes(a: np.ndarray, device) -> torch.Tensor:
    """numpy uint32 words -> int32 tensor with the same bit pattern."""
    return torch.tensor(np.ascontiguousarray(a, dtype=np.uint32)
                        .view(np.int32), device=device)


def to_words(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> numpy uint32 words with the same bit pattern."""
    return t.detach().cpu().numpy().view(np.uint32)


@dataclasses.dataclass
class PimRelation:
    """A relation resident on the device as bit-planes (paper §4.1)."""
    name: str
    layout: bitslice.RelationLayout
    planes: Dict[str, torch.Tensor]      # attr -> (n_bits, W) int32
    valid: torch.Tensor                  # (W,) int32 valid-record mask
    n_records: int
    # Monotonic content version: any mutation of the resident copy must
    # publish a relation with a higher version.
    version: int = 0

    @classmethod
    def from_columns(cls, name: str, columns: Mapping[str, np.ndarray],
                     encodings: Mapping[str, str] | None = None,
                     widths: Mapping[str, int] | None = None,
                     device="cuda") -> "PimRelation":
        layout = bitslice.build_layout(columns, encodings, widths)
        W = layout.n_words
        planes = {a: to_planes(bitslice.pack_bits(
                      np.asarray(col), layout.attributes[a].n_bits, W), device)
                  for a, col in columns.items()}
        valid = to_planes(bitslice.pack_mask(
            np.ones(layout.n_records, bool), W), device)
        return cls(name, layout, planes, valid, layout.n_records)

    def width_of(self, attr: str) -> int:
        return self.layout.attributes[attr].n_bits

    def bytes_resident(self) -> int:
        """Device-resident bytes: every attribute plane plus the valid
        plane over the full ``layout.n_words`` capacity."""
        return self.layout.row_bits * self.layout.n_words * 4

    def bytes_reserved(self) -> int:
        """The share of ``bytes_resident`` past the last occupied word."""
        used = -(-self.layout.n_records // bitslice.WORD_BITS)
        return self.layout.row_bits * max(0, self.layout.n_words - used) * 4

    def bumped(self) -> "PimRelation":
        """A copy with the content version advanced."""
        return dataclasses.replace(self, version=self.version + 1)


def relation_from_numpy(name: str, layout: bitslice.RelationLayout,
                        planes: Mapping[str, np.ndarray], valid: np.ndarray,
                        n_records: int, device="cuda") -> PimRelation:
    """Carry already-packed planes (numpy uint32 words, e.g. another
    implementation's ``PimRelation`` planes) onto the device unchanged,
    so two implementations can be fed identical bits."""
    return PimRelation(name, layout,
                       {a: to_planes(p, device) for a, p in planes.items()},
                       to_planes(valid, device), n_records)


class Engine:
    """Executes PIM instruction sequences on a :class:`PimRelation`, one
    instruction at a time (the reference's eager engine).

    Masks and derived attributes live in a register file (dicts), as the
    paper's computation area holds intermediates inside each crossbar;
    every executed instruction is appended to ``trace`` for the cost
    model. The relation's device decides where the immediate predicates
    run: ``kernels.ops`` launches the CUDA kernels on a CUDA relation and
    their plain versions on a CPU one.
    """

    def __init__(self, relation: PimRelation):
        self.rel = relation
        self.masks: Dict[str, torch.Tensor] = {"__valid__": relation.valid}
        self.derived: Dict[str, object] = {}  # planes, or a reduce's int
        self.found: Dict[str, bool] = {}      # ReduceMinMax non-empty flags
        self.materialized: Dict[str, Dict[str, np.ndarray]] = {}
        self.trace: List[isa.PimInstruction] = []

    # -- operand helpers ---------------------------------------------------
    def _planes(self, attr: str) -> torch.Tensor:
        if attr in self.derived:
            return self.derived[attr]
        if attr in self.masks:          # a mask viewed as a 1-bit attribute
            return self.masks[attr][None, :]
        return self.rel.planes[attr]

    def mask(self, name: str) -> torch.Tensor:
        return self.masks[name]

    # -- execution ---------------------------------------------------------
    def execute(self, instr: isa.PimInstruction) -> None:
        self.trace.append(instr)
        kind = instr.kind
        if kind in ("EqualImm", "NotEqualImm", "LessThanImm",
                    "GreaterThanImm"):
            self.masks[instr.dest] = self._imm_predicate(instr)
        elif kind == "Equal":
            _, eq = cmp_planes(self._planes(instr.attr_a),
                               self._planes(instr.attr_b))
            self.masks[instr.dest] = eq
        elif kind == "LessThan":
            lt, eq = cmp_planes(self._planes(instr.attr_a),
                                self._planes(instr.attr_b))
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
                # Attribute NOT: zero-extend to n_bits, invert every plane
                # (the first step of imm - attr via two's complement).
                self.derived[instr.dest] = ~extend_planes(
                    self._planes(instr.src), instr.n_bits)
        elif kind == "SetReset":
            self.masks[instr.dest] = torch.full(
                (self.rel.layout.n_words,), -1 if instr.value else 0,
                dtype=torch.int32, device=self.rel.valid.device)
        elif kind == "AddImm":
            self.derived[instr.dest] = add_imm_planes(
                self._planes(instr.attr), instr.imm, instr.n_bits)
        elif kind == "Add":
            self.derived[instr.dest] = add_planes(
                self._planes(instr.attr_a), self._planes(instr.attr_b),
                instr.n_bits)
        elif kind == "Subtract":
            self.derived[instr.dest] = sub_planes(
                self._planes(instr.attr_a), self._planes(instr.attr_b),
                instr.n_bits)
        elif kind == "Multiply":
            pa = self._planes(instr.attr_a)
            self.derived[instr.dest] = (
                mul_imm_planes(pa, instr.imm, instr.n_bits)
                if instr.imm is not None
                else mul_planes(pa, self._planes(instr.attr_b),
                                instr.n_bits))
        elif kind == "ReduceSum":
            self.derived[instr.dest] = kops.masked_sum(
                self._planes(instr.attr), self.masks[instr.mask])
        elif kind == "ReduceMinMax":
            fn = reduce_max if instr.is_max else reduce_min
            v, found = fn(self._planes(instr.attr), self.masks[instr.mask])
            self.derived[instr.dest] = v
            self.found[instr.dest] = found
        elif kind == "Materialize":
            # The host unpack and gather of the reference's eager engine,
            # values int64 in record order.
            n = self.rel.n_records
            sel = bitslice.unpack_mask(to_words(self.masks[instr.mask]), n)
            self.materialized[instr.dest] = {
                a: bitslice.unpack_bits(to_words(self._planes(a)), n)[sel]
                .astype(np.int64)
                for a in instr.attrs}
        elif kind == "ColumnTransform":
            # The packed mask already is the row-wise readout; kept in the
            # trace so the cost model charges the paper's 2050 cycles.
            self.masks[instr.dest] = self.masks[instr.mask]
        elif kind == "PlaneWrite":
            W = self.rel.layout.n_words
            if instr.dest == "__valid__":
                touch, vals = plane_write_masks(instr.rows, instr.values,
                                                1, W)
                valid = apply_plane_write(self.rel.valid[None], touch,
                                          vals)[0]
                self.rel = dataclasses.replace(self.rel, valid=valid)
                self.masks["__valid__"] = valid
            else:
                p = self.rel.planes[instr.dest]
                touch, vals = plane_write_masks(instr.rows, instr.values,
                                                p.shape[0], W)
                hook = _WRITE_FAULT_HOOK
                if hook is not None:
                    touch, vals = hook.filter_plane_write(
                        self.rel.name, instr.dest, touch, vals)
                planes = dict(self.rel.planes)
                planes[instr.dest] = apply_plane_write(p, touch, vals)
                if hook is not None:
                    planes[instr.dest] = hook.force_stuck(
                        self.rel.name, instr.dest, planes[instr.dest])
                self.rel = dataclasses.replace(self.rel, planes=planes)
        elif kind == "ValidClear":
            touch = write_touch_mask(np.asarray(instr.rows),
                                     self.rel.layout.n_words)
            valid = self.rel.valid & ~_upload(touch, self.rel.valid.device)
            self.rel = dataclasses.replace(self.rel, valid=valid)
            self.masks["__valid__"] = valid
        else:
            raise ValueError(f"unknown instruction {kind}")

    def _imm_predicate(self, instr: isa.PimInstruction) -> torch.Tensor:
        """The mask of one immediate comparison. An immediate the operand's
        width cannot represent short-circuits (equal never, less always);
        any other goes through the ``eq_imm``/``cmp_imm`` entry points."""
        p = self._planes(instr.attr)
        kind = instr.kind
        if instr.imm >= 1 << p.shape[0]:
            all_ones = kind in ("NotEqualImm", "LessThanImm")
            return torch.full_like(p[0], -1 if all_ones else 0)
        if kind == "EqualImm":
            return kops.predicate_eq_imm(p, instr.imm)
        if kind == "NotEqualImm":
            return ~kops.predicate_eq_imm(p, instr.imm)
        lt, eq = kops.predicate_cmp_imm(p, instr.imm)
        if kind == "LessThanImm":
            return (lt | eq) if instr.or_equal else lt
        return ~lt if instr.or_equal else ~(lt | eq)

    def run(self, program: Sequence[isa.PimInstruction]) -> None:
        for ins in program:
            self.execute(ins)

    # -- readout (the "host reads" the paper charges) -----------------------
    def read_mask(self, name: str) -> np.ndarray:
        return bitslice.unpack_mask(to_words(self.masks[name]),
                                    self.rel.n_records)

    def read_scalar(self, name: str) -> np.ndarray:
        v = self.derived[name]
        return to_words(v) if isinstance(v, torch.Tensor) else np.asarray(v)

    def read_reduce(self, name: str) -> Optional[int]:
        """A reduce's result as a Python int; ``None`` for MIN/MAX over an
        empty selection."""
        if not self.found.get(name, True):
            return None
        return int(self.derived[name])

    def read_materialized(self, name: str) -> Dict[str, np.ndarray]:
        """``{attr: (count,) int64}`` in record order, of one executed
        ``Materialize``."""
        return self.materialized[name]

    def count(self, mask: str) -> int:
        return int(reduce_count(self.masks[mask] & self.rel.valid))
