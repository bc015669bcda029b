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

The eager instruction-at-a-time ``Engine`` class and ``PimRelation.shard``
of the reference are not ported yet (ROADMAP A8, A14).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.common import popcount
from . import bitslice


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
def eq_imm_planes(planes, imm: int):
    """planes: (n_bits, W) -> (W,) mask of records == imm.

    Immediate bits steer the op (AND v_b vs AND ~v_b) — Algorithm 1.
    """
    acc = _ones(planes[0])
    for b in range(len(planes)):
        acc = acc & planes[b] if (imm >> b) & 1 else acc & ~planes[b]
    return acc


def cmp_imm_planes(planes, imm: int):
    """Returns (lt, eq) packed masks for records vs an immediate."""
    lt = _zero(planes[0])
    eq = _ones(planes[0])
    for b in range(len(planes) - 1, -1, -1):   # MSB-first
        v = planes[b]
        if (imm >> b) & 1:
            lt = lt | (eq & ~v)
            eq = eq & v
        else:
            eq = eq & ~v
    return lt, eq


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


def sub_planes(pa, pb, out_bits: int):
    """a - b (two's complement), assuming a >= b for unsigned semantics.
    The ``+1`` of the complement rides the adder's carry-in."""
    return add_planes(pa, ~extend_planes(pb, out_bits), out_bits, carry_in=1)


# --------------------------------------------------------------------------
# Aggregation
# --------------------------------------------------------------------------
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

