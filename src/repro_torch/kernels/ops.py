"""Kernel entry points, the counterpart of ``repro.kernels.ops``: each runs
its hand-written CUDA kernel on a CUDA tensor and the kernel's plain
PyTorch version on a CPU tensor. Planes and masks are int32 tensors
carrying the uint32 bit pattern.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import bitpack as _bitpack
from . import bitwise_filter as _filter
from . import filter_aggregate as _fagg


def predicate_eq_imm(planes: torch.Tensor, imm: int) -> torch.Tensor:
    """(n_bits, W) planes -> (W,) packed mask of records == imm."""
    return _filter.eq_imm(planes, imm)


def predicate_cmp_imm(planes: torch.Tensor, imm: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n_bits, W) planes -> ``(lt, eq)`` packed masks against imm."""
    return _filter.cmp_imm(planes, imm)


def predicate_range(planes: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """(n_bits, W) planes -> packed mask of lo <= v < hi (one pass)."""
    return _filter.range_mask(planes, lo, hi)


def fused_filter_sum(filter_planes: torch.Tensor, agg_planes: torch.Tensor,
                     valid: torch.Tensor, lo: int, hi: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """COUNT and per-bit SUM popcounts WHERE lo <= key < hi and valid;
    ``filter_aggregate.weight_popcounts`` gives the exact sum."""
    return _fagg.filter_sum(filter_planes, agg_planes, valid, lo, hi)


def pack_mask(bits: torch.Tensor) -> torch.Tensor:
    """(W, 32) int32 of 0/1 -> (W,) packed int32 words."""
    return _bitpack.bitpack(bits)


def unpack_mask(words: torch.Tensor) -> torch.Tensor:
    """(W,) packed int32 words -> (W, 32) int32 of 0/1."""
    return _bitpack.bitunpack(words)


def masked_sum(planes: torch.Tensor, mask: torch.Tensor) -> int:
    """The eager engine's masked bit-serial SUM: exact, in Python ints."""
    from repro_torch.core import engine as eng
    return eng.reduce_sum(planes, mask)
