"""Kernel entry points, the counterpart of ``repro.kernels.ops``: each runs
its hand-written CUDA kernel on a CUDA tensor and the kernel's plain
PyTorch version on a CPU tensor.

Ported so far: ``pack_mask``/``unpack_mask`` (the column transform). The
reference's other wrappers come with their kernels: ``predicate_eq_imm``,
``predicate_cmp_imm`` and ``predicate_range`` (ROADMAP B3),
``fused_filter_sum`` (B4) and ``masked_sum`` (with the eager engine, A8).
"""
from __future__ import annotations

import torch

from . import bitpack as _bitpack


def pack_mask(bits: torch.Tensor) -> torch.Tensor:
    """(W, 32) int32 of 0/1 -> (W,) packed int32 words."""
    return _bitpack.bitpack(bits)


def unpack_mask(words: torch.Tensor) -> torch.Tensor:
    """(W,) packed int32 words -> (W, 32) int32 of 0/1."""
    return _bitpack.bitunpack(words)
