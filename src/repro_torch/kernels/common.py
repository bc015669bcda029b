"""Helpers shared by the port's kernels and their plain PyTorch versions."""
from __future__ import annotations

from typing import Tuple

import torch

# Shared memory one block may use on Hopper (232,448 bytes of the SM's
# 256 KB, dynamic shared memory only).
SMEM_BYTES = 232_448
MAX_BLOCK = 1024
MIN_BLOCK = 32


def popcount(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount per 32-bit word of an int32 tensor that carries the
    uint32 bit pattern. int32 ``>>`` is arithmetic, so every right shift
    is masked so that it acts as a logical shift; the first subtraction
    wraps in two's complement exactly as the uint32 form does."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return v & 0x3F


def pick_block(n_slots: int, n_acc: int) -> int:
    """Threads per block for a kernel that keeps ``n_slots`` word slots
    per thread plus ``n_acc`` int32 accumulators in shared memory: the
    largest power of two <= 1024 that fits, so each SM holds as many
    threads as the slot count allows. Raises if even a warp does not fit."""
    t = MAX_BLOCK
    while t >= MIN_BLOCK:
        if (n_slots * t + n_acc) * 4 <= SMEM_BYTES:
            return t
        t //= 2
    raise ValueError(
        f"{n_slots} slots x {MIN_BLOCK} threads + {n_acc} accumulators "
        f"exceed {SMEM_BYTES} bytes of shared memory")


def check_int32(t: torch.Tensor, what: str, shape: Tuple[int, ...],
                device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous int32 tensor of ``shape`` on
    ``device``: what a kernel launcher takes."""
    if t.device != device or t.dtype != torch.int32:
        raise ValueError(f"{what} must be int32 on {device}, got {t.dtype} "
                         f"on {t.device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous of shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")
