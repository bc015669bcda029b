"""Helpers shared by the port's kernels and their plain PyTorch versions."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# Shared memory on Hopper: one block may use 232,448 bytes (227 KB, dynamic
# shared memory only); an SM holds 233,472 (228 KB) in all and keeps 1 KB
# of it per resident block.
SMEM_BYTES = 232_448
SMEM_SM_BYTES = 233_472
SMEM_RESERVED_BYTES = 1_024
MAX_THREADS = 1024
MAX_THREADS_SM = 2048
MAX_BLOCKS_SM = 32
# fused_program: a tile is at most TILE_WORDS_MAX words, K words per
# thread the first of WORDS_PER_THREAD that fits. Past RESIDENT_WORDS
# words resident per SM a block choice gains nothing but coarser tiles
# (lineitem at SF 1 spreads 1,427 words over each SM).
TILE_WORDS_MAX = 1024
WORDS_PER_THREAD = (2, 1)
RESIDENT_WORDS = 1024


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


@dataclasses.dataclass(frozen=True)
class Launch:
    """How ``fused_program`` runs one tape: ``threads`` per block and ``k``
    words per thread, a tile of ``threads * k`` words."""
    threads: int
    k: int

    @property
    def tile(self) -> int:
        return self.threads * self.k

    def smem_bytes(self, n_planes: int, n_acc: int) -> int:
        """Dynamic shared memory of one block: ``n_planes`` planes (staged
        rows and slots) of ``tile`` words, then ``n_acc`` int32
        accumulators."""
        return (n_planes * self.tile + n_acc) * 4

    def blocks_per_sm(self, n_planes: int, n_acc: int) -> int:
        """Blocks an SM holds by shared memory, threads and block count."""
        smem = self.smem_bytes(n_planes, n_acc)
        if smem > SMEM_BYTES:
            return 0
        return min(MAX_BLOCKS_SM, MAX_THREADS_SM // self.threads,
                   SMEM_SM_BYTES // (smem + SMEM_RESERVED_BYTES))


def plan_launch(n_planes: int, n_acc: int,
                k: Optional[int] = None) -> Launch:
    """The launch of a tape with ``n_planes`` planes (staged rows and
    slots) and ``n_acc`` popcount accumulators: ``k`` words per thread (2,
    or 1 if no block fits, unless given), and the block of at least two
    warps (one if nothing larger fits) that keeps the most words resident
    per SM, counted up to ``RESIDENT_WORDS``, the smaller block on a tie
    (smaller tiles spread further, and one block's barriers stall less of
    the SM). Raises if no block fits."""
    for kk in (k,) if k else WORDS_PER_THREAD:
        for least in (64, 32):
            best = None
            for threads in range(least, min(MAX_THREADS,
                                            TILE_WORDS_MAX // kk) + 1, 32):
                lc = Launch(threads, kk)
                words = min(lc.blocks_per_sm(n_planes, n_acc) * lc.tile,
                            RESIDENT_WORDS)
                if words and (best is None or words > best[0]):
                    best = (words, lc)
            if best:
                return best[1]
    raise ValueError(
        f"{n_planes} planes x 32 words + {n_acc} accumulators exceed "
        f"{SMEM_BYTES} bytes of shared memory")


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
