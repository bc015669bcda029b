"""Fused COUNT and SUM(agg) WHERE lo <= key < hi: the CUDA kernel and its
plain version.

Replaces the Pallas kernel ``repro/kernels/filter_aggregate.py::
filter_sum`` (body ``_fused_kernel``): the range comparator over the
filter planes, ANDed with the valid plane, then the selected records'
count and the per-bit masked popcounts of the aggregate planes — one read
of the planes and no mask in memory. :func:`weight_popcounts` forms the
exact sum on the host.

``filter_sum_torch`` is the plain PyTorch version (the reference's
``kernels/ref.py::filter_agg_popcounts``); ``filter_sum`` launches
``filter_sum_kernel`` of ``csrc/bitwise_filter.cu`` (it shares the range
comparator of ``range_mask``) on a CUDA tensor and runs the plain version
on a CPU tensor. The kernel writes int32 partials per block, which are
summed in int64 (the reference sums its per-tile partials in int32; the
values are equal).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build
from .bitwise_filter import (MAX_BITS, THREADS, bind, imm_words,
                             range_mask_torch)
from .common import check_int32, popcount

# Kernel launches made by ``filter_sum``.
launches = 0


def filter_sum_torch(filter_planes: torch.Tensor, agg_planes: torch.Tensor,
                     valid: torch.Tensor, lo: int, hi: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``filter_planes`` (nf, W), ``agg_planes`` (na, W), ``valid`` (W,)
    int32 words. Returns ``(count, bit_popcounts)``: a 0-d and an ``(na,)``
    int64 tensor, ``bit_popcounts[b] = popcount(mask & agg plane b)`` over
    ``mask = (lo <= key < hi) & valid``."""
    mask = range_mask_torch(filter_planes, lo, hi) & valid
    return (popcount(mask).sum(dtype=torch.int64),
            popcount(agg_planes & mask).sum(dim=1, dtype=torch.int64))


def weight_popcounts(count, bit_popcounts) -> Tuple[int, int]:
    """Exact host-side weighting in Python ints: ``(count, sum over b of
    bit_popcounts[b] << b)``."""
    pcs = [int(x) for x in bit_popcounts]
    return int(count), sum(pc << b for b, pc in enumerate(pcs))


# --------------------------------------------------------------------------
# The CUDA kernel
# --------------------------------------------------------------------------
def filter_sum_kernel(filter_planes: torch.Tensor, agg_planes: torch.Tensor,
                      valid: torch.Tensor, lo: int, hi: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`filter_sum_torch`'s contract on the current CUDA stream: one
    launch writes ``(ceil(W / THREADS), na + 1)`` int32 partials, summed
    here in int64. The results stay on the device. No words (``W == 0``)
    launch nothing, build nothing and count nothing."""
    dev = valid.device
    if dev.type != "cuda" or valid.dim() != 1 or filter_planes.dim() != 2 \
            or agg_planes.dim() != 2:
        raise ValueError("filter_sum takes 2-D CUDA plane stacks and a 1-D "
                         "valid plane")
    nf, w = filter_planes.shape
    na = agg_planes.shape[0]
    if not 1 <= nf <= MAX_BITS or na > MAX_BITS:
        raise ValueError(f"filter_sum takes 1 to {MAX_BITS} filter and at "
                         f"most {MAX_BITS} aggregate planes, got {nf}, {na}")
    check_int32(filter_planes, "filter_planes", (nf, w), dev)
    check_int32(agg_planes, "agg_planes", (na, w), dev)
    check_int32(valid, "valid", (w,), dev)
    if not w:
        return (torch.zeros((), dtype=torch.int64, device=dev),
                torch.zeros(na, dtype=torch.int64, device=dev))
    lib = build.library("bitwise_filter", bind)
    n_rows = -(-w // THREADS)
    parts = torch.zeros((n_rows, na + 1), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.filter_sum_launch(
            filter_planes.data_ptr(), nf, agg_planes.data_ptr(), na,
            valid.data_ptr(), w, imm_words(lo, nf), imm_words(hi, nf),
            parts.data_ptr(), n_rows,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"filter_sum launch failed: CUDA error {err}")
    global launches
    launches += 1
    totals = parts.sum(dim=0, dtype=torch.int64)
    return totals[0], totals[1:]


def filter_sum(filter_planes: torch.Tensor, agg_planes: torch.Tensor,
               valid: torch.Tensor, lo: int, hi: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused COUNT and per-bit SUM popcounts WHERE lo <= key < hi and
    valid; combine with :func:`weight_popcounts` for the exact sum. A CPU
    tensor runs :func:`filter_sum_torch`; a CUDA tensor launches the kernel
    on the current stream, or raises."""
    fn = filter_sum_torch if valid.device.type == "cpu" \
        else filter_sum_kernel
    return fn(filter_planes, agg_planes, valid, lo, hi)
