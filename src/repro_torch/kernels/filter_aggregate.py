"""Fused COUNT and SUM(agg) WHERE lo <= key < hi: the CUDA kernel and its
plain version.

Replaces the Pallas kernel ``repro/kernels/filter_aggregate.py:63``
``filter_sum`` (body ``_fused_kernel``): the range comparator over the
filter planes, ANDed with the valid plane, then the selected records'
count and the per-bit masked popcounts of the aggregate planes — one read
of the planes and no mask in memory. :func:`weight_popcounts` forms the
exact sum on the host.

``filter_sum_torch`` is the plain PyTorch version (the reference's
``kernels/ref.py::filter_agg_popcounts``); ``filter_sum`` launches
``filter_sum_kernel`` of ``csrc/bitwise_filter.cu`` on a CUDA tensor and
runs the plain version on a CPU tensor.

The kernel is bound by bytes, ``(nf + na + 1) * W * 4`` read once, and
is one launch per call: persistent blocks load a thread's filter planes,
valid words and first aggregate planes before folding any, count in
int32 per block, and add the counts into an int64 row on the device; the
block that finishes last writes the ``na + 1`` int64 totals and returns
the row to zeros (the reference sums per-tile int32 partials; the values
are equal). On an H100 80GB HBM3 (700 W) it takes 22.1 us at (12 + 24 +
1, 188,416), against 38.1-39.0 us for the first port's three launches (a
zero fill of per-block partials, the kernel, a torch sum) and a bound of
8.3 us (PERF.md §6).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import build
from .bitwise_filter import MAX_BITS, bind, imm_words, range_mask_torch
from .common import check_int32, popcount

# Kernel launches made by ``filter_sum``.
launches = 0
# A block counts in int32: at most 32 records a word of the W it may
# visit, so W must stay below this many words.
MAX_WORDS = (1 << 31) // 32
# Per device and stream, the kernel's int64 state: a done counter and one
# sum per column (count and MAX_BITS aggregate planes), zeros between
# launches; the kernel returns it to zeros itself, so the launches of a
# stream share it with no host bookkeeping.
_states: Dict[Tuple[torch.device, int], torch.Tensor] = {}


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
def _state(dev: torch.device, stream: int) -> torch.Tensor:
    st = _states.get((dev, stream))
    if st is None:
        st = _states[(dev, stream)] = torch.zeros(
            MAX_BITS + 2, dtype=torch.int64, device=dev)
    return st


def filter_sum_kernel(filter_planes: torch.Tensor, agg_planes: torch.Tensor,
                      valid: torch.Tensor, lo: int, hi: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`filter_sum_torch`'s contract on the current CUDA stream, in
    one launch that writes the ``na + 1`` int64 totals. The results stay
    on the device. No words (``W == 0``) launch nothing, build nothing and
    count nothing."""
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
    if w >= MAX_WORDS:
        raise ValueError(f"filter_sum counts each block's records in int32: "
                         f"{w} words could reach 2**31 in one block (at most "
                         f"{MAX_WORDS - 1} words)")
    check_int32(filter_planes, "filter_planes", (nf, w), dev)
    check_int32(agg_planes, "agg_planes", (na, w), dev)
    check_int32(valid, "valid", (w,), dev)
    if not w:
        return (torch.zeros((), dtype=torch.int64, device=dev),
                torch.zeros(na, dtype=torch.int64, device=dev))
    lib = build.library("bitwise_filter", bind)
    out = torch.empty(na + 1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.filter_sum_launch(
            filter_planes.data_ptr(), nf, agg_planes.data_ptr(), na,
            valid.data_ptr(), w, imm_words(lo, nf), imm_words(hi, nf),
            _state(dev, stream).data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"filter_sum launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out[0], out[1:]


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
