"""Mask-selected bit-plane materialization: the CUDA kernel and its plain
version.

Replaces the Pallas kernel ``repro/kernels/materialize.py::
materialize_pallas`` (body ``_materialize_kernel``): given the bit planes
of one or more attributes and a packed selection mask (a PIM filter
program's output, valid plane included), produce the selected records'
int32 values, compacted to the front in record order, and their count.
The host then copies only the ``count``-column prefix — the readout the
paper's selection saves.

``materialize_torch`` is the plain PyTorch version (the reference's jnp
lowering ``materialize_planes``); ``materialize`` launches
``csrc/materialize.cu`` on a CUDA tensor and runs the plain version on a
CPU tensor. Only ``values[..., :count]`` is defined: the kernel leaves
the tail as it found it (as the Pallas path leaves garbage there), the
plain version leaves zeros.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from . import build
from .common import check_int32

WORD_BITS = 32

# Calls of ``materialize`` that launched the kernel (one per call on a
# CUDA tensor, whatever the layout and the number of attributes).
launches = 0


# --------------------------------------------------------------------------
# Plain PyTorch version
# --------------------------------------------------------------------------
def unpack_word_bits(words: torch.Tensor) -> torch.Tensor:
    """(n_words,) int32 -> (n_words*32,) int32 of 0/1 record bits; record
    ``r`` is word ``r // 32`` bit ``r % 32``. The ``& 1`` makes the
    arithmetic shift of int32 act as a logical one."""
    lanes = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    return ((words[:, None] >> lanes) & 1).reshape(-1)


def decode_plane_values(planes: torch.Tensor) -> torch.Tensor:
    """(n_bits, n_words) int32 planes -> (n_words*32,) int32 values. Bit 31
    lands in the sign, as the reference's ``int32 << 31``; planes past the
    32nd add nothing (XLA's shift by >= 32 gives 0)."""
    out = torch.zeros(planes.shape[1] * WORD_BITS, dtype=torch.int32,
                      device=planes.device)
    for b in range(min(planes.shape[0], WORD_BITS)):
        out |= unpack_word_bits(planes[b]) << b
    return out


def _compact(vals: torch.Tensor, sel_bits: torch.Tensor) -> torch.Tensor:
    """Stable stream compaction: the selected records of ``vals``
    ``(n_attrs, n_rec)`` move to the front in record order; the tail is
    zeros."""
    sel = sel_bits != 0
    out = torch.zeros_like(vals)
    out[:, :int(sel.sum())] = vals[:, sel]
    return out


def materialize_torch(attr_planes: Sequence[torch.Tensor],
                      mask: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``attr_planes``: per-attribute ``(n_bits_a, W)`` int32 plane stacks;
    ``mask``: ``(W,)`` packed int32 selection. Returns ``((n_attrs, W*32)
    int32 values, (1,) int32 count)``; the first ``count`` columns are the
    selected records in record order."""
    sel = unpack_word_bits(mask)
    vals = torch.stack([decode_plane_values(p) for p in attr_planes])
    count = sel.sum(dtype=torch.int32)[None]
    return _compact(vals, sel), count


# --------------------------------------------------------------------------
# The CUDA kernel
# --------------------------------------------------------------------------
# Attributes one launch takes (``kMaxAttrs`` in the source); more are
# materialized in further launches of the same call.
MAX_ATTRS = 32
# A warp whose densest mask word selects more lanes than this decodes its
# words with the register bit transpose, else lane by lane (``kSparseMax``
# in the source): the best of 0-32 at path b's 16 shapes on an H100
# (PERF.md).
SPARSE_MAX = 8
# Per device: the tiles of the look-back kernel it holds at once, and per
# device and stream, that kernel's state (zeros between launches; the
# kernel returns it to zeros itself, so calls share it with no host
# bookkeeping).
_resident: Dict[torch.device, int] = {}
_states: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.materialize_n_tiles.argtypes = [ll]
    lib.materialize_n_tiles.restype = i
    for name in ("materialize_max_attrs", "materialize_sparse_max",
                 "materialize_resident_tiles"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.materialize_lookback_launch.argtypes = [
        ctypes.POINTER(p), ctypes.POINTER(i), i, p, ll, p, ll, p, p, p]
    lib.materialize_lookback_launch.restype = i
    lib.materialize_two_pass_launch.argtypes = [
        ctypes.POINTER(p), ctypes.POINTER(i), i, p, ll, p, ll, p, p, p]
    lib.materialize_two_pass_launch.restype = i
    if lib.materialize_max_attrs() != MAX_ATTRS:
        raise RuntimeError("materialize.cu's kMaxAttrs != MAX_ATTRS")
    if lib.materialize_sparse_max() != SPARSE_MAX:
        raise RuntimeError("materialize.cu's kSparseMax != SPARSE_MAX")


def _library() -> ctypes.CDLL:
    return build.library("materialize", _bind)


def _look_back_state(dev: torch.device, stream: int) -> torch.Tensor:
    """The look-back kernel's state on ``stream``: one zeroed int64 word
    for its counters and one per tile the device holds at once."""
    st = _states.get((dev, stream))
    if st is None:
        st = _states[(dev, stream)] = torch.zeros(
            1 + _resident[dev], dtype=torch.int64, device=dev)
    return st


def materialize_kernel(attr_planes: Sequence[torch.Tensor],
                       mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`materialize_torch`'s contract, computed on the current CUDA
    stream by ``csrc/materialize.cu``: one launch per ``MAX_ATTRS``
    attributes, the single-pass look-back scan, where all the call's tiles
    fit on the card at once; else a count launch and a decode launch,
    which measured faster there. The count stays on the device; the values
    past it are undefined."""
    lib = _library()
    dev = mask.device
    if dev.type != "cuda" or mask.dim() != 1:
        raise ValueError(f"mask must be a 1-D CUDA tensor, got "
                         f"{tuple(mask.shape)} on {dev}")
    w = mask.shape[0]
    check_int32(mask, "mask", (w,), dev)
    for k, p in enumerate(attr_planes):
        if p.dim() != 2:
            raise ValueError(f"attr_planes[{k}] must be 2-D, got "
                             f"{tuple(p.shape)}")
        check_int32(p, f"attr_planes[{k}]", (p.shape[0], w), dev)
    if w * WORD_BITS >= 1 << 31:
        raise ValueError(f"{w} words hold more records than an int32 "
                         "count")
    n_attrs = len(attr_planes)
    vals = torch.empty((n_attrs, w * WORD_BITS), dtype=torch.int32,
                       device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    if w == 0:
        return vals, count.zero_()
    err = 0
    with torch.cuda.device(dev):
        if dev not in _resident:
            _resident[dev] = lib.materialize_resident_tiles()
        n_tiles = lib.materialize_n_tiles(w)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if n_tiles <= _resident[dev]:
            launch = lib.materialize_lookback_launch
            scratch = _look_back_state(dev, stream)
        else:
            launch = lib.materialize_two_pass_launch
            scratch = torch.empty(n_tiles, dtype=torch.int32, device=dev)
        for a0 in range(0, max(n_attrs, 1), MAX_ATTRS):
            chunk = attr_planes[a0:a0 + MAX_ATTRS]
            ptrs = (ctypes.c_void_p * len(chunk))(
                *(p.data_ptr() for p in chunk))
            bits = (ctypes.c_int * len(chunk))(*(p.shape[0] for p in chunk))
            err = launch(ptrs, bits, len(chunk), mask.data_ptr(), w,
                         vals.data_ptr() + a0 * w * WORD_BITS * 4,
                         w * WORD_BITS, count.data_ptr(), scratch.data_ptr(),
                         stream)
            if err:
                break
    if err != 0:
        raise RuntimeError(f"materialize launch failed: CUDA error {err}")
    global launches
    launches += 1
    return vals, count


def materialize(planes, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize one attribute (a ``(n_bits, W)`` int32 plane stack) or a
    sequence of them under the packed ``(W,)`` ``mask``. Returns
    ``(values, count)``: ``values`` is ``(W*32,)`` for one stack and
    ``(n_attrs, W*32)`` for a sequence, ``count`` a ``(1,)`` int32 tensor
    on the mask's device (``int(count)`` is the reference's integer), and
    ``values[..., :count]`` are the selected records in record order —
    ``unpack_bits(planes)[unpack_mask(mask)]``.

    A CPU tensor runs :func:`materialize_torch`; a CUDA tensor launches
    the kernel on the current stream, or raises."""
    single = isinstance(planes, torch.Tensor)
    plane_list = [planes] if single else list(planes)
    fn = materialize_torch if mask.device.type == "cpu" \
        else materialize_kernel
    vals, count = fn(plane_list, mask)
    return (vals[0] if single else vals), count
