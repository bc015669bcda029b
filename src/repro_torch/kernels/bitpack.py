"""Bit pack/unpack — the column transform (the paper's Fig. 6): one value
per record packed 32 to an int32 word (bit ``j`` from column ``j``), and
back.

Replaces the Pallas kernels ``repro/kernels/bitpack.py::bitpack`` and
``::bitunpack``. ``bitpack_torch``/``bitunpack_torch`` are the plain
PyTorch versions (the reference's ``kernels/ref.py``); ``bitpack`` and
``bitunpack`` launch ``csrc/bitpack.cu`` on a CUDA tensor and run the
plain version on a CPU tensor. Words are int32 tensors carrying the
uint32 bit pattern.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .common import check_int32

WORD_BITS = 32

# Kernel launches made by ``bitpack`` and ``bitunpack``.
bitpack_launches = 0
bitunpack_launches = 0


# --------------------------------------------------------------------------
# Plain PyTorch versions
# --------------------------------------------------------------------------
def bitpack_torch(bits: torch.Tensor) -> torch.Tensor:
    """(W, 32) int32 -> (W,) int32 words: the sum over ``j`` of
    ``bits[:, j] << j`` mod 2^32, as the reference sums in uint32 (for 0/1
    input, bit ``j`` of each word is column ``j``)."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=bits.device)
    terms = ((bits.to(torch.int64) & 0xFFFFFFFF) << shifts) & 0xFFFFFFFF
    s = terms.sum(dim=1) & 0xFFFFFFFF
    return torch.where(s >= 1 << 31, s - (1 << 32), s).to(torch.int32)


def bitunpack_torch(words: torch.Tensor) -> torch.Tensor:
    """(W,) int32 words -> (W, 32) int32 of 0/1; the ``& 1`` makes the
    arithmetic shift of int32 act as a logical one."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    return (words[:, None] >> shifts) & 1


# --------------------------------------------------------------------------
# The CUDA kernels
# --------------------------------------------------------------------------
def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.bitpack_launch, lib.bitunpack_launch):
        fn.argtypes = [p, ll, p, p]
        fn.restype = i


def _library() -> ctypes.CDLL:
    return build.library("bitpack", _bind)


def _launch(name: str, src: torch.Tensor, shape, out_shape) -> torch.Tensor:
    lib = _library()
    if src.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{src.device}")
    check_int32(src, f"{name}'s input", shape, src.device)
    out = torch.empty(out_shape, dtype=torch.int32, device=src.device)
    if out.numel():
        with torch.cuda.device(src.device):
            err = getattr(lib, f"{name}_launch")(
                src.data_ptr(), shape[0], out.data_ptr(),
                torch.cuda.current_stream(src.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out


def bitpack(bits: torch.Tensor) -> torch.Tensor:
    """(W, 32) int32 -> (W,) packed int32 words. A CPU tensor runs
    :func:`bitpack_torch`; a CUDA tensor launches the kernel on the current
    stream, or raises."""
    if bits.device.type == "cpu":
        return bitpack_torch(bits)
    out = _launch("bitpack", bits, (bits.shape[0], WORD_BITS),
                  (bits.shape[0],))
    global bitpack_launches
    bitpack_launches += 1
    return out


def bitunpack(words: torch.Tensor) -> torch.Tensor:
    """(W,) int32 words -> (W, 32) int32 of 0/1. A CPU tensor runs
    :func:`bitunpack_torch`; a CUDA tensor launches the kernel on the
    current stream, or raises."""
    if words.device.type == "cpu":
        return bitunpack_torch(words)
    out = _launch("bitunpack", words, (words.shape[0],),
                  (words.shape[0], WORD_BITS))
    global bitunpack_launches
    bitunpack_launches += 1
    return out
