"""Bit-serial predicates against an immediate: the CUDA kernels and their
plain versions.

Replaces the Pallas kernels ``repro/kernels/bitwise_filter.py::eq_imm``,
``::cmp_imm`` and ``::range_mask``. Planes are ``(n_bits, W)`` int32
tensors carrying the uint32 bit pattern; masks are ``(W,)`` words
(all-ones is ``-1``). As in the Pallas kernels, only the immediate's bits
below ``n_bits`` steer the ops: bits at or above it are ignored, so an
unrepresentable immediate is the caller's to short-circuit.

``eq_imm_torch``/``cmp_imm_torch``/``range_mask_torch`` are the plain
PyTorch versions (the reference's ``kernels/ref.py::predicate_*``); the
first two are also ``core.engine``'s ``eq_imm_planes``/``cmp_imm_planes``,
so they touch their operands only through ``& | ~``, indexing, ``len``
and ``torch.full_like``/``torch.zeros_like`` (the tape recorder's
symbolic planes run them too). ``eq_imm``, ``cmp_imm`` and ``range_mask``
launch ``csrc/bitwise_filter.cu`` on a CUDA tensor and run the plain
version on a CPU tensor. The same library holds ``filter_aggregate``'s
kernel; :func:`bind` sets up all four launchers.

Each kernel is bound by bytes (every plane word read once, every mask
word written once). All three put all of a thread's plane loads in
flight before folding (stacks of up to 32 planes at once, wider ones 16
at a time, ``cmp_imm``'s and ``range_mask``'s from the top plane down),
fold the immediate without a branch (``range_mask`` folds each loaded
chunk against ``lo`` and against ``hi``), and take two words a thread
where W is even and the pointers 8-byte aligned, in one wave of the
card's resident blocks. Their times on an H100: PERF.md §6.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build
from .common import check_int32

# The widest plane stack the kernels take (``kMaxBits`` in the source).
MAX_BITS = 1024

# Kernel launches made by ``eq_imm``, ``cmp_imm`` and ``range_mask``.
eq_imm_launches = 0
cmp_imm_launches = 0
range_mask_launches = 0


# --------------------------------------------------------------------------
# Plain PyTorch versions
# --------------------------------------------------------------------------
def eq_imm_torch(planes, imm: int):
    """(n_bits, W) -> (W,) mask of records == imm.

    Immediate bits steer the op (AND v_b vs AND ~v_b) — Algorithm 1.
    """
    acc = torch.full_like(planes[0], -1)
    for b in range(len(planes)):
        acc = acc & planes[b] if (imm >> b) & 1 else acc & ~planes[b]
    return acc


def cmp_imm_torch(planes, imm: int):
    """(n_bits, W) -> ``(lt, eq)`` masks of records against imm."""
    lt = torch.zeros_like(planes[0])
    eq = torch.full_like(planes[0], -1)
    for b in range(len(planes) - 1, -1, -1):   # MSB-first
        v = planes[b]
        if (imm >> b) & 1:
            lt = lt | (eq & ~v)
            eq = eq & v
        else:
            eq = eq & ~v
    return lt, eq


def range_mask_torch(planes: torch.Tensor, lo: int, hi: int
                     ) -> torch.Tensor:
    """(n_bits, W) -> mask of lo <= v < hi."""
    return ~cmp_imm_torch(planes, lo)[0] & cmp_imm_torch(planes, hi)[0]


# --------------------------------------------------------------------------
# The CUDA kernels
# --------------------------------------------------------------------------
def bind(lib: ctypes.CDLL) -> None:
    """Set the argument and result types of ``csrc/bitwise_filter.cu``'s
    four launchers."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    imm = ctypes.POINTER(ctypes.c_ulonglong)
    lib.eq_imm_launch.argtypes = [p, i, ll, imm, p, p]
    lib.cmp_imm_launch.argtypes = [p, i, ll, imm, p, p, p]
    lib.range_mask_launch.argtypes = [p, i, ll, imm, imm, p, p]
    lib.filter_sum_launch.argtypes = [p, i, p, i, p, ll, imm, imm, p, p, p]
    for fn in (lib.eq_imm_launch, lib.cmp_imm_launch,
               lib.range_mask_launch, lib.filter_sum_launch):
        fn.restype = i


def imm_words(imm: int, n_bits: int) -> ctypes.Array:
    """The low ``n_bits`` bits of an immediate (two's complement for a
    negative one, as ``(imm >> b) & 1`` reads it) as ``ceil(n_bits / 64)``
    64-bit words, least significant first — any width, never truncated
    to one machine word."""
    n = -(-n_bits // 64)
    imm &= (1 << n_bits) - 1
    return (ctypes.c_ulonglong * n)(
        *((imm >> (64 * k)) & 0xFFFFFFFFFFFFFFFF for k in range(n)))


def _launch(name: str, planes: torch.Tensor, imms, n_out: int):
    """Launch ``<name>_kernel`` on the current stream into ``n_out`` new
    ``(W,)`` masks and count the launch. An empty stack (``W == 0``)
    launches nothing, builds nothing and counts nothing."""
    dev = planes.device
    if dev.type != "cuda" or planes.dim() != 2:
        raise ValueError(f"{name} takes a 2-D CUDA or CPU plane stack, got "
                         f"{tuple(planes.shape)} on {dev}")
    n_bits, w = planes.shape
    if not 1 <= n_bits <= MAX_BITS:
        raise ValueError(f"{name} takes 1 to {MAX_BITS} planes, got "
                         f"{n_bits}")
    check_int32(planes, f"{name}'s planes", (n_bits, w), dev)
    lib = build.library("bitwise_filter", bind) if w else None
    outs = [torch.empty(w, dtype=torch.int32, device=dev)
            for _ in range(n_out)]
    if w:
        with torch.cuda.device(dev):
            err = getattr(lib, f"{name}_launch")(
                planes.data_ptr(), n_bits, w,
                *(imm_words(v, n_bits) for v in imms),
                *(o.data_ptr() for o in outs),
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        globals()[f"{name}_launches"] += 1
    return outs


def eq_imm(planes: torch.Tensor, imm: int) -> torch.Tensor:
    """(n_bits, W) -> (W,) packed mask of records == imm. A CPU tensor runs
    :func:`eq_imm_torch`; a CUDA tensor launches the kernel on the current
    stream, or raises."""
    if planes.device.type == "cpu":
        return eq_imm_torch(planes, imm)
    out, = _launch("eq_imm", planes, (imm,), 1)
    return out


def cmp_imm(planes: torch.Tensor, imm: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n_bits, W) -> ``(lt, eq)`` packed masks against imm. A CPU tensor
    runs :func:`cmp_imm_torch`; a CUDA tensor launches the kernel, or
    raises."""
    if planes.device.type == "cpu":
        return cmp_imm_torch(planes, imm)
    lt, eq = _launch("cmp_imm", planes, (imm,), 2)
    return lt, eq


def range_mask(planes: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """(n_bits, W) -> packed mask of lo <= v < hi, both comparator chains
    over one read of the planes. A CPU tensor runs
    :func:`range_mask_torch`; a CUDA tensor launches the kernel, or
    raises."""
    if planes.device.type == "cpu":
        return range_mask_torch(planes, lo, hi)
    out, = _launch("range_mask", planes, (lo, hi), 1)
    return out
