"""A whole compiled relation program as ONE CUDA kernel launch.

Replaces the Pallas kernel ``repro/kernels/program.py::fused_program``
(body ``_program_kernel``). The Pallas kernel unrolls the program at trace
time with the immediates baked in; here the program is lowered once into
a flat **plane-op tape** and one hand-written kernel
(``csrc/fused_program.cu``) interprets any tape, so a single ``nvcc``
build serves every query.

Recording: ``core.program._build_tape`` runs the port's own
``BitwiseEvaluator`` over the symbolic handles of this module
(:class:`SymPlane`/:class:`SymStack`), which implement exactly the tensor
surface the engine primitives use. Every ``& | ^ ~`` becomes a tape
entry; constants fold away while recording (an immediate never occupies a
slot), entries whose result nobody reads are dropped, and the surviving
virtual registers get physical slots by a linear scan over last use, so
the slot count tracks the program's live planes.

Tape entry: ``(opcode, dst slot, src a, src b, c)``; ``c`` is the output
mask row of a STORE, the popcount column of a POPC, or the MIN/MAX column
of a narrowing step. Opcode values are shared with the CUDA source.

Outputs of one launch (``fused_program``): ``masks (n_masks, W)`` int32
packed result masks, ``pc (n_pc,)`` int64 exact popcount totals, and
``mm (n_blocks, n_mm)`` int32 per-block MIN/MAX candidate bits + found
flags, which ``core.program.combine_minmax_candidates`` reduces.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import build
from .common import pick_block, popcount

# Opcodes — keep in step with csrc/fused_program.cu.
LOAD, STORE, CONST0, CONST1, NOT, AND, OR, XOR, POPC, MAXSTEP, MINSTEP, ANY \
    = range(12)
_PURE = frozenset({LOAD, CONST0, CONST1, NOT, AND, OR, XOR})
_READS_A = frozenset({NOT, AND, OR, XOR, STORE, POPC, MAXSTEP, MINSTEP, ANY})
_READS_B = frozenset({AND, OR, XOR, POPC, MAXSTEP, MINSTEP})
_WRITES = frozenset({LOAD, CONST0, CONST1, NOT, AND, OR, XOR, MAXSTEP,
                     MINSTEP})


# --------------------------------------------------------------------------
# Symbolic plane handles
# --------------------------------------------------------------------------
class _Sym:
    """Tensor-like base: the ``torch`` functions the engine primitives
    call on plane values, answered symbolically."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.stack:
            return SymStack(tuple(args[0]))
        if func is torch.cat:
            return SymStack(tuple(p for s in args[0] for p in s))
        if func is torch.zeros_like or func is torch.full_like:
            x = args[0]
            fill = 0 if func is torch.zeros_like else (
                args[1] if len(args) > 1 else kwargs["fill_value"])
            if fill not in (0, -1):
                raise ValueError(f"plane fill must be 0 or -1, got {fill}")
            const = x.rec.const(fill == -1)
            if isinstance(x, SymStack):
                return SymStack((const,) * len(x))
            return const
        raise NotImplementedError(f"{func} on symbolic planes")


class SymPlane(_Sym):
    """One ``(W,)`` plane of a tape being recorded: a constant (all-zero or
    all-one words), a row of the stacked input, or a virtual register."""
    __slots__ = ("rec", "kind", "ref", "neg")

    def __init__(self, rec: "TapeRecorder", kind: str, ref: int,
                 neg: Optional["SymPlane"] = None):
        self.rec = rec
        self.kind = kind        # "const" | "row" | "reg"
        self.ref = ref          # 0/1 | row index | virtual register
        self.neg = neg          # the plane this one is the NOT of, if any

    @property
    def key(self) -> Tuple[str, int]:
        return (self.kind, self.ref)

    def is_const(self, value: int) -> bool:
        return self.kind == "const" and self.ref == value

    def __getitem__(self, idx):
        if idx is None:
            return SymStack((self,))
        raise TypeError(f"cannot index a plane with {idx!r}")

    def _binary(self, op: int, other):
        if isinstance(other, SymStack):
            return SymStack((self,))._map(op, other)
        return self.rec.binary(op, self, other)

    def __and__(self, other):
        return self._binary(AND, other)

    def __or__(self, other):
        return self._binary(OR, other)

    def __xor__(self, other):
        return self._binary(XOR, other)

    def __invert__(self):
        return self.rec.invert(self)


class SymStack(_Sym):
    """An ``(n, W)`` plane stack: a tuple of :class:`SymPlane` with the
    indexing and broadcasting of a 2-D tensor."""
    __slots__ = ("planes",)

    def __init__(self, planes: Tuple[SymPlane, ...]):
        self.planes = planes

    @property
    def rec(self) -> "TapeRecorder":
        return self.planes[0].rec

    def __len__(self) -> int:
        return len(self.planes)

    def __iter__(self):
        return iter(self.planes)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return SymStack(self.planes[idx])
        return self.planes[idx]

    def _map(self, op: int, other) -> "SymStack":
        if isinstance(other, SymPlane):
            other = SymStack((other,))
        a, b = self.planes, other.planes
        if len(a) == 1 and len(b) != 1:
            a = a * len(b)
        elif len(b) == 1 and len(a) != 1:
            b = b * len(a)
        if len(a) != len(b):
            raise ValueError(f"plane stacks of {len(a)} and {len(b)}")
        return SymStack(tuple(x.rec.binary(op, x, y) for x, y in zip(a, b)))

    def __and__(self, other):
        return self._map(AND, other)

    def __or__(self, other):
        return self._map(OR, other)

    def __xor__(self, other):
        return self._map(XOR, other)

    def __invert__(self):
        return SymStack(tuple(~p for p in self.planes))


# --------------------------------------------------------------------------
# Recorder: folding, dead-entry removal, slot allocation
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class Tape:
    """A lowered relation program, ready to launch.

    ``ops`` is ``(n_ops, 5)`` int32: opcode, dst slot, src slot a (the
    stacked-input row for LOAD), src slot b, and c (STORE mask row / POPC
    column / MIN/MAX column). ``n_rows`` is the stacked input's row count.
    """
    ops: np.ndarray
    n_slots: int
    n_rows: int
    n_masks: int
    n_pc: int
    n_mm: int
    _device_ops: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    def __len__(self) -> int:
        return len(self.ops)

    @property
    def block(self) -> int:
        """Threads per block (= words per block) of this tape's launch."""
        return pick_block(self.n_slots, self.n_pc)

    def word_ops(self) -> Tuple[int, int]:
        """Operations per word column of one launch, as ``(logic, popc)``:
        32-bit logic and integer-add instructions, and population counts.
        NOT, AND, OR and XOR are one logic op each; POPC is an AND, a
        popcount and an add; a MIN/MAX step is a masked AND and a select.
        LOAD, STORE, constants and the block-wide votes do no per-word
        arithmetic."""
        op = self.ops[:, 0]
        n_popc = int((op == POPC).sum())
        n_logic = (int(np.isin(op, (NOT, AND, OR, XOR)).sum()) + 2 * n_popc
                   + 2 * int(np.isin(op, (MAXSTEP, MINSTEP)).sum()))
        return n_logic, n_popc

    def device_ops(self, device: torch.device) -> torch.Tensor:
        """The op table on ``device``, copied there once."""
        key = str(device)
        t = self._device_ops.get(key)
        if t is None:
            t = torch.from_numpy(self.ops).to(device)
            self._device_ops[key] = t
        return t


class TapeRecorder:
    """Collects plane ops with virtual registers, then :meth:`finish`
    turns them into a :class:`Tape`."""

    def __init__(self):
        self._ops: List[List[int]] = []       # [op, dst vreg, a, b, c]
        self._n_regs = 0
        self._loaded: Dict[int, int] = {}     # stacked row -> vreg
        self._consts = (SymPlane(self, "const", 0),
                        SymPlane(self, "const", 1))

    # -- handles -----------------------------------------------------------
    def const(self, ones: bool) -> SymPlane:
        return self._consts[int(ones)]

    def row(self, r: int) -> SymPlane:
        return SymPlane(self, "row", r)

    def rows(self, start: int, stop: int) -> SymStack:
        return SymStack(tuple(self.row(r) for r in range(start, stop)))

    def _emit(self, op: int, a: int = 0, b: int = 0, c: int = 0,
              writes: bool = True) -> int:
        d = -1
        if writes:
            d = self._n_regs
            self._n_regs += 1
        self._ops.append([op, d, a, b, c])
        return d

    def _reg(self, x: SymPlane) -> int:
        """The virtual register holding ``x``, emitting its LOAD (once per
        row) or CONST entry on first need."""
        if x.kind == "reg":
            return x.ref
        if x.kind == "row":
            v = self._loaded.get(x.ref)
            if v is None:
                v = self._loaded[x.ref] = self._emit(LOAD, a=x.ref)
            return v
        return self._emit(CONST1 if x.ref else CONST0)

    # -- pure ops, folded ----------------------------------------------------
    def binary(self, op: int, x: SymPlane, y: SymPlane) -> SymPlane:
        for p, q in ((x, y), (y, x)):
            if p.kind == "const":
                if op == AND:
                    return q if p.ref else p
                if op == OR:
                    return p if p.ref else q
                return ~q if p.ref else q                  # XOR
        if x.key == y.key:
            return self.const(False) if op == XOR else x
        return SymPlane(self, "reg", self._emit(op, self._reg(x),
                                                self._reg(y)))

    def invert(self, x: SymPlane) -> SymPlane:
        if x.kind == "const":
            return self.const(not x.ref)
        if x.neg is not None:
            return x.neg
        return SymPlane(self, "reg", self._emit(NOT, self._reg(x)), neg=x)

    # -- side effects ----------------------------------------------------------
    def store(self, x: SymPlane, mask_row: int) -> None:
        self._emit(STORE, a=self._reg(x), c=mask_row, writes=False)

    def popcount(self, x: SymPlane, y: SymPlane, col: int) -> None:
        """Accumulate popcount(x & y) into popcount column ``col``."""
        if x.is_const(0) or y.is_const(0):
            return                           # the accumulator starts at 0
        if x.is_const(1) and not y.is_const(1):
            x = y
        elif y.is_const(1) and not x.is_const(1):
            y = x
        a = self._reg(x)
        b = a if y.key == x.key else self._reg(y)
        self._emit(POPC, a=a, b=b, c=col, writes=False)

    def narrow(self, cand: SymPlane, plane: SymPlane, is_max: bool,
               col: int) -> SymPlane:
        """One MSB-first MIN/MAX step: t = cand & plane (max) or
        cand & ~plane (min); the block-wide any(t) is the extremum's bit
        (inverted for min), written to column ``col``; the candidates
        narrow to t where any(t) holds."""
        return SymPlane(self, "reg", self._emit(
            MAXSTEP if is_max else MINSTEP, self._reg(cand),
            self._reg(plane), col))

    def any(self, x: SymPlane, col: int) -> None:
        """Write the block-wide any(x != 0) to MIN/MAX column ``col``."""
        self._emit(ANY, a=self._reg(x), c=col, writes=False)

    # -- lowering ----------------------------------------------------------------
    def finish(self, n_rows: int, n_masks: int, n_pc: int,
               n_mm: int) -> Tape:
        ops = self._ops
        # Dead-entry removal (backwards): a pure entry survives only if a
        # surviving entry reads its result.
        needed = set()
        keep = [False] * len(ops)
        for i in range(len(ops) - 1, -1, -1):
            op, d, a, b, _ = ops[i]
            if op in _PURE and d not in needed:
                continue
            keep[i] = True
            if op in _READS_A:
                needed.add(a)
            if op in _READS_B:
                needed.add(b)
        ops = [o for o, k in zip(ops, keep) if k]

        # Linear-scan slot allocation over last use.
        last: Dict[int, int] = {}
        for i, (op, _, a, b, _) in enumerate(ops):
            if op in _READS_A:
                last[a] = i
            if op in _READS_B:
                last[b] = i
        slot: Dict[int, int] = {}
        free: List[int] = []
        n_slots = 0
        out = np.zeros((len(ops), 5), np.int32)
        for i, (op, d, a, b, c) in enumerate(ops):
            sa = slot[a] if op in _READS_A else a      # LOAD: a is a row
            sb = slot[b] if op in _READS_B else 0
            reads = [a] if op in _READS_A else []
            if op in _READS_B and b != a:
                reads.append(b)
            for v in reads:                          # sources die first, so
                if last[v] == i:                     # dst may take a slot
                    free.append(slot.pop(v))         # it reads from
            sd = 0
            if op in _WRITES:
                if free:
                    sd = free.pop()
                else:
                    sd = n_slots
                    n_slots += 1
                if d in last:
                    slot[d] = sd
                else:
                    free.append(sd)                  # result never read
            out[i] = (op, sd, sa, sb, c)
        return Tape(out, n_slots, n_rows, n_masks, n_pc, n_mm)


# --------------------------------------------------------------------------
# Plain PyTorch version
# --------------------------------------------------------------------------
def fused_program_torch(stacked: torch.Tensor, tape: Tape
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Execute a tape with whole-plane PyTorch ops: the same slots, the
    same per-block MIN/MAX narrowing and the same outputs as the kernel,
    bit for bit. The block size is the kernel's (``tape.block``); words
    past ``W`` in the last block are zero inputs and reach no output."""
    rows, w = stacked.shape
    t = tape.block
    n_blocks = -(-w // t)
    wp = n_blocks * t
    src = torch.nn.functional.pad(stacked, (0, wp - w))
    live = torch.zeros(wp, dtype=torch.int32, device=stacked.device)
    live[:w] = -1
    slots: List[Optional[torch.Tensor]] = [None] * tape.n_slots
    masks = torch.zeros((tape.n_masks, w), dtype=torch.int32,
                        device=stacked.device)
    pc = torch.zeros(tape.n_pc, dtype=torch.int64, device=stacked.device)
    mm = torch.zeros((n_blocks, tape.n_mm), dtype=torch.int32,
                     device=stacked.device)

    def block_any(x: torch.Tensor) -> torch.Tensor:
        return (x & live).view(n_blocks, t).ne(0).any(dim=1)

    for op, d, a, b, c in tape.ops.tolist():
        if op == LOAD:
            slots[d] = src[a]
        elif op == STORE:
            masks[c] = slots[a][:w]
        elif op == CONST0:
            slots[d] = torch.zeros_like(live)
        elif op == CONST1:
            slots[d] = torch.full_like(live, -1)
        elif op == NOT:
            slots[d] = ~slots[a]
        elif op == AND:
            slots[d] = slots[a] & slots[b]
        elif op == OR:
            slots[d] = slots[a] | slots[b]
        elif op == XOR:
            slots[d] = slots[a] ^ slots[b]
        elif op == POPC:
            pc[c] += popcount(slots[a][:w] & slots[b][:w]).sum(
                dtype=torch.int64)
        elif op in (MAXSTEP, MINSTEP):
            cand = slots[a]
            x = cand & (slots[b] if op == MAXSTEP else ~slots[b]) & live
            has = block_any(x)
            slots[d] = torch.where(has.repeat_interleave(t), x, cand)
            mm[:, c] = has if op == MAXSTEP else ~has
        elif op == ANY:
            mm[:, c] = block_any(slots[a])
        else:
            raise ValueError(f"unknown tape opcode {op}")
    return masks, pc, mm


# --------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# --------------------------------------------------------------------------
# Kernel launches made by ``fused_program``; a caller that wants to show
# that a run went through the kernel resets and reads it.
launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_program_launch.argtypes = [p, ll, p, i, i, p, p, i, p, i, i,
                                         i, p]
    lib.fused_program_launch.restype = i


def _library() -> ctypes.CDLL:
    return build.library("fused_program", _bind)


def fused_program(stacked: torch.Tensor, tape: Tape
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run one lowered relation program over ``stacked`` — ``(rows, W)``
    int32, every source plane in the tape's row order then the valid
    plane. Returns ``(masks, pc, mm)`` as described in the module doc.

    A CPU tensor runs :func:`fused_program_torch`; a CUDA tensor launches
    the kernel on the current stream, or raises."""
    if stacked.device.type == "cpu":
        return fused_program_torch(stacked, tape)
    lib = _library()
    if stacked.device.type != "cuda":
        raise ValueError(f"fused_program runs on cuda or cpu tensors, "
                         f"not {stacked.device}")
    if stacked.dtype != torch.int32 or stacked.dim() != 2:
        raise ValueError(f"stacked must be a 2-D int32 tensor, got "
                         f"{stacked.dtype} {tuple(stacked.shape)}")
    if stacked.shape[0] != tape.n_rows or not stacked.is_contiguous():
        raise ValueError(f"stacked must be contiguous with {tape.n_rows} "
                         f"rows, got {tuple(stacked.shape)}")
    dev = stacked.device
    w = stacked.shape[1]
    t = tape.block
    n_blocks = -(-w // t)
    masks = torch.empty((tape.n_masks, w), dtype=torch.int32, device=dev)
    pc = torch.zeros(tape.n_pc, dtype=torch.int64, device=dev)
    mm = torch.empty((n_blocks, tape.n_mm), dtype=torch.int32, device=dev)
    ops = tape.device_ops(dev)
    smem = (tape.n_slots * t + tape.n_pc) * 4
    with torch.cuda.device(dev):
        err = lib.fused_program_launch(
            stacked.data_ptr(), w, ops.data_ptr(), len(tape), tape.n_slots,
            masks.data_ptr(), pc.data_ptr(), tape.n_pc, mm.data_ptr(),
            tape.n_mm, t, smem, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_program launch failed: CUDA error {err} "
                           f"(block {t}, {smem} B shared memory)")
    global launches
    launches += 1
    return masks, pc, mm
