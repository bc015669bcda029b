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
slot), and entries whose result nobody reads are dropped. A row of the
stacked input is an operand in its own right: the kernel stages each
tile's rows in shared memory, so reading one needs no entry and no slot.
:meth:`TapeRecorder.finish` then re-orders the surviving entries (the
same DAG) with a list scheduler that keeps the live set small, and gives
the virtual registers physical slots by a linear scan over last use.

Tape entry: ``(opcode, dst, a, b, c)``. Operands are addresses: below
``n_rows`` a staged row of the stacked input, from ``n_rows`` on slot
``addr - n_rows``. ``c`` is the output mask row of a STORE, the popcount
column of a POPC, or the MIN/MAX column of a narrowing step. The kernel
reads each entry as one 64-bit word (:func:`pack_entries`). Opcode values
are shared with the CUDA source.

Outputs of one launch (``fused_program``): ``masks (n_masks, W)`` int32
packed result masks, ``pc (n_pc,)`` int64 exact popcount totals, and
``mm (n_tiles, n_mm)`` int32 per-tile MIN/MAX candidate bits + found
flags, which ``core.program.combine_minmax_candidates`` reduces. A tile
is ``Tape.tile`` words (the tape's :class:`~.common.Launch`).
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import build
from .common import Launch, plan_launch, popcount

# Opcodes — keep in step with csrc/fused_program.cu. A pure op (below
# POPC) is its own truth table: bits 0, 1, 2 select x & y, x ^ y and a
# final NOT (NOT = x & x, negated; OR = (x & y) ^ (x ^ y)).
CONST0, AND, XOR, OR, CONST1, NOT = 0, 1, 2, 3, 4, 5
POPC, STORE, MAXSTEP, MINSTEP, ANY = 8, 9, 10, 11, 12
_PURE = frozenset({CONST0, CONST1, NOT, AND, OR, XOR})
_READS_A = frozenset({NOT, AND, OR, XOR, STORE, POPC, MAXSTEP, MINSTEP, ANY})
_READS_B = frozenset({AND, OR, XOR, POPC, MAXSTEP, MINSTEP})
_WRITES = frozenset({CONST0, CONST1, NOT, AND, OR, XOR, MAXSTEP, MINSTEP})

# Packed entry: (field, lowest bit, bits) in ``Tape.ops`` column order.
# dst, a and b are shared-memory byte offsets in 16-byte units (below
# 256 KB), placed so that the kernel reads each with one mask or shift:
# low word op | a << 4 | dst << 18, high word b << 4 | c << 18.
_FIELDS = (("op", 0, 4), ("dst", 18, 14), ("a", 4, 14), ("b", 36, 14),
           ("c", 50, 14))


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
# Packed entries
# --------------------------------------------------------------------------
def pack_entries(ops: np.ndarray) -> np.ndarray:
    """``(n, 5)`` entries (op, dst, a, b, c) -> ``(n,)`` uint64 words: op
    in bits 0–3, a 4–17, dst 18–31, b 36–49, c 50–63 (``_FIELDS``).
    Raises if a field is negative or does not fit its bits."""
    ops = np.asarray(ops, np.int64).reshape(-1, 5)
    code = np.zeros(len(ops), np.uint64)
    for j, (name, shift, bits) in enumerate(_FIELDS):
        f = ops[:, j]
        if len(f) and (f.min() < 0 or f.max() >= 1 << bits):
            raise ValueError(f"tape field {name} out of range [0, "
                             f"{1 << bits}): {int(f.min())}..{int(f.max())}")
        code |= f.astype(np.uint64) << np.uint64(shift)
    return code


def unpack_entries(code: np.ndarray) -> np.ndarray:
    """The inverse of :func:`pack_entries`: ``(n, 5)`` int32 entries."""
    code = np.asarray(code, np.uint64)
    out = np.zeros((len(code), 5), np.int32)
    for j, (_, shift, bits) in enumerate(_FIELDS):
        out[:, j] = (code >> np.uint64(shift)) & np.uint64((1 << bits) - 1)
    return out


# --------------------------------------------------------------------------
# Recorder: folding, dead-entry removal, scheduling, slot allocation
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class Tape:
    """A lowered relation program, ready to launch.

    ``ops`` is ``(n_ops, 5)`` int32: opcode, dst, a, b, c (operands are
    addresses: a staged row below ``n_rows``, else slot ``addr -
    n_rows``). ``n_rows`` is the stacked input's row count;
    ``slots_recorded`` the slots the entries would need in the order they
    were recorded, before scheduling; ``launch`` the kernel's block and
    tile; :attr:`code` the kernel's packed entries for that launch."""
    ops: np.ndarray
    n_slots: int
    n_rows: int
    n_masks: int
    n_pc: int
    n_mm: int
    slots_recorded: int
    launch: Launch
    _device_code: Dict[tuple, torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    def __len__(self) -> int:
        return len(self.ops)

    @property
    def tile(self) -> int:
        """Words per tile: one MIN/MAX row of ``mm`` each."""
        return self.launch.tile

    @property
    def n_planes(self) -> int:
        """Planes of shared memory: the staged rows, then the slots."""
        return self.n_rows + self.n_slots

    @property
    def smem_bytes(self) -> int:
        return self.launch.smem_bytes(self.n_planes, self.n_pc)

    def with_words_per_thread(self, k: int) -> "Tape":
        """The same tape launched with ``k`` words per thread (its tile and
        hence its ``mm`` rows change with it)."""
        return dataclasses.replace(self, launch=plan_launch(
            self.n_planes, self.n_pc, k))

    def word_ops(self) -> Tuple[int, int]:
        """Operations per word column of one launch, as ``(logic, popc)``:
        32-bit logic and integer-add instructions, and population counts.
        NOT, AND, OR and XOR are one logic op each; POPC is an AND, a
        popcount and an add; a MIN/MAX step is a masked AND and a select.
        STORE, constants and the block-wide votes do no per-word
        arithmetic."""
        op = self.ops[:, 0]
        n_popc = int((op == POPC).sum())
        n_logic = (int(np.isin(op, (NOT, AND, OR, XOR)).sum()) + 2 * n_popc
                   + 2 * int(np.isin(op, (MAXSTEP, MINSTEP)).sum()))
        return n_logic, n_popc

    @functools.cached_property
    def code(self) -> np.ndarray:
        """The kernel's packed entries for ``launch``: addresses as byte
        offsets of planes of ``tile`` words (:func:`pack_entries`).
        Raises if a field overflows."""
        f = self.ops.astype(np.int64)
        f[f[:, 0] == NOT, 3] = f[f[:, 0] == NOT, 2]    # NOT reads x twice
        f[:, 1:4] *= self.tile // 4                # 16-byte units
        return pack_entries(f)

    def device_code(self, device: torch.device) -> torch.Tensor:
        """:attr:`code` on ``device``, copied there once."""
        key = (str(device), self.launch)
        t = self._device_code.get(key)
        if t is None:
            t = torch.from_numpy(self.code.view(np.int64)).to(device)
            self._device_code[key] = t
        return t


class TapeRecorder:
    """Collects plane ops with virtual registers, then :meth:`finish`
    turns them into a :class:`Tape`. An operand is a virtual register
    (``>= 0``) or stacked-input row ``r`` (``-1 - r``)."""

    def __init__(self):
        self._ops: List[List[int]] = []       # [op, dst vreg, a, b, c]
        self._n_regs = 0
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

    def _operand(self, x: SymPlane) -> int:
        """The operand holding ``x``: its row, its virtual register, or a
        CONST entry emitted on first need."""
        if x.kind == "reg":
            return x.ref
        if x.kind == "row":
            return -1 - x.ref
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
        return SymPlane(self, "reg", self._emit(op, self._operand(x),
                                                self._operand(y)))

    def invert(self, x: SymPlane) -> SymPlane:
        if x.kind == "const":
            return self.const(not x.ref)
        if x.neg is not None:
            return x.neg
        return SymPlane(self, "reg", self._emit(NOT, self._operand(x)),
                        neg=x)

    # -- side effects ----------------------------------------------------------
    def store(self, x: SymPlane, mask_row: int) -> None:
        self._emit(STORE, a=self._operand(x), c=mask_row, writes=False)

    def popcount(self, x: SymPlane, y: SymPlane, col: int) -> None:
        """Accumulate popcount(x & y) into popcount column ``col``."""
        if x.is_const(0) or y.is_const(0):
            return                           # the accumulator starts at 0
        if x.is_const(1) and not y.is_const(1):
            x = y
        elif y.is_const(1) and not x.is_const(1):
            y = x
        a = self._operand(x)
        b = a if y.key == x.key else self._operand(y)
        self._emit(POPC, a=a, b=b, c=col, writes=False)

    def narrow(self, cand: SymPlane, plane: SymPlane, is_max: bool,
               col: int) -> SymPlane:
        """One MSB-first MIN/MAX step: t = cand & plane (max) or
        cand & ~plane (min); the tile-wide any(t) is the extremum's bit
        (inverted for min), written to column ``col``; the candidates
        narrow to t where any(t) holds."""
        return SymPlane(self, "reg", self._emit(
            MAXSTEP if is_max else MINSTEP, self._operand(cand),
            self._operand(plane), col))

    def any(self, x: SymPlane, col: int) -> None:
        """Write the tile-wide any(x != 0) to MIN/MAX column ``col``."""
        self._emit(ANY, a=self._operand(x), c=col, writes=False)

    # -- lowering ----------------------------------------------------------------
    def finish(self, n_rows: int, n_masks: int, n_pc: int,
               n_mm: int) -> Tape:
        ops = _live_entries(self._ops)
        slots_recorded = _allocate(ops, range(len(ops)), n_rows)[1]
        out, n_slots = min((_allocate(ops, _schedule(ops, b_first), n_rows)
                            for b_first in (False, True)),
                           key=lambda r: r[1])
        tape = Tape(out, n_slots, n_rows, n_masks, n_pc, n_mm,
                    slots_recorded, plan_launch(n_rows + n_slots, n_pc))
        tape.code                            # raises if a field overflows
        return tape


def _reads(op: int, a: int, b: int) -> List[int]:
    """The distinct operands an entry reads."""
    out = [a] if op in _READS_A else []
    if op in _READS_B and b != a:
        out.append(b)
    return out


def _live_entries(ops: Sequence[List[int]]) -> List[List[int]]:
    """Dead-entry removal (backwards): a pure entry survives only if a
    surviving entry reads its result."""
    needed = set()
    keep = [False] * len(ops)
    for i in range(len(ops) - 1, -1, -1):
        op, d, a, b, _ = ops[i]
        if op in _PURE and d not in needed:
            continue
        keep[i] = True
        needed.update(_reads(op, a, b))
    return [o for o, k in zip(ops, keep) if k]


def _schedule(ops: Sequence[List[int]], b_first: bool) -> List[int]:
    """A schedule of the entries' DAG that keeps few registers live: a
    depth-first post-order from the sinks (entries whose result nobody
    reads: STORE, POPC, ANY, the last MIN/MAX step), taken in recorded
    order, with each entry's operands visited ``a`` first, or ``b`` first
    if ``b_first``. A POPC, STORE or ANY is emitted as soon as its
    operands exist, so the values it reads can die at once.

    A sink's whole cone is computed right before it, so a value lives
    from its cone to its last reader, not from the recorded schedule's
    batch to its job: one product bit at a time instead of whole CSA
    levels. Only data dependences order entries (POPCs add into int64
    columns, each MIN/MAX step writes its own column), so any such order
    gives the same outputs."""
    users: Dict[int, List[int]] = collections.defaultdict(list)
    producer: Dict[int, int] = {}
    regs = []
    for i, (op, d, a, b, _) in enumerate(ops):
        regs.append([v for v in _reads(op, a, b) if v >= 0])
        for v in regs[-1]:
            users[v].append(i)
        if op in _WRITES:
            producer[d] = i
    feeds = [op in _WRITES and d in users for op, d, *_ in ops]
    seen = [False] * len(ops)
    done = [False] * len(ops)
    order: List[int] = []

    def emit(i: int) -> None:
        order.append(i)
        done[i] = True
        if not feeds[i]:
            return
        for u in users[ops[i][1]]:
            if not (feeds[u] or seen[u]) and all(done[producer[v]]
                                                 for v in regs[u]):
                seen[u] = done[u] = True
                order.append(u)

    for sink in range(len(ops)):
        if feeds[sink] or seen[sink]:
            continue
        stack = [(sink, False)]
        while stack:
            i, expanded = stack.pop()
            if expanded:
                emit(i)
            elif not seen[i]:
                seen[i] = True
                stack.append((i, True))
                todo = [producer[v] for v in regs[i]]
                stack.extend((j, False) for j in
                             (todo if b_first else todo[::-1])
                             if not seen[j])
    assert len(order) == len(ops)
    return order


def _allocate(ops: Sequence[List[int]], order: Sequence[int], n_rows: int
              ) -> Tuple[np.ndarray, int]:
    """Entries ``ops`` in ``order`` with physical operand addresses: rows
    keep their row, virtual registers get slots by a linear scan over last
    use (a source that dies at an entry frees its slot before the entry's
    result takes one). Returns ``(entries, n_slots)``."""
    last: Dict[int, int] = {}
    for t, i in enumerate(order):
        op, _, a, b, _ = ops[i]
        for v in _reads(op, a, b):
            last[v] = t
    slot: Dict[int, int] = {}
    free: List[int] = []
    n_slots = 0
    out = np.zeros((len(order), 5), np.int32)

    def addr(v: int) -> int:
        return -1 - v if v < 0 else n_rows + slot[v]

    for t, i in enumerate(order):
        op, d, a, b, c = ops[i]
        sa = addr(a) if op in _READS_A else 0
        sb = addr(b) if op in _READS_B else 0
        for v in _reads(op, a, b):
            if v >= 0 and last[v] == t:
                free.append(slot.pop(v))
        sd = 0
        if op in _WRITES:
            if free:
                s = free.pop()
            else:
                s = n_slots
                n_slots += 1
            if d in last:
                slot[d] = s
            else:
                free.append(s)                   # result never read
            sd = n_rows + s
        out[t] = (op, sd, sa, sb, c)
    return out, n_slots


# --------------------------------------------------------------------------
# Plain PyTorch version
# --------------------------------------------------------------------------
def fused_program_torch(stacked: torch.Tensor, tape: Tape
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Execute a tape with whole-plane PyTorch ops: the same operands, the
    same per-tile MIN/MAX narrowing and the same outputs as the kernel,
    bit for bit. The tile is the kernel's (``tape.tile``); words past
    ``W`` in the last tile are zero inputs and reach no output."""
    rows, w = stacked.shape
    t = tape.tile
    n_tiles = -(-w // t)
    wp = n_tiles * t
    src = torch.nn.functional.pad(stacked, (0, wp - w))
    live = torch.zeros(wp, dtype=torch.int32, device=stacked.device)
    live[:w] = -1
    vals: List[Optional[torch.Tensor]] = (list(src.unbind(0))
                                          + [None] * tape.n_slots)
    masks = torch.zeros((tape.n_masks, w), dtype=torch.int32,
                        device=stacked.device)
    pc = torch.zeros(tape.n_pc, dtype=torch.int64, device=stacked.device)
    mm = torch.zeros((n_tiles, tape.n_mm), dtype=torch.int32,
                     device=stacked.device)

    def tile_any(x: torch.Tensor) -> torch.Tensor:
        return (x & live).view(n_tiles, t).ne(0).any(dim=1)

    for op, d, a, b, c in tape.ops.tolist():
        if op == STORE:
            masks[c] = vals[a][:w]
        elif op == CONST0:
            vals[d] = torch.zeros_like(live)
        elif op == CONST1:
            vals[d] = torch.full_like(live, -1)
        elif op == NOT:
            vals[d] = ~vals[a]
        elif op == AND:
            vals[d] = vals[a] & vals[b]
        elif op == OR:
            vals[d] = vals[a] | vals[b]
        elif op == XOR:
            vals[d] = vals[a] ^ vals[b]
        elif op == POPC:
            pc[c] += popcount(vals[a][:w] & vals[b][:w]).sum(
                dtype=torch.int64)
        elif op in (MAXSTEP, MINSTEP):
            cand = vals[a]
            x = cand & (vals[b] if op == MAXSTEP else ~vals[b]) & live
            has = tile_any(x)
            vals[d] = torch.where(has.repeat_interleave(t), x, cand)
            mm[:, c] = has if op == MAXSTEP else ~has
        elif op == ANY:
            mm[:, c] = tile_any(vals[a])
        else:
            raise ValueError(f"unknown tape opcode {op}")
    return masks, pc, mm


# --------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# --------------------------------------------------------------------------
# Kernel launches made by ``fused_program``; a caller that wants to show
# that a run went through the kernel resets and reads it.
launches = 0
# (device, k, threads, smem bytes) -> (blocks per SM, registers per thread)
_occupancy: Dict[tuple, Tuple[int, int]] = {}


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_program_launch.argtypes = [p, ll, p, i, i, i, p, p, i, p, i,
                                         i, i, i, ll, i, p]
    lib.fused_program_launch.restype = i
    pi = ctypes.POINTER(ctypes.c_int)
    lib.fused_program_occupancy.argtypes = [i, i, i, pi, pi]
    lib.fused_program_occupancy.restype = i


def _library() -> ctypes.CDLL:
    return build.library("fused_program", _bind)


def occupancy(tape: Tape, device: torch.device) -> Tuple[int, int]:
    """``(blocks per SM, registers per thread)`` of ``tape``'s launch on
    ``device``, from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` and
    ``cudaFuncGetAttributes`` (the registers ``nvcc -Xptxas -v`` reports).
    Raises if no block fits."""
    lc = tape.launch
    key = (str(device), lc.k, lc.threads, tape.smem_bytes)
    got = _occupancy.get(key)
    if got is None:
        blocks, regs = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            err = _library().fused_program_occupancy(
                lc.k, lc.threads, tape.smem_bytes, ctypes.byref(blocks),
                ctypes.byref(regs))
        if err != 0 or blocks.value < 1:
            raise RuntimeError(
                f"fused_program: no block of {lc.threads} threads, k "
                f"{lc.k}, {tape.smem_bytes} B shared memory fits an SM "
                f"(CUDA error {err})")
        got = _occupancy[key] = (blocks.value, regs.value)
    return got


def fused_program(stacked: torch.Tensor, tape: Tape
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run one lowered relation program over ``stacked`` — ``(rows, W)``
    int32, every source plane in the tape's row order then the valid
    plane. Returns ``(masks, pc, mm)`` as described in the module doc.

    A CPU tensor runs :func:`fused_program_torch`; a CUDA tensor launches
    the kernel on the current stream, or raises. The kernel runs
    ``min(n_tiles, SMs x blocks per SM)`` persistent blocks, each looping
    over tiles."""
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
    lc = tape.launch
    n_tiles = -(-w // lc.tile)
    per_sm, _ = occupancy(tape, dev)
    grid = max(1, min(n_tiles, per_sm * torch.cuda.get_device_properties(
        dev).multi_processor_count))
    # A block's int32 accumulators sum 32 bits per word of its tiles.
    if -(-n_tiles // grid) * lc.tile * 32 > 2**31 - 1:
        raise ValueError(f"fused_program: {w} words over {grid} blocks "
                         "overflow the int32 popcount accumulators")
    masks = torch.empty((tape.n_masks, w), dtype=torch.int32, device=dev)
    pc = torch.zeros(tape.n_pc, dtype=torch.int64, device=dev)
    mm = torch.empty((n_tiles, tape.n_mm), dtype=torch.int32, device=dev)
    code = tape.device_code(dev)
    with torch.cuda.device(dev):
        err = lib.fused_program_launch(
            stacked.data_ptr(), w, code.data_ptr(), len(tape), tape.n_rows,
            tape.n_planes, masks.data_ptr(), pc.data_ptr(),
            tape.n_pc, mm.data_ptr(), tape.n_mm, lc.k, lc.threads,
            tape.smem_bytes, n_tiles, grid,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_program launch failed: CUDA error {err} "
                           f"({grid} blocks of {lc.threads} threads, k "
                           f"{lc.k}, {tape.smem_bytes} B shared memory)")
    global launches
    launches += 1
    return masks, pc, mm
