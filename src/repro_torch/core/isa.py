"""PIM instruction set (paper §3.3, §4.2, Table 4).

Each instruction is a dataclass carrying everything a *PIM request*
carries in the paper: opcode, operand locations (attribute names stand in
for crossbar column ranges), immediate values, and the destination. The
cycle-count and intermediate-cell formulas are transcribed from Table 4
(crossbar 1024x512); they drive the latency/energy/endurance models.

The paper's key instruction-design trick (Algorithm 1) — immediates steer
the control path instead of being written to memory — appears here as
*trace-time specialisation*: the per-bit op sequence emitted by the engine
depends on each immediate bit, and the immediate is never materialised as
a bit-plane.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _popcounts(imm: int, n_bits: int) -> Tuple[int, int]:
    """(#zero bits, #one bits) of an n-bit immediate — Table 4's imm0/imm1."""
    imm1 = bin(imm & ((1 << n_bits) - 1)).count("1")
    return n_bits - imm1, imm1


@dataclasses.dataclass(frozen=True)
class PimInstruction:
    """Base class. ``dest`` names the output mask/attribute register."""
    dest: str

    def cycles(self) -> int:
        raise NotImplementedError

    def intermediate_cells(self) -> int:
        raise NotImplementedError

    # Row-wise vs column-wise cycle split (paper §6.1/§6.4: column-transform
    # and reduce are dominated by row-wise single-column moves).
    def row_cycles(self) -> int:
        return 0

    def col_cycles(self) -> int:
        return self.cycles() - self.row_cycles()

    def row_write_ops(self) -> float:
        """Cell writes this instruction costs the *busiest row* (§6.4).

        Every column-wise stateful cycle conditions one cell per row, so
        a row sees one write per column cycle. Row-wise cycles touch one
        row each, spread across the crossbar — the per-row share is the
        per-class amortization the aggregate endurance model uses (see
        ``cost_model.endurance_ops_per_cell``).
        """
        return float(self.col_cycles())

    def cells_written(self) -> int:
        """Total memory cells this instruction *persistently* programs
        (DML write kinds only — compute kinds write intermediates, which
        the endurance model already charges via ``row_write_ops``)."""
        return 0

    @property
    def kind(self) -> str:
        return type(self).__name__


# --------------------------------------------------------------------------
# Filter comparisons vs. immediates (Table 4 rows 1-4)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EqualImm(PimInstruction):
    attr: str = ""
    imm: int = 0
    n_bits: int = 0

    def cycles(self) -> int:
        i0, i1 = _popcounts(self.imm, self.n_bits)
        return i0 + 3 * i1 + 1

    def intermediate_cells(self) -> int:
        return 1


@dataclasses.dataclass(frozen=True)
class NotEqualImm(PimInstruction):
    attr: str = ""
    imm: int = 0
    n_bits: int = 0

    def cycles(self) -> int:
        i0, i1 = _popcounts(self.imm, self.n_bits)
        return i0 + 3 * i1 + 3

    def intermediate_cells(self) -> int:
        return 2


@dataclasses.dataclass(frozen=True)
class LessThanImm(PimInstruction):
    attr: str = ""
    imm: int = 0
    n_bits: int = 0
    or_equal: bool = False

    def cycles(self) -> int:
        i0, i1 = _popcounts(self.imm, self.n_bits)
        return 11 * i0 + 3 * i1 + 4

    def intermediate_cells(self) -> int:
        return 5


@dataclasses.dataclass(frozen=True)
class GreaterThanImm(PimInstruction):
    attr: str = ""
    imm: int = 0
    n_bits: int = 0
    or_equal: bool = False

    def cycles(self) -> int:
        i0, i1 = _popcounts(self.imm, self.n_bits)
        return 11 * i0 + 3 * i1 + 2

    def intermediate_cells(self) -> int:
        return 6


# --------------------------------------------------------------------------
# Attribute-vs-attribute comparisons (Table 4 rows "Equal", "Less Than")
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Equal(PimInstruction):
    attr_a: str = ""
    attr_b: str = ""
    n_bits: int = 0

    def cycles(self) -> int:
        return 11 * self.n_bits + 3

    def intermediate_cells(self) -> int:
        return 5


@dataclasses.dataclass(frozen=True)
class LessThan(PimInstruction):
    attr_a: str = ""
    attr_b: str = ""
    n_bits: int = 0
    or_equal: bool = False

    def cycles(self) -> int:
        return 16 * self.n_bits + 2

    def intermediate_cells(self) -> int:
        return 6


# --------------------------------------------------------------------------
# Mask logic (Table 4 Set/Reset, NOT, AND, OR) — operate on 1-bit masks or
# n-bit attributes; n = operand width.
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SetReset(PimInstruction):
    value: int = 0
    n_bits: int = 1

    def cycles(self) -> int:
        return self.n_bits

    def intermediate_cells(self) -> int:
        return 0


@dataclasses.dataclass(frozen=True)
class BitwiseNot(PimInstruction):
    src: str = ""
    n_bits: int = 1

    def cycles(self) -> int:
        return 2 * self.n_bits

    def intermediate_cells(self) -> int:
        return 0


@dataclasses.dataclass(frozen=True)
class BitwiseAnd(PimInstruction):
    src_a: str = ""
    src_b: str = ""
    n_bits: int = 1

    def cycles(self) -> int:
        return 6 * self.n_bits

    def intermediate_cells(self) -> int:
        return 2


@dataclasses.dataclass(frozen=True)
class BitwiseOr(PimInstruction):
    src_a: str = ""
    src_b: str = ""
    n_bits: int = 1

    def cycles(self) -> int:
        return 4 * self.n_bits

    def intermediate_cells(self) -> int:
        return 1


# --------------------------------------------------------------------------
# Arithmetic (Table 4 Add imm / Addition / Multiply)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AddImm(PimInstruction):
    attr: str = ""
    imm: int = 0
    n_bits: int = 0

    def cycles(self) -> int:
        return 18 * self.n_bits + 3

    def intermediate_cells(self) -> int:
        return 8


@dataclasses.dataclass(frozen=True)
class Add(PimInstruction):
    attr_a: str = ""
    attr_b: str = ""
    n_bits: int = 0

    def cycles(self) -> int:
        return 18 * self.n_bits + 1

    def intermediate_cells(self) -> int:
        return 6


@dataclasses.dataclass(frozen=True)
class Multiply(PimInstruction):
    attr_a: str = ""
    attr_b: str = ""            # empty => immediate multiply
    imm: Optional[int] = None
    n_bits: int = 0             # n: in-memory operand length
    m_bits: int = 0             # m: second operand / immediate length

    def cycles(self) -> int:
        n, m = self.n_bits, self.m_bits
        return 24 * n * m - 19 * n + 2 * m - 1

    def intermediate_cells(self) -> int:
        return 6


@dataclasses.dataclass(frozen=True)
class Subtract(PimInstruction):
    """a - b via two's complement add (not in Table 4; charged as
    NOT(b) + Add + increment-carry ≈ BitwiseNot + Addition)."""
    attr_a: str = ""
    attr_b: str = ""
    n_bits: int = 0

    def cycles(self) -> int:
        return 2 * self.n_bits + (18 * self.n_bits + 1)

    def intermediate_cells(self) -> int:
        return 6


# --------------------------------------------------------------------------
# Reduction + column-transform (Table 4 bottom; Figs. 6-7)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ReduceSum(PimInstruction):
    attr: str = ""
    mask: str = ""              # mask register ANDed in beforehand (§4.2)
    n_bits: int = 0

    def cycles(self) -> int:
        return 2254 * self.n_bits + 3006

    def intermediate_cells(self) -> int:
        return self.n_bits + 15

    def row_cycles(self) -> int:
        # Binary-tree reduce: log2(1024)=10 move steps of ~n-bit row-wise
        # bit-by-bit copies dominate (paper §6.1: "mostly row-wise ops").
        # Calibrated split: moves ≈ (2254-254)/2254 of the per-bit cost.
        return 2000 * self.n_bits + 2800

    def row_write_ops(self) -> float:
        # Row-wise move cycles spread over the tree: ~1% land on any one
        # row (the §6.4 endurance model's reduce amortization).
        return self.col_cycles() + self.row_cycles() / 100.0


@dataclasses.dataclass(frozen=True)
class ReduceMinMax(PimInstruction):
    attr: str = ""
    mask: str = ""
    n_bits: int = 0
    is_max: bool = False

    def cycles(self) -> int:
        return 2306 * self.n_bits + 200

    def intermediate_cells(self) -> int:
        return self.n_bits + 7

    def row_cycles(self) -> int:
        return 2000 * self.n_bits + 100

    def row_write_ops(self) -> float:
        return self.col_cycles() + self.row_cycles() / 100.0


@dataclasses.dataclass(frozen=True)
class Materialize(PimInstruction):
    """Read the mask-selected records of ``attrs`` back as integer values
    (the inverse of ``bitslice.pack``): compact selected records and
    re-orient their bit-sliced planes into row-major column values.

    PIMDB stores records row-major inside each crossbar, so selection
    readout is one column-transform of the *mask* (to locate selected
    rows densely, Fig. 6) followed by row-wise reads of the matching
    records — the reads themselves are off-chip traffic, not crossbar
    cycles. ``n_bits`` records the readout width (total planes across
    ``attrs``): bytes-per-selected-record for traffic accounting, which
    ``cost_report`` does not yet charge (it models the paper's original
    filter/aggregate readout only).
    """
    attrs: Tuple[str, ...] = ()
    mask: str = ""
    n_bits: int = 0

    def cycles(self) -> int:
        return 2050                     # the mask column-transform

    def intermediate_cells(self) -> int:
        return 1

    def row_cycles(self) -> int:
        return 1024

    def row_write_ops(self) -> float:
        # The transform's writes land on one row per cycle across all
        # 1024 crossbar rows (§6.4 amortizes it the same way).
        return self.cycles() / 1024.0


@dataclasses.dataclass(frozen=True)
class ColumnTransform(PimInstruction):
    """Re-orient a result-bit column into packed rows for efficient
    readout (Fig. 6). Fixed cost for a 1024x512 crossbar."""
    mask: str = ""

    def cycles(self) -> int:
        return 2050

    def intermediate_cells(self) -> int:
        return 1

    def row_cycles(self) -> int:
        # 2 NOTs per bit; second NOT is the row-wise placement (Fig. 6c).
        return 1024

    def row_write_ops(self) -> float:
        return self.cycles() / 1024.0


# --------------------------------------------------------------------------
# DML write kinds (paper §6.4 endurance evaluation: the write side).
# Unlike the compute kinds above — whose writes land on *intermediate*
# cells — these persistently program data cells, so they are the write
# pressure the endurance model exists for. Row ids are *relation-local
# record indices*; each maps to one crossbar row (1024 records per
# crossbar, record-major), so distinct rows spread writes and repeated
# rows concentrate them — exactly what wear-leveling manipulates.
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PlaneWrite(PimInstruction):
    """Program ``n_bits`` cells of each listed row of attribute ``dest``
    (``dest`` is a relation attribute, or ``"__valid__"`` with
    ``n_bits=1`` to set valid bits on insert). ``values`` carries the
    encoded integer written per row — trace metadata for the oracle and
    the eager engine, not a stored bit-plane (the controller streams it
    in from the request, Algorithm 1 style)."""
    rows: Tuple[int, ...] = ()
    values: Tuple[int, ...] = ()
    n_bits: int = 0

    def cycles(self) -> int:
        # SET phase + RESET phase per touched row (bipolar ReRAM write).
        return 2 * len(self.rows)

    def intermediate_cells(self) -> int:
        return 0

    def row_cycles(self) -> int:
        return self.cycles()            # row-at-a-time: all row-wise

    def row_write_ops(self) -> float:
        # Every listed row takes one n_bits-cell write burst; rows are
        # distinct record slots, so the busiest row sees n_bits writes.
        return float(self.n_bits) if self.rows else 0.0

    def cells_written(self) -> int:
        return len(self.rows) * self.n_bits


@dataclasses.dataclass(frozen=True)
class ValidClear(PimInstruction):
    """Clear the valid bit of each listed row (DELETE). One cell per
    row: the cheapest possible mutation, which is why deletes are
    valid-plane clears rather than eager re-packs."""
    rows: Tuple[int, ...] = ()

    def cycles(self) -> int:
        return len(self.rows)

    def intermediate_cells(self) -> int:
        return 0

    def row_cycles(self) -> int:
        return self.cycles()

    def row_write_ops(self) -> float:
        return 1.0 if self.rows else 0.0

    def cells_written(self) -> int:
        return len(self.rows)


# Stateful-logic cycle time (Table 3): 30 ns.
STATEFUL_CYCLE_NS = 30.0
