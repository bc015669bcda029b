"""Bit-plane (bit-sliced) storage layout — the TPU analogue of PIMDB crossbars.

PIMDB stores each record in a crossbar row; bulk-bitwise ops run on one
*column* (one bit position of one attribute) across all 1024 rows at once.
The TPU-native analogue keeps, for every bit position ``b`` of every
attribute, a packed ``uint32`` bitvector over records ("bit-plane"): one
VPU op on an (8, 128) vreg of uint32 then touches 32 768 records — the same
vertical, bulk-bitwise execution style, mapped onto vector lanes instead of
crossbar rows.

Layout contract (mirrors the paper's Fig. 3 address-mapping contract):

  record r, attribute a, bit b  ->  planes[a][b, r // 32] bit (r % 32)

Records are padded up to a multiple of ``TILE_RECORDS`` so each tile is a
whole number of (8, 128) uint32 vregs; the pad region is masked off by the
relation's ``valid`` plane (the paper's added *valid attribute*, §5.1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np

WORD_BITS = 32
# One tile = 1024 uint32 words = 8*128 lanes = 32_768 records. A paper
# crossbar holds 1024 records (rows); one tile therefore stands in for 32
# crossbars operating in lock-step under one PIM controller.
TILE_WORDS = 1024
TILE_RECORDS = TILE_WORDS * WORD_BITS
# Paper crossbar geometry (Table 3) — used by the cost/endurance model.
CROSSBAR_ROWS = 1024
CROSSBAR_COLS = 512


def _as_u64(values: np.ndarray) -> np.ndarray:
    v = np.asarray(values)
    if v.dtype.kind == "b":
        v = v.astype(np.uint64)
    elif v.dtype.kind in "iu":
        if (np.asarray(v) < 0).any():
            raise ValueError("bit-sliced attributes must be non-negative; "
                             "encode sign/offset first (leading-zero suppression)")
        v = v.astype(np.uint64)
    else:
        raise TypeError(f"unsupported dtype for bit-slicing: {v.dtype}")
    return v


def min_bits(values: np.ndarray) -> int:
    """Width after leading-zero suppression (paper §5.1 compression)."""
    v = _as_u64(values)
    m = int(v.max()) if v.size else 0
    return max(1, m.bit_length())


def pad_words(n_records: int) -> int:
    """Number of uint32 words per plane for ``n_records`` (tile padded)."""
    tiles = max(1, -(-n_records // TILE_RECORDS))
    return tiles * TILE_WORDS


def pack_bits(values: np.ndarray, n_bits: int, n_words: int | None = None) -> np.ndarray:
    """Pack ``values`` into an (n_bits, n_words) uint32 bit-plane array.

    Bit ``b`` of record ``r`` lands in word ``r // 32`` bit ``r % 32``
    of plane ``b`` (LSB-first within a word).
    """
    v = _as_u64(values).ravel()
    n = v.shape[0]
    if n_words is None:
        n_words = pad_words(n)
    out = np.zeros((n_bits, n_words), dtype=np.uint32)
    if n == 0:
        return out
    idx = np.arange(n, dtype=np.int64)
    word = idx // WORD_BITS
    shift = (idx % WORD_BITS).astype(np.uint32)
    for b in range(n_bits):
        bits = ((v >> np.uint64(b)) & np.uint64(1)).astype(np.uint32)
        np.add.at(out[b], word, bits << shift)  # slots are disjoint: add == or
    return out


def _plane_bytes(planes: np.ndarray, n_records: int) -> np.ndarray:
    """The little-endian bytes of the words that hold ``n_records``.

    ``planes``: (n_bits, W) words of any 32-bit integer dtype (the port's
    int32 planes read back as their ``uint32`` view) -> (n_bits, 4 * w)
    uint8 with ``w = ceil(n_records / 32)``; words past ``w`` (reserved
    capacity) are not read.
    """
    planes = np.asarray(planes)
    n_used = -(-n_records // WORD_BITS)
    if n_used > planes.shape[1]:
        raise IndexError(f"{n_records} records need {n_used} words, "
                         f"planes hold {planes.shape[1]}")
    words = np.ascontiguousarray(planes[:, :n_used]).astype("<u4", copy=False)
    return words.view(np.uint8)


def unpack_bits(planes: np.ndarray, n_records: int) -> np.ndarray:
    """Inverse of :func:`pack_bits` -> uint64 values of shape (n_records,).

    Word-parallel: each plane's bytes are unpacked LSB-first (record
    ``r`` is bit ``r % 8`` of byte ``r // 8``, the same slot as bit
    ``r % 32`` of word ``r // 32`` in little-endian order) and OR-ed in
    at the plane's bit position.
    """
    data = _plane_bytes(planes, n_records)
    out = np.zeros(n_records, dtype=np.uint64)
    for b in range(data.shape[0]):
        bits = np.unpackbits(data[b], count=n_records, bitorder="little")
        out |= bits.astype(np.uint64) << np.uint64(b)
    return out


def unpack_rows(planes: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Read back the values of selected record slots only.

    ``planes``: (n_bits, W) uint32; ``rows``: record slot indices ->
    (len(rows),) uint64.  The row-targeted readback the integrity layer
    uses for verify-after-write: touching just the written slots instead
    of a full :func:`unpack_bits` over the capacity.
    """
    planes = np.asarray(planes, dtype=np.uint32)
    rows = np.asarray(rows, dtype=np.int64)
    word = rows // WORD_BITS
    shift = (rows % WORD_BITS).astype(np.uint32)
    out = np.zeros(rows.shape[0], dtype=np.uint64)
    for b in range(planes.shape[0]):
        bits = (planes[b, word] >> shift) & np.uint32(1)
        out |= bits.astype(np.uint64) << np.uint64(b)
    return out


def pack_mask(mask: np.ndarray, n_words: int | None = None) -> np.ndarray:
    """Pack a boolean record mask into a (n_words,) uint32 bitvector.

    This is the layout the paper's *column-transform* (Fig. 6) produces:
    one result bit per record, re-oriented for dense readout.
    """
    return pack_bits(np.asarray(mask).astype(np.uint8), 1, n_words)[0]


def unpack_mask(words: np.ndarray, n_records: int) -> np.ndarray:
    """Inverse of :func:`pack_mask` -> bool mask of shape (n_records,)."""
    data = _plane_bytes(np.asarray(words)[None, :], n_records)[0]
    return np.unpackbits(data, count=n_records, bitorder="little").view(bool)


@dataclasses.dataclass(frozen=True)
class AttributeLayout:
    """Placement of one attribute: bit-plane rows [0, n_bits)."""
    name: str
    n_bits: int
    encoding: str = "raw"  # raw | dict | lzs (leading-zero suppression)


@dataclasses.dataclass
class RelationLayout:
    """Software-controlled placement contract (paper §3.1, Fig. 3).

    Maps (record, attribute, bit) -> (tile, word-in-tile, bit-in-word) and
    records per-crossbar-equivalent geometry for the cost model. The paper
    exposes physical address bit-fields so software controls operand
    locality; here the contract is the packed array layout itself.
    """
    attributes: Dict[str, AttributeLayout]
    n_records: int
    # Reserved append-segment capacity in words (tile multiples), set by
    # the DML layer. ``n_records`` stays the *logical* record count; the
    # plane arrays span the capacity and the gap is masked by the valid
    # plane, so within-capacity inserts never change ``n_words`` — the
    # compiled-executable cache signature stays warm until a segment
    # growth deliberately changes it.
    capacity_words: int | None = None

    @property
    def n_words(self) -> int:
        base = pad_words(self.n_records)
        if self.capacity_words is None:
            return base
        return max(base, self.capacity_words)

    @property
    def capacity_records(self) -> int:
        return self.n_words * WORD_BITS

    @property
    def n_tiles(self) -> int:
        return self.n_words // TILE_WORDS

    @property
    def row_bits(self) -> int:
        """Occupied crossbar-row bits per record (paper Table 1 col. 4)."""
        return sum(a.n_bits for a in self.attributes.values()) + 1  # +valid

    @property
    def n_crossbars(self) -> int:
        """Paper-equivalent crossbar count (1024 records each)."""
        return max(1, -(-self.n_records // CROSSBAR_ROWS))

    def memory_utilization(self) -> float:
        """Fraction of crossbar row bits holding data (paper Table 1)."""
        return self.row_bits / CROSSBAR_COLS

    def coordinates(self, record: int, attr: str, bit: int):
        a = self.attributes[attr]
        if not (0 <= bit < a.n_bits):
            raise IndexError(f"bit {bit} out of range for {attr}[{a.n_bits}]")
        tile, within = divmod(record, TILE_RECORDS)
        return dict(tile=tile, plane=bit, word=within // WORD_BITS,
                    lane=within % WORD_BITS)


def build_layout(columns: Mapping[str, np.ndarray],
                 encodings: Mapping[str, str] | None = None,
                 widths: Mapping[str, int] | None = None) -> RelationLayout:
    encodings = dict(encodings or {})
    widths = dict(widths or {})
    n_records = None
    attrs: Dict[str, AttributeLayout] = {}
    for name, col in columns.items():
        col = np.asarray(col)
        if n_records is None:
            n_records = col.shape[0]
        elif col.shape[0] != n_records:
            raise ValueError(f"column {name} length mismatch")
        n_bits = widths.get(name, min_bits(col))
        attrs[name] = AttributeLayout(name, n_bits, encodings.get(name, "lzs"))
    return RelationLayout(attrs, n_records or 0)
