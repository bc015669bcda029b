"""Port: bit-plane packing and carrying packed state across.

``repro_torch.core.bitslice`` is a copy of the reference module; these
tests hold it to ``repro.core.bitslice`` bit for bit (including all-ones
words and bit 31, the int32 sign bit the port's planes carry), and check
that planes packed by the reference reach the port's device tensors
unchanged through ``relation_from_numpy``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bitslice as tb
from repro_torch.core import engine as te

SEED = 123


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    from repro.core import bitslice, engine
    return bitslice, engine


def _columns(rng, n):
    return {"k": rng.integers(0, 1 << 12, n),
            "v": rng.integers(0, 1 << 31, n),       # bit 30 of a 31-bit attr
            "w": np.full(n, (1 << 33) - 1),         # 33 bits: all-ones words
            "b": rng.integers(0, 2, n).astype(bool)}


@pytest.mark.parametrize("n", [1, 31, 32, 33, 5000, 40_000])
def test_pack_unpack_roundtrip_matches_reference(ref, n):
    rbs, _ = ref
    rng = np.random.default_rng(SEED)
    for name, col in _columns(rng, n).items():
        nb = tb.min_bits(col)
        assert nb == rbs.min_bits(col), name
        planes = tb.pack_bits(col, nb)
        np.testing.assert_array_equal(planes, rbs.pack_bits(col, nb))
        np.testing.assert_array_equal(tb.unpack_bits(planes, n),
                                      col.astype(np.uint64))
    sel = rng.random(n) < 0.5
    np.testing.assert_array_equal(tb.pack_mask(sel), rbs.pack_mask(sel))
    np.testing.assert_array_equal(tb.unpack_mask(tb.pack_mask(sel), n), sel)


def test_all_ones_words_and_bit31_survive_the_int32_view():
    """A full word (all 32 records set) is -1 as int32 and comes back as
    0xFFFFFFFF; bit 31 (record 31 of a word) is the sign bit."""
    n = 64
    col = np.zeros(n, np.int64)
    col[:32] = 1                                   # word 0: all ones
    col[63] = 1                                    # word 1: bit 31 only
    planes = tb.pack_bits(col, 1)
    assert planes[0, 0] == 0xFFFFFFFF and planes[0, 1] == 0x80000000
    t = te.to_planes(planes, "cpu")
    assert t.dtype == torch.int32
    assert t[0, 0].item() == -1 and t[0, 1].item() == -(1 << 31)
    np.testing.assert_array_equal(te.to_words(t), planes)
    np.testing.assert_array_equal(tb.unpack_bits(te.to_words(t), n), col)


def _words_as_read_back(rng, n_bits, n_words):
    """Random planes as the port reads them back: the ``uint32`` view of
    int32 device words (``engine.to_words``), with an all-ones word and a
    bit-31-only word wherever the planes have room."""
    words = rng.integers(0, 1 << 32, (n_bits, n_words), dtype=np.uint64)
    words = words.astype(np.uint32)
    words[:, 0] = 0xFFFFFFFF
    if n_words > 1:
        words[:, 1] = 0x80000000
    t = torch.from_numpy(words.view(np.int32).copy())
    return te.to_words(t)


@pytest.mark.parametrize("n_bits", [1, 12, 31, 33])
@pytest.mark.parametrize("n", [0, 1, 7, 8, 31, 32, 33, 5000, 40_000,
                               32 * 2 * tb.TILE_WORDS])
def test_unpack_matches_reference(ref, n, n_bits):
    """``unpack_mask`` and ``unpack_bits`` equal the reference bit for bit
    on exactly filled words (``32 * W`` records), on the tile-padded words
    ``pack_bits`` makes, and on words with a reserved capacity tile past
    them (a DML relation's), ignoring every bit past ``n``."""
    rbs, _ = ref
    rng = np.random.default_rng(SEED + n + n_bits)
    full = n == 32 * 2 * tb.TILE_WORDS
    for n_words in ([n // 32] if full else
                    [tb.pad_words(n), tb.pad_words(n) + tb.TILE_WORDS]):
        planes = _words_as_read_back(rng, n_bits, n_words)
        assert planes.dtype == np.uint32 and planes[0, 0] == 0xFFFFFFFF
        got = tb.unpack_bits(planes, n)
        want = rbs.unpack_bits(planes, n)
        assert got.dtype == want.dtype == np.uint64
        assert got.shape == want.shape == (n,)
        np.testing.assert_array_equal(got, want)
        mask = tb.unpack_mask(planes[0], n)
        want_mask = rbs.unpack_mask(planes[0], n)
        assert mask.dtype == want_mask.dtype == np.bool_
        assert mask.shape == want_mask.shape == (n,)
        np.testing.assert_array_equal(mask, want_mask)
    if n >= 64:
        assert mask[:32].all() and not mask[32:63].any() and mask[63]


def test_layout_matches_reference(ref):
    rbs, _ = ref
    rng = np.random.default_rng(SEED)
    cols = _columns(rng, 70_000)
    mine, theirs = tb.build_layout(cols), rbs.build_layout(cols)
    assert mine.n_words == theirs.n_words == 3 * tb.TILE_WORDS
    assert mine.row_bits == theirs.row_bits
    assert {a: x.n_bits for a, x in mine.attributes.items()} == \
        {a: x.n_bits for a, x in theirs.attributes.items()}


def test_relation_from_numpy_carries_reference_planes(ref):
    """Reference-packed planes (numpy uint32) become the port's int32
    device planes bit for bit, equal to the port's own packing."""
    _, reng = ref
    rng = np.random.default_rng(SEED)
    cols = _columns(rng, 5000)
    rrel = reng.PimRelation.from_columns("t", cols)
    carried = te.relation_from_numpy(
        "t", tb.build_layout(cols),
        {a: np.asarray(p) for a, p in rrel.planes.items()},
        np.asarray(rrel.valid), rrel.n_records, device="cpu")
    own = te.PimRelation.from_columns("t", cols, device="cpu")
    assert carried.n_records == own.n_records == 5000
    for a in cols:
        assert carried.planes[a].dtype == torch.int32
        assert torch.equal(carried.planes[a], own.planes[a]), a
        np.testing.assert_array_equal(te.to_words(carried.planes[a]),
                                      np.asarray(rrel.planes[a]))
    assert torch.equal(carried.valid, own.valid)
    assert own.bytes_resident() == rrel.bytes_resident()
    assert own.bytes_reserved() == rrel.bytes_reserved()
    assert own.bumped().version == 1 and own.version == 0
