"""Port: the column transform — ``kernels.bitpack`` and its entry points
``kernels.ops.pack_mask``/``unpack_mask``.

The plain versions equal the reference's ``kernels/ref.py`` and its Pallas
kernels in interpret mode, bit for bit: random 0/1 data, all-ones words,
bit 31, any uint32 input to the pack (the reference sums ``v << j`` mod
2^32), and the round trip. A numpy model of the kernels' lanes, tiles
and alignment paths equals the Pallas kernels too. The
wrappers never fall back; on a card the kernels equal the plain versions
(``cuda`` marker), at ragged word counts and from a misaligned copy, in
one kernel a call.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bitpack as kbp
from repro_torch.kernels import ops as tops

W = 2048                # words: four tiles of the reference's 512
# csrc/bitpack.cu: threads a block; 8 lanes a row, 16 bytes each; rows a
# thread, so a block's tile is 128 rows.
THREADS = 256
ROWS_PER_STEP = THREADS // 8
ROWS = 4
TILE = ROWS_PER_STEP * ROWS
# Word counts for the model: one word, short of a warp's 4 rows, one warp
# step, one past it, short of a 32-row block step, and a multiple of none.
MODEL_W = (1, 3, 4, 5, 31, 2048 + 3)
# Word offsets of bitpack's input in a 16-byte aligned buffer: 16-byte
# vectors at 0; 4- and 8-byte aligned starts take the scalar path.
MODEL_OFFSETS = (0, 1, 2)
CARD_W = (1, 3, 4, 5, 100_003, 188_416, 250_001)


def _words(seed, n=W):
    """Random words with the edge cases in front: 0, all ones, bit 31
    alone, bit 0 alone."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    edge = np.array([0, 0xFFFFFFFF, 1 << 31, 1], np.uint32)[:n]
    w[:len(edge)] = edge
    return w


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1])
def test_unpack_matches_reference(seed):
    jax = pytest.importorskip("jax")
    from repro.kernels import bitpack as rbp
    from repro.kernels import ref
    words = _words(seed)
    got = _u32(tops.unpack_mask(_i32(words)))
    assert got.shape == (W, 32)
    jw = jax.numpy.asarray(words)
    np.testing.assert_array_equal(got, np.asarray(ref.bitunpack(jw)))
    np.testing.assert_array_equal(
        got, np.asarray(rbp.bitunpack(jw, interpret=True)))
    assert got[1].all() and got[2, 31] == 1 and got[2, :31].sum() == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_matches_reference(seed):
    """0/1 input packs to the words it came from; any other uint32 input
    packs to the reference's wrapped sum."""
    jax = pytest.importorskip("jax")
    from repro.kernels import bitpack as rbp
    from repro.kernels import ref
    words = _words(seed)
    bits = ((words[:, None] >> np.arange(32, dtype=np.uint32)) & 1)
    rng = np.random.default_rng(seed + 10)
    wide = rng.integers(0, 1 << 32, (W, 32), dtype=np.uint64) \
        .astype(np.uint32)
    wide[0] = 0xFFFFFFFF
    for x in (bits.astype(np.uint32), wide):
        got = _u32(tops.pack_mask(_i32(x)))
        jx = jax.numpy.asarray(x)
        np.testing.assert_array_equal(got, np.asarray(ref.bitpack(jx)))
        np.testing.assert_array_equal(
            got, np.asarray(rbp.bitpack(jx, interpret=True)))
    np.testing.assert_array_equal(_u32(kbp.bitpack_torch(_i32(bits))), words)


def test_round_trip():
    words = _i32(_words(5, n=3001))
    assert torch.equal(kbp.bitpack(kbp.bitunpack(words)), words)
    ones = torch.full((7,), -1, dtype=torch.int32)
    assert bool((kbp.bitunpack(ones) == 1).all())
    assert torch.equal(kbp.bitpack(torch.ones((7, 32), dtype=torch.int32)),
                       ones)


@pytest.mark.parametrize("name", ["bitpack", "bitunpack"])
def test_wrapper_raises_without_kernel(monkeypatch, tmp_path, name):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import build as kbuild
    monkeypatch.setattr(kbuild, "_libs", {})
    monkeypatch.setattr(kbuild, "_BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    shape = (W, 32) if name == "bitpack" else (W,)
    with FakeTensorMode():
        x = torch.empty(shape, dtype=torch.int32, device="cuda")
    counter = f"{name}_launches"
    before = getattr(kbp, counter)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        getattr(kbp, name)(x)
    assert getattr(kbp, counter) == before


def _blocks(n):
    """The kernels' grid, one tile a block: for every block, the row of
    each (u, thread) and each thread's vector q (columns 4q .. 4q+3)."""
    t = np.arange(THREADS)
    for base in range(0, -(-n // TILE) * TILE, TILE):
        yield base + np.arange(ROWS)[:, None] * ROWS_PER_STEP + (t >> 3), \
            t & 7


def _lane_words(off, rows, q, live):
    """The 4 buffer indices each lane reads or writes; with ``off`` words
    into a 16-byte aligned buffer the kernel takes vectors only where the
    start is 16-byte aligned, and then every lane's vector is."""
    first = off + rows * 32 + 4 * q
    if off * 4 % 16 == 0:
        assert (first[live] % 4 == 0).all()
    return first[..., None] + np.arange(4)


def _pack_model(flat, off, n):
    """bitpack_kernel on the (n, 32) rows ``off`` words into ``flat``:
    each lane sums its 4 shifted terms, 3 xor-shuffles inside its group of
    8 lanes make the word, lane q = 0 of a live row stores it, once."""
    out = np.zeros(n, np.uint32)
    stores = np.zeros(n, np.int64)
    lanes = np.arange(THREADS)
    for rows, q in _blocks(n):
        live = rows < n
        idx = _lane_words(off, rows, q, live)
        v = np.where(live[..., None], flat[np.where(live[..., None], idx, 0)],
                     np.uint32(0))
        j = (4 * q[:, None] + np.arange(4)).astype(np.uint32)
        s = (v << j).sum(axis=-1, dtype=np.uint32)
        for m in (1, 2, 4):
            s = s + s[:, lanes ^ m]
        st = live & (q == 0)
        out[rows[st]] = s[st]
        np.add.at(stores, rows[st], 1)
    assert (stores == 1).all()
    return out


def _unpack_model(words):
    """bitunpack_kernel writing a fresh 16-byte aligned buffer: each lane
    loads its row's word and stores bits 4q .. 4q+3 as one vector; every
    element is written once."""
    n = len(words)
    flat = np.full(n * 32, 7, np.uint32)
    stores = np.zeros(flat.size, np.int64)
    for rows, q in _blocks(n):
        live = rows < n
        x = np.where(live, words[np.minimum(rows, n - 1)], np.uint32(0)) \
            >> (4 * q).astype(np.uint32)
        idx = _lane_words(0, rows, q, live)[live]
        flat[idx] = (x[live][:, None] >> np.arange(4, dtype=np.uint32)) & 1
        np.add.at(stores, idx, 1)
    assert (stores == 1).all()
    return flat.reshape(n, 32)


@pytest.mark.parametrize("w", MODEL_W)
def test_pack_model_matches_pallas(w):
    """0/1 and any-uint32 rows through the model at every alignment,
    against the Pallas bitpack in interpret mode."""
    jax = pytest.importorskip("jax")
    from repro.kernels import bitpack as rbp
    words = _words(w, n=w)
    wide = np.random.default_rng(w + 10).integers(
        0, 1 << 32, (w, 32), dtype=np.uint64).astype(np.uint32)
    wide[0] = 0xFFFFFFFF
    for x in ((words[:, None] >> np.arange(32, dtype=np.uint32)) & 1, wide):
        want = np.asarray(rbp.bitpack(jax.numpy.asarray(x), interpret=True))
        np.testing.assert_array_equal(_u32(kbp.bitpack_torch(_i32(x))), want)
        for off in MODEL_OFFSETS:
            flat = np.concatenate([np.zeros(off, np.uint32), x.ravel()])
            np.testing.assert_array_equal(_pack_model(flat, off, w), want,
                                          err_msg=f"offset {off}")


@pytest.mark.parametrize("w", MODEL_W)
def test_unpack_model_matches_pallas(w):
    """Random and edge words through the model against the Pallas
    bitunpack in interpret mode."""
    jax = pytest.importorskip("jax")
    from repro.kernels import bitpack as rbp
    words = _words(w + 20, n=w)
    want = np.asarray(rbp.bitunpack(jax.numpy.asarray(words),
                                    interpret=True))
    np.testing.assert_array_equal(_u32(kbp.bitunpack_torch(_i32(words))),
                                  want)
    np.testing.assert_array_equal(_unpack_model(words), want)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")


def _misaligned(x):
    """A contiguous CUDA copy of ``x`` whose data pointer is 4-byte but not
    8- or 16-byte aligned (one word into a larger buffer)."""
    buf = torch.empty(x.numel() + 1, dtype=torch.int32, device="cuda")
    view = buf[1:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 8 == 4 and view.is_contiguous()
    return view


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    for n in (3001, 1, 188_416):
        words = _i32(_words(n, n=n))
        bits = kbp.bitunpack_torch(words)
        before = (kbp.bitpack_launches, kbp.bitunpack_launches)
        got_bits = tops.unpack_mask(words.cuda())
        got_words = tops.pack_mask(bits.cuda())
        torch.cuda.synchronize()
        assert (kbp.bitpack_launches, kbp.bitunpack_launches) == \
            (before[0] + 1, before[1] + 1)
        assert torch.equal(got_bits.cpu(), bits)
        assert torch.equal(got_words.cpu(), words)
        wide = _i32(np.random.default_rng(n).integers(
            0, 1 << 32, (n, 32), dtype=np.uint64).astype(np.uint32))
        assert torch.equal(kbp.bitpack(wide.cuda()).cpu(),
                           kbp.bitpack_torch(wide))


@pytest.mark.cuda
@pytest.mark.parametrize("w", CARD_W)
def test_kernels_match_plain_on_card_tails_and_misaligned(w):
    """Both kernels against plain at word counts a multiple of no tile,
    from 16-byte aligned tensors and from 4-byte aligned copies (bitpack's
    scalar path; bitunpack reads its words with scalar loads either way):
    random, all-ones and bit-31 words, and any-uint32 pack input."""
    _needs_card()
    wide = np.random.default_rng(w).integers(
        0, 1 << 32, (w, 32), dtype=np.uint64).astype(np.uint32)
    wide[0] = 0xFFFFFFFF
    wide = _i32(wide)
    for words in (_i32(_words(w, n=w)), torch.full((w,), -1,
                                                   dtype=torch.int32),
                  torch.full((w,), -(1 << 31), dtype=torch.int32)):
        bits = kbp.bitunpack_torch(words)
        for place in (torch.Tensor.cuda, _misaligned):
            before = (kbp.bitpack_launches, kbp.bitunpack_launches)
            got_bits = kbp.bitunpack(place(words))
            got_words = kbp.bitpack(place(bits))
            got_wide = kbp.bitpack(place(wide))
            torch.cuda.synchronize()
            assert (kbp.bitpack_launches, kbp.bitunpack_launches) == \
                (before[0] + 2, before[1] + 1)
            assert torch.equal(got_bits.cpu(), bits)
            assert torch.equal(got_words.cpu(), words)
            assert torch.equal(got_wide.cpu(), kbp.bitpack_torch(wide))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bitpack", "bitunpack"])
def test_one_warm_call_is_one_kernel_launch(name):
    """A warm call of either wrapper enqueues exactly one CUDA kernel,
    counted as the kernel nodes of the call captured into a CUDA graph
    (``kernels.graph_count``; no CUPTI)."""
    from repro_torch.kernels import graph_count
    _needs_card()
    words = _i32(_words(3, n=188_416))
    x = (words if name == "bitunpack" else kbp.bitunpack_torch(words)).cuda()
    fn = getattr(kbp, name)
    before = getattr(kbp, f"{name}_launches")
    assert graph_count.kernels_enqueued(lambda: fn(x)) == (1, 1)
    assert getattr(kbp, f"{name}_launches") == before + 2
