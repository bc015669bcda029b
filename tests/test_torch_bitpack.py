"""Port: the column transform — ``kernels.bitpack`` and its entry points
``kernels.ops.pack_mask``/``unpack_mask``.

The plain versions equal the reference's ``kernels/ref.py`` and its Pallas
kernels in interpret mode, bit for bit: random 0/1 data, all-ones words,
bit 31, any uint32 input to the pack (the reference sums ``v << j`` mod
2^32), and the round trip. The wrappers never fall back; on a card the
kernels equal the plain versions (``cuda`` marker).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bitpack as kbp
from repro_torch.kernels import ops as tops

W = 2048                # words: four tiles of the reference's 512


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
