"""Port: the bit-serial predicate kernels (``kernels.bitwise_filter``),
the fused filter + aggregate kernel (``kernels.filter_aggregate``) and
their entry points in ``kernels.ops``.

The plain versions equal the reference's Pallas kernels run in interpret
mode and its ``kernels/ref.py`` oracles, bit for bit (tolerance 0), over
the sweeps of ``tests/test_kernels.py`` (n in {100, 4096, 33000}, widths
1, 7, 17 and 33) plus all-ones words, bit 31 set and immediates with
bits at or above the width (ignored, as the Pallas kernels ignore them).
The wrappers never fall back: a CUDA tensor without a kernel raises. On a
card the kernels equal the plain versions (``cuda`` marker).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bitslice as tb
from repro_torch.kernels import bitwise_filter as kbf
from repro_torch.kernels import filter_aggregate as kfa
from repro_torch.kernels import ops as tops

N_SWEEP = [100, 4096, 33000]
BITS_SWEEP = [1, 7, 17, 33]


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                            .view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


def _planes(seed, n, bits):
    """Values and their packed planes (W a multiple of the reference's
    tile), plus a raw stack: random words with all-ones words and bit 31
    set in every plane's first words."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << bits, n, dtype=np.uint64)
    w = tb.pad_words(n)
    planes = tb.pack_bits(vals, bits, w)
    raw = rng.integers(0, 1 << 32, (bits, w), dtype=np.uint64) \
        .astype(np.uint32)
    raw[:, 0] = 0xFFFFFFFF
    raw[:, 1] |= np.uint32(1 << 31)
    raw[:, 2] = 0
    return vals, planes, raw


def _edge_imm(vals, bits):
    """A present value with bits at and above the width set, and bit 31
    where the width has it."""
    return int(vals[0]) | (1 << bits) | (1 << (bits + 7)) \
        | ((1 << 31) if bits > 31 else 0)


def _imms(vals, bits, rng):
    """Immediates: a present value, 0, 2^n - 1, a random one, and
    :func:`_edge_imm`."""
    return [int(vals[0]), 0, (1 << bits) - 1,
            int(rng.integers(0, 1 << bits, dtype=np.uint64)),
            _edge_imm(vals, bits)]


def _jax():
    jax = pytest.importorskip("jax")
    from repro.kernels import bitwise_filter as rbf
    from repro.kernels import ref
    return jax.numpy, rbf, ref


@pytest.mark.parametrize("n", N_SWEEP)
@pytest.mark.parametrize("bits", BITS_SWEEP)
def test_eq_imm_matches_reference(n, bits):
    jnp, rbf, ref = _jax()
    vals, planes, raw = _planes(n * 131 + bits, n, bits)
    rng = np.random.default_rng(n + bits)
    imm = _edge_imm(vals, bits)
    np.testing.assert_array_equal(
        _u32(tops.predicate_eq_imm(_i32(raw), imm)),
        np.asarray(rbf.eq_imm(jnp.asarray(raw), imm, interpret=True)))
    for imm in _imms(vals, bits, rng):
        for stack in (planes, raw):
            np.testing.assert_array_equal(
                _u32(tops.predicate_eq_imm(_i32(stack), imm)),
                np.asarray(ref.predicate_eq_imm(jnp.asarray(stack), imm)))
        want = vals == (imm & ((1 << bits) - 1))
        np.testing.assert_array_equal(
            tb.unpack_mask(_u32(kbf.eq_imm_torch(_i32(planes), imm)), n),
            want)


@pytest.mark.parametrize("n", N_SWEEP)
@pytest.mark.parametrize("bits", BITS_SWEEP)
def test_cmp_imm_matches_reference(n, bits):
    jnp, rbf, ref = _jax()
    vals, planes, raw = _planes(n * 7 + bits, n, bits)
    rng = np.random.default_rng(n * 3 + bits)
    imm = _edge_imm(vals, bits)
    for got, want in zip(tops.predicate_cmp_imm(_i32(raw), imm),
                         rbf.cmp_imm(jnp.asarray(raw), imm, interpret=True)):
        np.testing.assert_array_equal(_u32(got), np.asarray(want))
    for imm in _imms(vals, bits, rng):
        for stack in (planes, raw):
            for got, want in zip(
                    tops.predicate_cmp_imm(_i32(stack), imm),
                    ref.predicate_cmp_imm(jnp.asarray(stack), imm)):
                np.testing.assert_array_equal(_u32(got), np.asarray(want))
        low = imm & ((1 << bits) - 1)
        lt, eq = kbf.cmp_imm_torch(_i32(planes), imm)
        np.testing.assert_array_equal(tb.unpack_mask(_u32(lt), n),
                                      vals < low)
        np.testing.assert_array_equal(tb.unpack_mask(_u32(eq), n),
                                      vals == low)


@pytest.mark.parametrize("n", N_SWEEP)
@pytest.mark.parametrize("bits", BITS_SWEEP)
def test_range_mask_matches_reference(n, bits):
    jnp, rbf, ref = _jax()
    vals, planes, raw = _planes(n + bits, n, bits)
    rng = np.random.default_rng(n + 5 * bits)
    lo = int(rng.integers(0, 1 << bits))
    hi = int(rng.integers(lo, 1 << bits))
    a, b = lo | (1 << bits), hi | (3 << (bits + 1))
    np.testing.assert_array_equal(
        _u32(tops.predicate_range(_i32(raw), a, b)),
        np.asarray(rbf.range_mask(jnp.asarray(raw), a, b, interpret=True)))
    for a, b in ((lo, hi), (0, (1 << bits) - 1), (hi, lo), (a, b)):
        for stack in (planes, raw):
            np.testing.assert_array_equal(
                _u32(tops.predicate_range(_i32(stack), a, b)),
                np.asarray(ref.predicate_range(jnp.asarray(stack), a, b)))
    np.testing.assert_array_equal(
        tb.unpack_mask(_u32(kbf.range_mask_torch(_i32(planes), lo, hi)), n),
        (vals >= lo) & (vals < hi))


@pytest.mark.parametrize("n", [3000, 40000])
@pytest.mark.parametrize("fbits,abits", [(9, 6), (17, 12), (24, 20),
                                         (9, 0)])
def test_filter_sum_matches_reference(n, fbits, abits):
    """COUNT and per-bit popcounts equal the Pallas kernel's and the jnp
    oracle's; ``weight_popcounts`` gives numpy's exact count and sum.
    ``abits = 0`` is COUNT alone."""
    jnp = pytest.importorskip("jax").numpy
    from repro.kernels import filter_aggregate as rfa
    from repro.kernels import ref
    rng = np.random.default_rng(n + fbits)
    fv, fp, _ = _planes(n + fbits, n, fbits)
    w = fp.shape[1]
    av = rng.integers(0, 1 << abits, n, dtype=np.uint64)
    ap = tb.pack_bits(av, abits, w).reshape(abits, w)
    sel_valid = rng.random(n) < 0.9              # some records deleted
    valid = tb.pack_mask(sel_valid, w)
    lo = int(rng.integers(0, 1 << fbits))
    hi = int(rng.integers(lo, 1 << fbits))
    cnt, pcs = tops.fused_filter_sum(_i32(fp), _i32(ap), _i32(valid), lo, hi)
    assert cnt.dtype == pcs.dtype == torch.int64 and pcs.shape == (abits,)
    want = np.asarray(ref.filter_agg_popcounts(
        jnp.asarray(fp), jnp.asarray(ap), lo, hi, jnp.asarray(valid)))
    np.testing.assert_array_equal(np.r_[int(cnt), pcs.numpy()], want)
    if abits:
        rcnt, rpcs = rfa.filter_sum(jnp.asarray(fp), jnp.asarray(ap),
                                    jnp.asarray(valid), lo, hi,
                                    interpret=True)
        assert int(cnt) == int(rcnt)
        np.testing.assert_array_equal(pcs.numpy(), np.asarray(rpcs))
    sel = (fv >= lo) & (fv < hi) & sel_valid
    assert kfa.weight_popcounts(cnt, pcs) == (int(sel.sum()),
                                              int(av[sel].sum()))
    assert kfa.weight_popcounts(cnt, pcs) == rfa.weight_popcounts(
        int(cnt), pcs.numpy())


def test_immediate_words_any_width():
    """The kernels' immediate is the low n_bits bits, 64 to a word, never
    cut to one machine word; a negative one is its two's complement."""
    assert list(kbf.imm_words(5, 3)) == [5]
    assert list(kbf.imm_words(0xFF, 3)) == [7]
    big = (1 << 100) | (1 << 64) | 3
    assert list(kbf.imm_words(big, 101)) == [3, (1 << 36) | 1]
    assert list(kbf.imm_words(big, 65)) == [3, 1]
    assert list(kbf.imm_words(-1, 70)) == [(1 << 64) - 1, (1 << 6) - 1]


@pytest.mark.parametrize("name", ["eq_imm", "cmp_imm", "range_mask",
                                  "filter_sum"])
def test_wrapper_raises_without_kernel(monkeypatch, tmp_path, name):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import build as kbuild
    monkeypatch.setattr(kbuild, "_libs", {})
    monkeypatch.setattr(kbuild, "_BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with FakeTensorMode():
        planes = torch.empty((5, 2048), dtype=torch.int32, device="cuda")
        valid = torch.empty(2048, dtype=torch.int32, device="cuda")
    calls = {"eq_imm": lambda: kbf.eq_imm(planes, 3),
             "cmp_imm": lambda: kbf.cmp_imm(planes, 3),
             "range_mask": lambda: kbf.range_mask(planes, 1, 9),
             "filter_sum": lambda: kfa.filter_sum(planes, planes, valid, 1,
                                                  9)}
    counter = (kfa, "launches") if name == "filter_sum" \
        else (kbf, f"{name}_launches")
    before = getattr(*counter)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        calls[name]()
    assert getattr(*counter) == before


@pytest.mark.parametrize("name", ["eq_imm", "cmp_imm", "range_mask",
                                  "filter_sum"])
def test_empty_stack_launches_and_counts_nothing(monkeypatch, tmp_path,
                                                 name):
    """A CUDA stack of no words has nothing to launch: the wrapper returns
    empty results without building the library (nvcc is absent here) and
    leaves its launch count alone — the count moves only where a kernel
    is launched."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import build as kbuild
    monkeypatch.setattr(kbuild, "_libs", {})
    monkeypatch.setattr(kbuild, "_BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    counter = (kfa, "launches") if name == "filter_sum" \
        else (kbf, f"{name}_launches")
    before = getattr(*counter)
    with FakeTensorMode():
        planes = torch.empty((5, 0), dtype=torch.int32, device="cuda")
        agg = torch.empty((2, 0), dtype=torch.int32, device="cuda")
        valid = torch.empty(0, dtype=torch.int32, device="cuda")
        calls = {"eq_imm": lambda: (kbf.eq_imm(planes, 3),),
                 "cmp_imm": lambda: kbf.cmp_imm(planes, 3),
                 "range_mask": lambda: (kbf.range_mask(planes, 1, 9),),
                 "filter_sum": lambda: kfa.filter_sum(planes, agg, valid,
                                                      1, 9)}
        outs = calls[name]()
    want = [(), (2,)] if name == "filter_sum" else [(0,)] * len(outs)
    assert [tuple(o.shape) for o in outs] == want
    assert all(o.device.type == "cuda" for o in outs)
    assert getattr(*counter) == before
    assert kbuild._libs == {}


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    for n, bits in ((100, 1), (33000, 33), (1_000_003, 64)):
        vals, planes, raw = _planes(n, n, bits)
        rng = np.random.default_rng(n)
        for stack in (planes, raw[:, :raw.shape[1] - 5]):
            x = _i32(stack)
            xc = x.cuda()
            for imm in _imms(vals, bits, rng):
                assert torch.equal(kbf.eq_imm(xc, imm).cpu(),
                                   kbf.eq_imm_torch(x, imm))
                for got, want in zip(kbf.cmp_imm(xc, imm),
                                     kbf.cmp_imm_torch(x, imm)):
                    assert torch.equal(got.cpu(), want)
                assert torch.equal(kbf.range_mask(xc, imm >> 1, imm).cpu(),
                                   kbf.range_mask_torch(x, imm >> 1, imm))
            for na in (0, 12, 64):
                agg = _i32(rng.integers(0, 1 << 32, (na, x.shape[1]),
                                        dtype=np.uint64).astype(np.uint32))
                valid = x[0]
                got = kfa.filter_sum(xc, agg.cuda(), valid.cuda(), 3,
                                     (1 << bits) - 2)
                want = kfa.filter_sum_torch(x, agg, valid, 3,
                                            (1 << bits) - 2)
                for g, w in zip(got, want):
                    assert torch.equal(g.cpu(), w)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 8, 9, 16, 17, 32, 33, 64, 1024])
def test_eq_imm_matches_plain_on_card_any_width_and_word_count(bits):
    """eq_imm at every width bucket's edges (8, 16, 32; wider stacks read
    16 planes at a time, up to 1,024) and at W % 4 = 0, 1, 2, 3, in small
    stacks and in stacks of lineitem's word count at SF 1 (more words than
    one wave of blocks), with all-ones words, bit 31 and immediates with
    bits at or above the width."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    rng = np.random.default_rng(bits)
    base = 4_003 if bits > 64 else 100_003
    for n in (base, base - 1, base - 2, base - 3, 188_416, 188_415):
        if bits > 64 and n > base:
            continue
        vals = rng.integers(0, 1 << min(bits, 63), n * 32, dtype=np.uint64)
        raw = rng.integers(0, 1 << 32, (bits, n), dtype=np.uint64) \
            .astype(np.uint32)
        raw[:, 0] = 0xFFFFFFFF
        raw[:, 1] |= np.uint32(1 << 31)
        x = _i32(raw)
        xc = x.cuda()
        top = (1 << bits) - 1
        for imm in (0, top, top ^ 0x55, int(vals[0]), (1 << 31) | 5,
                    (1 << bits) | (1 << (bits + 9)) | 6):
            assert torch.equal(kbf.eq_imm(xc, imm).cpu(),
                               kbf.eq_imm_torch(x, imm)), (n, imm)
    torch.cuda.synchronize()
