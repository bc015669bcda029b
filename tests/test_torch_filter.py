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

Numpy models of ``csrc/bitwise_filter.cu``: ``cmp_imm``'s branch-free,
chunked MSB-first chain equals the Pallas ``cmp_imm`` in interpret mode
(every immediate at widths 1-8, random, negative and too-wide immediates
across chunk boundaries); ``range_mask``'s lanes (chunks of 8, 16 and 32
planes from the top down, zero-padded, one or two words a thread, each
chunk folded against both immediates) equal the Pallas ``range_mask``
at widths 1-33, empty, full and too-wide ranges; ``filter_sum``'s
persistent blocks, int32 block counts and self-zeroing int64 state equal
the reference's popcounts and leave the state zero. ``filter_sum``
refuses, before any build, a stack whose int32 block counts could reach
2**31.
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


# --------------------------------------------------------------------------
# Numpy models of the CUDA kernels
# --------------------------------------------------------------------------
def _chunk(n_bits):
    """Planes a kernel instance loads at once (``BY_WIDTH``): all of a
    stack up to 32, wider stacks 16 at a time."""
    return 8 if n_bits <= 8 else 16 if n_bits <= 16 or n_bits > 32 else 32


def _imm_bits(imm, n_bits):
    """``load_imm``: the launcher's 64-bit immediate words, bits at or
    above ``n_bits`` zero."""
    words = [int(x) for x in kbf.imm_words(imm, n_bits)]
    words += [0] * (kbf.MAX_BITS // 64 - len(words))
    if n_bits % 64:
        words[n_bits // 64] &= (1 << (n_bits % 64)) - 1
    return words


def _cmp_chain_model(planes, imm, nb=None):
    """``cmp_chain``: chunks of ``nb`` (``cmp_imm``: ``_chunk(n_bits)``)
    planes from the top chunk down, the top one padded with zero planes past ``n_bits``; each
    chunk is loaded whole, then folded top plane first with the
    branch-free step m = 0 - bit, lt |= eq & ~v & m, eq &= ~(v ^ m). The
    chunk's immediate bits are ``imm_chunk``: one 64-bit word shifted."""
    n_bits, w = planes.shape
    nb = nb or _chunk(n_bits)
    words = _imm_bits(imm, n_bits)
    zero = np.zeros(w, np.uint32)
    lt, eq = np.zeros(w, np.uint32), np.full(w, 0xFFFFFFFF, np.uint32)
    for b0 in range((n_bits - 1) // nb * nb, -1, -nb):
        v = [planes[b0 + i] if b0 + i < n_bits else zero for i in range(nb)]
        bits = (words[b0 // 64] >> (b0 % 64)) & 0xFFFFFFFF
        for i in range(nb - 1, -1, -1):
            m = np.uint32(-((bits >> i) & 1) & 0xFFFFFFFF)
            lt |= eq & ~v[i] & m
            eq &= ~(v[i] ^ m)
    return lt, eq


def _raw(rng, bits, w):
    """Random words with all-ones, bit-31 and zero words (as many of the
    three as ``w`` holds)."""
    raw = rng.integers(0, 1 << 32, (bits, w), dtype=np.uint64) \
        .astype(np.uint32)
    raw[:, :1] = 0xFFFFFFFF
    raw[:, 1:2] |= np.uint32(1 << 31)
    raw[:, 2:3] = 0
    return raw


@pytest.mark.parametrize("bits", range(1, 9))
def test_cmp_chain_model_matches_pallas_every_immediate(bits):
    """Every immediate of a 1-8 bit stack (1,024 words: every value
    occurs), against the Pallas kernel in interpret mode and the plain
    version."""
    jnp, rbf, _ = _jax()
    raw = _raw(np.random.default_rng(bits), bits, 1024)
    x = jnp.asarray(raw)
    for imm in range(1 << bits):
        got = _cmp_chain_model(raw, imm)
        want = rbf.cmp_imm(x, imm, interpret=True)
        for g, w_, p in zip(got, want, kbf.cmp_imm_torch(_i32(raw), imm)):
            np.testing.assert_array_equal(g, np.asarray(w_))
            np.testing.assert_array_equal(g, _u32(p))


@pytest.mark.parametrize("bits", [17, 21, 33, 64])
def test_cmp_chain_model_matches_pallas_across_chunks(bits):
    """Stacks whose chain crosses chunk boundaries (17 and 21 in one
    padded 32-plane chunk; 33 and 64 in 16-plane chunks): random
    immediates, one with only bit ``bits - 1``, negative ones and ones at
    or above 2**bits (their bits at or above the width are ignored)."""
    jnp, rbf, _ = _jax()
    rng = np.random.default_rng(bits)
    raw = _raw(rng, bits, 1024)
    x = jnp.asarray(raw)
    rand = [int(rng.integers(0, 1 << bits, dtype=np.uint64))
            for _ in range(3)]
    imms = rand + [1 << (bits - 1), (1 << bits) - 1, -1, -rand[0],
                   rand[1] | (1 << bits) | (1 << (bits + 5))]
    for imm in imms:
        got = _cmp_chain_model(raw, imm)
        want = rbf.cmp_imm(x, imm, interpret=True)
        for g, w_, p in zip(got, want, kbf.cmp_imm_torch(_i32(raw), imm)):
            np.testing.assert_array_equal(g, np.asarray(w_))
            np.testing.assert_array_equal(g, _u32(p))


def _range_mask_model(planes, lo, hi, nb, k, grid=3):
    """``range_mask_kernel<nb, k>`` over ``grid`` blocks of 256 threads,
    grid-striding over groups of ``k`` words: each thread loads every
    chunk of ``nb`` planes from the top chunk down (zero planes past
    ``n_bits``) and folds it with the branch-free step twice, against
    ``imm_chunk(lo)`` and ``imm_chunk(hi)``, then writes ``~lt(lo) &
    lt(hi)`` for its group. Every word must be written exactly once."""
    threads = 256
    n_bits, w = planes.shape
    assert w % k == 0
    lo_w, hi_w = _imm_bits(lo, n_bits), _imm_bits(hi, n_bits)
    out = np.zeros(w, np.uint32)
    writes = np.zeros(w, np.int64)
    for blk in range(grid):
        for g0 in range(blk * threads, w // k, grid * threads):
            words = (np.arange(g0, min(g0 + threads, w // k))[:, None] * k
                     + np.arange(k)).reshape(-1)
            zero = np.zeros(words.size, np.uint32)
            lt = [zero.copy(), zero.copy()]
            eq = [~zero, ~zero]
            for b0 in range((n_bits - 1) // nb * nb, -1, -nb):
                v = [planes[b0 + i, words] if b0 + i < n_bits else zero
                     for i in range(nb)]
                for c, imm_w in enumerate((lo_w, hi_w)):
                    bits = (imm_w[b0 // 64] >> (b0 % 64)) & 0xFFFFFFFF
                    for i in range(nb - 1, -1, -1):
                        m = np.uint32(-((bits >> i) & 1) & 0xFFFFFFFF)
                        lt[c] |= eq[c] & ~v[i] & m
                        eq[c] &= ~(v[i] ^ m)
            out[words] = ~lt[0] & lt[1]
            writes[words] += 1
    assert (writes == 1).all()
    return out


RANGE_BITS = [1, 8, 9, 16, 17, 21, 32, 33]


def _range_cases(n_bits, rng):
    """``(lo, hi)`` pairs: a random range; ``lo >= hi`` (empty); ``lo = 0``
    with ``hi = 1 << n_bits`` (its bits all at or above the width, so it
    reads as 0: empty); immediates with bits above ``n_bits``; then ``lo =
    hi``, a full-width ``hi`` and a negative ``lo``."""
    top = (1 << n_bits) - 1
    lo = int(rng.integers(0, top + 1, dtype=np.uint64))
    hi = int(rng.integers(lo, top + 1, dtype=np.uint64))
    return [(lo, hi), (hi, lo), (0, 1 << n_bits),
            (lo | (1 << n_bits), hi | (5 << (n_bits + 2))),
            (lo, lo), (0, top), (-3, top)]


@pytest.mark.parametrize("n_bits", RANGE_BITS)
def test_range_mask_model_matches_pallas_every_lane_shape(n_bits):
    """The model of every instance (``nb`` 8, 16, 32; ``k`` 1 over an odd
    W, 2 over the even W below it) equals the Pallas ``range_mask`` in
    interpret mode (the first four cases of :func:`_range_cases`; each
    immediate pair is a trace of its own) and the plain version (all of
    them) bit for bit."""
    jnp, rbf, _ = _jax()
    rng = np.random.default_rng(100 + n_bits)
    w = 1031                                  # odd: one word a thread
    raw = _raw(rng, n_bits, w)
    x = jnp.asarray(raw)
    for j, (lo, hi) in enumerate(_range_cases(n_bits, rng)):
        want = _u32(kbf.range_mask_torch(_i32(raw), lo, hi))
        if j < 4:
            np.testing.assert_array_equal(
                want, np.asarray(rbf.range_mask(x, lo, hi, interpret=True)))
        for nb in (8, 16, 32):
            np.testing.assert_array_equal(
                _range_mask_model(raw, lo, hi, nb, 1), want, (nb, lo, hi))
            np.testing.assert_array_equal(
                _range_mask_model(raw[:, :w - 1], lo, hi, nb, 2),
                want[:w - 1], (nb, lo, hi))


def _filter_sum_model(fp, ap, valid, lo, hi, grid, k, state):
    """``filter_sum_kernel`` over ``grid`` persistent blocks of 256
    threads, ``k`` words a thread, the filter planes in chunks of 8 (a
    stack of up to 8) or 16: every lane takes every grid-stride
    step (a lane past the end reads the last group and selects nothing);
    each block counts in int32 and adds its counts into ``state`` (a done
    counter, then one int64 sum per column), the blocks finishing in a
    random order; the last one moves the totals out and zeroes the
    state. Returns the ``na + 1`` totals."""
    threads = 256
    na, w = ap.shape
    n_groups = w // k
    nb = 8 if fp.shape[0] <= 8 else 16
    lt_lo, _ = _cmp_chain_model(fp, lo, nb)
    lt_hi, _ = _cmp_chain_model(fp, hi, nb)
    mask = ~lt_lo & lt_hi & valid
    popc = np.vectorize(lambda x: bin(int(x)).count("1"), otypes=[np.int64])
    out = None
    for blk in np.random.default_rng(grid).permutation(grid):
        acc = np.zeros(na + 1, np.int32)
        for g0 in range(blk * threads, n_groups, grid * threads):
            g = np.arange(g0, g0 + threads)
            inside = g < n_groups
            g = np.where(inside, g, n_groups - 1)
            words = (g[:, None] * k + np.arange(k)).reshape(-1)
            m = np.where(np.repeat(inside, k), mask[words], 0)
            m = m.astype(np.uint32)
            acc[0] += popc(m).sum()
            for b in range(na):
                acc[1 + b] += popc(m & ap[b, words]).sum()
        state[1:na + 2] += acc
        state[0] += 1
        if state[0] == grid:
            out = state[1:na + 2].copy()
            state[:] = 0
    return out


@pytest.mark.parametrize("w,grid,k", [(1, 1, 1), (257, 2, 1), (4096, 3, 2),
                                      (5003, 2, 1), (20_000, 5, 2)])
def test_filter_sum_model_matches_reference_and_leaves_state_zero(w, grid,
                                                                  k):
    """The model of one launch per call equals the reference's popcounts
    at word counts below, at and beyond one wave of the grid (``grid`` x
    256 threads x ``k`` words), and consecutive launches find the state
    zeroed, with ``na`` 0, 1 and 24."""
    jnp = pytest.importorskip("jax").numpy
    from repro.kernels import ref
    rng = np.random.default_rng(w)
    state = np.zeros(kbf.MAX_BITS + 2, np.int64)
    for nf, na in ((12, 24), (5, 0), (33, 1)):
        fp, ap = _raw(rng, nf, w), _raw(rng, na, w)
        valid = _raw(rng, 1, w)[0]
        lo = int(rng.integers(0, 1 << nf))
        hi = int(rng.integers(lo, 1 << nf))
        got = _filter_sum_model(fp, ap, valid, lo, hi, grid, k, state)
        want = np.asarray(ref.filter_agg_popcounts(
            jnp.asarray(fp), jnp.asarray(ap), lo, hi, jnp.asarray(valid)))
        np.testing.assert_array_equal(got, want)
        assert not state.any()


@pytest.mark.parametrize("na", [0, 1])
def test_filter_sum_count_alone_and_one_plane(na):
    """``na = 0`` (COUNT alone) and ``na = 1`` against the reference's
    ``filter_agg_popcounts``, with a filter wider than one chunk."""
    jnp = pytest.importorskip("jax").numpy
    from repro.kernels import ref
    rng = np.random.default_rng(na)
    w = 3001
    fp, ap = _raw(rng, 40, w), _raw(rng, na, w)
    valid = _raw(rng, 1, w)[0]
    for lo, hi in ((0, 1 << 40), (5, (1 << 39) + 7), (9, 3)):
        cnt, pcs = kfa.filter_sum(_i32(fp), _i32(ap), _i32(valid), lo, hi)
        assert cnt.dtype == pcs.dtype == torch.int64 and pcs.shape == (na,)
        want = np.asarray(ref.filter_agg_popcounts(
            jnp.asarray(fp), jnp.asarray(ap), lo, hi, jnp.asarray(valid)))
        np.testing.assert_array_equal(np.r_[int(cnt), pcs.numpy()], want)


def test_filter_sum_refuses_int32_overflow_before_build(monkeypatch,
                                                        tmp_path):
    """A block counts in int32, up to 32 records a word: a stack of
    ``MAX_WORDS`` words could reach 2**31, so the wrapper raises before it
    builds anything (nvcc is absent here) and counts no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import build as kbuild
    monkeypatch.setattr(kbuild, "_libs", {})
    monkeypatch.setattr(kbuild, "_BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    assert kfa.MAX_WORDS == 1 << 26
    before = kfa.launches
    with FakeTensorMode():
        for w in (kfa.MAX_WORDS, kfa.MAX_WORDS + 5):
            planes = torch.empty((3, w), dtype=torch.int32, device="cuda")
            agg = torch.empty((1, w), dtype=torch.int32, device="cuda")
            valid = torch.empty(w, dtype=torch.int32, device="cuda")
            with pytest.raises(ValueError, match=(
                    rf"filter_sum counts each block's records in int32: {w} "
                    r"words could reach 2\*\*31 in one block \(at most "
                    r"67108863 words\)")):
                kfa.filter_sum(planes, agg, valid, 1, 5)
    assert kfa.launches == before
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


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")


def _misaligned(x):
    """A contiguous CUDA copy of ``x`` whose data pointer is 4-byte but not
    8-byte aligned (one word into a larger buffer)."""
    buf = torch.empty(x.numel() + 1, dtype=torch.int32, device="cuda")
    view = buf[1:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 8 == 4 and view.is_contiguous()
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 4, 8, 9, 16, 17, 21, 32, 33, 64, 1024])
def test_cmp_imm_matches_plain_on_card_any_width_and_word_count(bits):
    """cmp_imm at every instance's edges (8, 16, 32 planes; wider stacks
    16 at a time, up to 1,024) and path d's widths (4-21), at W % 4 = 0,
    1, 2, 3 and on a view that is 4- but not 8-byte aligned, with
    immediates 0, all-ones, only the top bit, negative and too wide."""
    _needs_card()
    rng = np.random.default_rng(bits)
    base = 4_003 if bits > 64 else 100_003
    raw = _raw(rng, bits, base)
    top = (1 << bits) - 1
    imms = (0, top, 1 << (bits - 1), top ^ 0x55, -7,
            (1 << bits) | (1 << (bits + 9)) | 6)
    stacks = [_i32(raw[:, :base - k]) for k in range(4)]
    for x in stacks:
        for xc in (x.cuda(), _misaligned(x)):
            for imm in imms:
                for got, want in zip(kbf.cmp_imm(xc, imm),
                                     kbf.cmp_imm_torch(x, imm)):
                    assert torch.equal(got.cpu(), want), (x.shape, imm)
    torch.cuda.synchronize()


# (nf, na) pairs that reach both filter chunk sizes (8, 16) and stacks
# read in several chunks.
FILTER_SUM_CARD = [(12, 0), (5, 1), (12, 24), (17, 33), (40, 64),
                   (33, 1024)]
# Word counts: one word, a block's edges, lineitem at SF 1, and more than
# one wave of the persistent grid (132 SMs x 8 blocks x 256 threads x 2).
FILTER_SUM_WORDS = [1, 255, 256, 257, 188_416, 1_100_000]


def _filter_sum_case(nf, na, w, gen):
    def rand(*shape):
        return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                             device="cuda", generator=gen)
    return rand(nf, w), rand(na, w), rand(w)


@pytest.mark.cuda
@pytest.mark.parametrize("nf,na", FILTER_SUM_CARD)
def test_filter_sum_matches_plain_on_card(nf, na):
    """filter_sum == filter_sum_torch on the card at every word count of
    FILTER_SUM_WORDS, on a misaligned valid plane too, for ranges that
    select some, none and all records."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(nf * 1000 + na)
    for w in FILTER_SUM_WORDS:
        if na * w > 200_000_000:            # 800 MB of aggregate planes
            w = 188_416
        fp, ap, valid = _filter_sum_case(nf, na, w, gen)
        for v in (valid, _misaligned(valid)):
            for lo, hi in ((3, (1 << nf) - 9), (9, 3), (0, 1 << nf)):
                got = kfa.filter_sum(fp, ap, v, lo, hi)
                want = kfa.filter_sum_torch(fp, ap, v, lo, hi)
                for g, w_ in zip(got, want):
                    assert torch.equal(g, w_), (nf, na, w, lo, hi)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_filter_sum_from_threads_and_streams():
    """Four host threads calling filter_sum at once on one stream, then
    calls alternating between two streams: every result equals plain (the
    state is per stream, and the kernel returns it to zeros)."""
    import threading
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    fp, ap, valid = _filter_sum_case(12, 24, 188_416, gen)
    want = [t.cpu() for t in kfa.filter_sum_torch(fp, ap, valid, 5, 3000)]
    results, errors = [], []

    def run():
        try:
            for _ in range(25):
                results.append(kfa.filter_sum(fp, ap, valid, 5, 3000))
        except Exception as e:            # reported below
            errors.append(e)
    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for k in range(20):
        with torch.cuda.stream(streams[k % 2]):
            results.append(kfa.filter_sum(fp, ap, valid, 5, 3000))
    torch.cuda.synchronize()
    assert not errors, errors
    assert len(results) == 120
    for cnt, pcs in results:
        assert torch.equal(cnt.cpu(), want[0])
        assert torch.equal(pcs.cpu(), want[1])


@pytest.mark.cuda
def test_filter_sum_is_one_kernel_launch():
    """A warm filter_sum call (its library built, its stream's state
    allocated) enqueues exactly one CUDA kernel: no zero fill of partials,
    no torch reduction. Counted as the kernel nodes of the call captured
    into a CUDA graph (``kernels.graph_count``), which needs no CUPTI: a
    failed capture raises with the method named, it never counts 0."""
    from repro_torch.kernels import graph_count
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(11)
    fp, ap, valid = _filter_sum_case(12, 24, 188_416, gen)
    before = kfa.launches
    kernels, nodes = graph_count.kernels_enqueued(
        lambda: kfa.filter_sum(fp, ap, valid, 5, 3000))
    assert (kernels, nodes) == (1, 1)
    assert kfa.launches == before + 2      # the warm call and the captured


@pytest.mark.cuda
@pytest.mark.parametrize("n_bits,w", [(b, 100_003) for b in RANGE_BITS]
                         + [(12, 188_416)])
def test_range_mask_matches_plain_on_card(n_bits, w):
    """range_mask == range_mask_torch on the card at the model's cases, at
    W and W - 1 (one and two words a thread) and on a view that is 4- but
    not 8-byte aligned (one word a thread); (12, 188,416) is path e's
    ``l_shipdate`` shape at SF 1."""
    _needs_card()
    rng = np.random.default_rng(n_bits * 7 + w)
    raw = _raw(rng, n_bits, w)
    for x in (_i32(raw), _i32(raw[:, :w - 1])):
        for xc in (x.cuda(), _misaligned(x)):
            for lo, hi in _range_cases(n_bits, rng):
                assert torch.equal(kbf.range_mask(xc, lo, hi).cpu(),
                                   kbf.range_mask_torch(x, lo, hi)), \
                    (x.shape, xc.data_ptr() % 8, lo, hi)
    torch.cuda.synchronize()
