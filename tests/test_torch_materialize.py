"""Port: the materialize kernel module and the ``Materialize`` output of
``compile_program``.

* The plain version (``kernels.materialize.materialize``) equals the
  reference's jnp lowering ``materialize_planes``, its Pallas kernel
  ``materialize_pallas`` in interpret mode and the numpy unpack + gather
  oracle, at widths up to 32 and densities from 0 to 1, at record counts
  that are a multiple of neither 32 nor the kernel's block. Only the
  ``count`` prefix is defined, so the prefix and the count are compared.
* ``compile_program`` with a ``Materialize`` instruction equals the
  reference's ``compile_program`` (mask, count, values), including a
  scan-all mask that must exclude padding, ``"__valid__"`` as the mask
  and an empty selection.
* The program kernel's input rows leave out ``Materialize``-only
  attributes, and the masks ``Materialize`` reads are stored by it.
* Numpy models of the CUDA kernel: its decode (the 32 x 32 bit
  transpose and the sparse per-lane path) equals the plain version and
  the reference; its look-back scan gives every tile its prefix however
  the blocks interleave and leaves its state zero for the next launch.
* The wrapper never falls back; on a card the kernel equals the plain
  version, from several host threads too (``cuda`` marker).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bitslice as tbs
from repro_torch.core import engine as te
from repro_torch.core import program as tprog
from repro_torch.db import compiler as tc
from repro_torch.kernels import materialize as kmat

# (widths of the attributes materialized together, selected fraction)
CASES = [((1,), 0.0), ((7,), 0.001), ((31, 3), 0.5), ((32,), 1.0),
         ((32, 12, 1), 0.3)]
N = 40_001               # 1,251 words: a multiple of neither 32 nor 256


def _case(n, widths, density, seed, n_words=None):
    """Random values of ``widths`` (bit 31 set where the width is 32), a
    selection of ``density``, packed into ``n_words`` words."""
    rng = np.random.default_rng(seed)
    w = n_words or tbs.pad_words(n)
    vals = [rng.integers(0, 1 << b, n, dtype=np.uint64) for b in widths]
    for v, b in zip(vals, widths):
        if b == 32:
            v[::3] |= np.uint64(1 << 31)
    sel = rng.random(n) < density
    planes = [tbs.pack_bits(v, b, w) for v, b in zip(vals, widths)]
    return vals, sel, planes, tbs.pack_mask(sel, w)


def _t(a):
    return te.to_planes(a, "cpu")


def _want(vals, sel):
    """The reference's int32 values of the selected records."""
    return np.stack([v.astype(np.uint32).view(np.int32)[sel] for v in vals])


@pytest.mark.parametrize("widths,density", CASES)
def test_plain_matches_reference_materialize(widths, density):
    jax = pytest.importorskip("jax")
    from repro.kernels import materialize as rmat
    vals, sel, planes, mask = _case(N, widths, density, seed=len(widths))
    got, cnt = kmat.materialize([_t(p) for p in planes], _t(mask))
    assert got.shape == (len(widths), tbs.pad_words(N) * 32)
    assert cnt.dtype == torch.int32 and cnt.shape == (1,)
    n = int(cnt)
    assert n == int(sel.sum())
    np.testing.assert_array_equal(got[:, :n].numpy(), _want(vals, sel))
    assert not got[:, n:].any()                 # the plain tail is zeros
    jp = [jax.numpy.asarray(p) for p in planes]
    jm = jax.numpy.asarray(mask)
    for ref_vals, ref_cnt in (rmat.materialize_planes(jp, jm),
                              rmat.materialize_pallas(jp, jm,
                                                      interpret=True)):
        assert int(np.asarray(ref_cnt)[0]) == n
        np.testing.assert_array_equal(np.asarray(ref_vals)[:, :n],
                                      got[:, :n].numpy())


@pytest.mark.parametrize("n_words", [1, 255, 1251])
def test_standalone_contract(n_words):
    """One stack gives a 1-D row, a list a 2-D block; any word count."""
    n = n_words * 32 - 5
    vals, sel, planes, mask = _case(n, (9, 32), 0.4, seed=n_words,
                                    n_words=n_words)
    one, c1 = kmat.materialize(_t(planes[0]), _t(mask))
    both, c2 = kmat.materialize([_t(p) for p in planes], _t(mask))
    assert one.shape == (n_words * 32,) and both.shape == (2, n_words * 32)
    assert int(c1) == int(c2) == int(sel.sum())
    want = _want(vals, sel)
    np.testing.assert_array_equal(one[:int(c1)].numpy(), want[0])
    np.testing.assert_array_equal(both[:, :int(c2)].numpy(), want)


def test_bits_past_32_add_nothing():
    """As in the reference's XLA lowering, a plane past the 32nd is shifted
    out: only the low 32 bits of a value come back."""
    jax = pytest.importorskip("jax")
    from repro.kernels import materialize as rmat
    vals, sel, planes, mask = _case(5000, (32,), 0.5, seed=3)
    extra = np.concatenate([planes[0], np.full_like(planes[0][:2],
                                                    0xFFFFFFFF)])
    got, cnt = kmat.materialize(_t(extra), _t(mask))
    ref, rcnt = rmat.materialize_planes([jax.numpy.asarray(extra)],
                                        jax.numpy.asarray(mask))
    n = int(cnt)
    assert n == int(np.asarray(rcnt)[0])
    np.testing.assert_array_equal(got[:n].numpy(), _want(vals, sel)[0])
    np.testing.assert_array_equal(np.asarray(ref)[0, :n], got[:n].numpy())


# --------------------------------------------------------------------------
# Materialize through compile_program, against the reference's
# --------------------------------------------------------------------------
def _program(C, rel, kind):
    """One relation program with a Materialize, built by compiler module
    ``C``: ``filter`` (mask k in [500, 3000], read back v and w), ``scan``
    (scan-all mask), ``valid`` (the valid plane itself as the mask) or
    ``empty`` (nothing selected). Returns (program, mask reg, mat reg)."""
    c = C.Compiler(rel)
    if kind == "scan":
        m = c.compile_scan_all()
    elif kind == "valid":
        m = "__valid__"
    else:
        hi = 3000 if kind == "filter" else 200
        m = c.compile_filter(C.And(C.Cmp("ge", C.Col("k"), C.Lit(500)),
                                   C.Cmp("le", C.Col("k"), C.Lit(hi))),
                             with_transform=False)
    return c.program, m, c.compile_materialize(m, ("v", "w"))


@pytest.mark.parametrize("kind,n,backend", [
    ("filter", 40_000, "jnp"), ("filter", 40_000, "pallas"),
    ("filter", tbs.TILE_RECORDS, "jnp"), ("filter", 1000, "pallas"),
    ("scan", 33_000, "pallas"), ("valid", 33_000, "jnp"),
    ("empty", 5000, "pallas")])
def test_program_materialize_matches_reference(kind, n, backend):
    pytest.importorskip("jax")
    from repro.core import engine as reng
    from repro.core import program as rprog
    from repro.db import compiler as rc
    rng = np.random.default_rng(7)
    cols = {"k": rng.integers(0, 1 << 12, n),
            "v": rng.integers(0, 1 << 9, n),
            "w": rng.integers(0, 1 << 5, n)}
    sel = {"filter": (cols["k"] >= 500) & (cols["k"] <= 3000),
           "scan": np.ones(n, bool), "valid": np.ones(n, bool),
           "empty": np.zeros(n, bool)}[kind]
    outputs = {}
    for C, eng_mod, prog_mod, kw in (
            (tc, te, tprog, {"device": "cpu"}),
            (rc, reng, rprog, {})):
        rel = eng_mod.PimRelation.from_columns("t", cols, **kw)
        program, m, mat = _program(C, rel, kind)
        mask_outputs = (m,) if kind in ("filter", "empty") else ()
        extra = {} if prog_mod is tprog else {"backend": backend}
        cp = prog_mod.compile_program(rel, program,
                                      mask_outputs=mask_outputs, **extra)
        res = prog_mod.run_program(cp, rel)
        if mask_outputs:
            np.testing.assert_array_equal(res.mask(m), sel)
        outputs[prog_mod] = (res.materialized_count(mat),
                             res.materialized(mat))
    (cnt, got), (rcnt, ref) = outputs[tprog], outputs[rprog]
    assert cnt == rcnt == int(sel.sum())
    assert list(got) == list(ref) == ["v", "w"]
    for a in ("v", "w"):
        np.testing.assert_array_equal(got[a], cols[a][sel])
        np.testing.assert_array_equal(got[a], np.asarray(ref[a]))


def test_kernel_rows_leave_out_materialize_only_attrs():
    """The program kernel streams only what the filter reads; the mask that
    Materialize reads is one of its STOREs even with no mask output; the
    plane-read counter still counts every source attribute, as the
    reference's does."""
    n = 5000
    rng = np.random.default_rng(1)
    cols = {"k": rng.integers(0, 1 << 12, n),
            "v": rng.integers(0, 1 << 9, n),
            "w": rng.integers(0, 1 << 5, n)}
    rel = te.PimRelation.from_columns("t", cols, device="cpu")
    program, m, mat = _program(tc, rel, "filter")
    cp = tprog.compile_program(rel, program, mask_outputs=())
    assert cp.analysis.source_attrs == ("k", "v", "w")
    assert cp.kernel_attrs == ("k",)
    assert cp.kernel_masks == (m,) and cp.tape.n_masks == 1
    assert cp.mat_attrs == {mat: ("v", "w")}
    assert cp.tape.n_rows == rel.width_of("k") + 1
    assert tuple(tprog.stack_sources(cp, rel).shape) == \
        (cp.tape.n_rows, rel.layout.n_words)
    assert cp.source_plane_reads == sum(rel.width_of(a) for a in cols)
    program, _, _ = _program(tc, rel, "scan")
    cp = tprog.compile_program(rel, program)
    assert cp.kernel_attrs == () and cp.tape.n_rows == 1
    program, _, _ = _program(tc, rel, "valid")
    cp = tprog.compile_program(rel, program)
    assert cp.kernel_masks == () and cp.tape.n_masks == 0


# --------------------------------------------------------------------------
# A numpy model of the CUDA kernel's decode
# --------------------------------------------------------------------------
U32 = np.uint32


def _bucket(nb):
    """The kernel's width bucket: planes it decodes (at most 32)."""
    return 8 if nb <= 8 else 16 if nb <= 16 else 32


def _transpose32(x):
    """``csrc/materialize.cu::transpose32`` on ``(32, n)`` uint32 rows, one
    column per word: the five stages of masked swaps, row k against row
    k + j under mask m. On entry row b bit l is bit b of record l; on
    return row l bit b is."""
    x = x.copy()
    j, m = 16, U32(0x0000FFFF)
    while j:
        for k in range(32):
            if k & j:
                continue
            t = ((x[k] >> U32(j)) ^ x[k + j]) & m
            x[k + j] ^= t
            x[k] ^= t << U32(j)
        j >>= 1
        m ^= m << U32(j)
    return x


def _decode_model(planes, mask, sparse_max):
    """The kernel's decode of one attribute, word by word as a warp does it:
    the bucket's planes are loaded (none past 32, none where the mask word
    is 0); a warp (32 consecutive words) whose densest word has more than
    ``sparse_max`` selected lanes transposes every word and writes its
    selected lanes in rank order into a 32 x 33 staging tile at
    ``r + (r >> 5)``, then copies the tile out; any other warp decodes
    each selected lane from the planes. Returns the selected values (int32)
    in record order."""
    nb, n_words = planes.shape
    nbk = _bucket(nb)
    x = np.zeros((32, n_words), U32)
    x[:min(nb, nbk)] = planes[:min(nb, nbk)]
    x[:, mask == 0] = 0
    out = []
    for w0 in range(0, n_words, 32):
        words = range(w0, min(w0 + 32, n_words))
        pcs = [bin(int(mask[w])).count("1") for w in words]
        if max(pcs) > sparse_max:
            stage = np.full(32 * 33, -1, np.int64)
            r = 0
            for w in words:
                v = _transpose32(x[:, w:w + 1])[:, 0]
                for lane in range(32):
                    if (int(mask[w]) >> lane) & 1:
                        assert stage[r + (r >> 5)] == -1   # no collision
                        stage[r + (r >> 5)] = v[lane]
                        r += 1
            out += [int(stage[i + (i >> 5)]) for i in range(r)]
        else:
            for w in words:
                for lane in range(32):
                    if (int(mask[w]) >> lane) & 1:
                        out.append(sum(((int(x[b, w]) >> lane) & 1) << b
                                       for b in range(nbk)))
    return np.array(out, np.int64).astype(np.uint32).view(np.int32)


def _model_cases(width, n_words):
    """(name, planes, mask) at ``width``: random planes with all-ones
    words and bit 31 set in every plane, under a half-dense mask, an
    empty one, a single selected record, an all-ones one, and one whose
    warps mix full, sparse and empty words."""
    rng = np.random.default_rng(width)
    planes = rng.integers(0, 1 << 32, (width, n_words), dtype=np.uint64) \
        .astype(U32)
    planes[:, 3] = 0xFFFFFFFF
    planes[:, 5] |= U32(1 << 31)
    half = (rng.random((n_words, 32)) < 0.5)
    half = (half.astype(np.uint64) << np.arange(32, dtype=np.uint64)) \
        .sum(1).astype(U32)
    one = np.zeros(n_words, U32)
    one[n_words // 3] = U32(1 << 31)
    mixed = half.copy()
    mixed[::3] = 0
    mixed[1::7] = 0xFFFFFFFF
    mixed[2::5] &= U32(0x00010001)
    return [("half", planes, half), ("empty", planes, np.zeros_like(one)),
            ("one", planes, one),
            ("all-ones", planes, np.full(n_words, 0xFFFFFFFF, U32)),
            ("mixed", planes, mixed)]


def test_transpose32_is_a_transpose():
    """The five-stage swap network is the 32 x 32 bit transpose."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 32, (32, 7), dtype=np.uint64).astype(U32)
    x[:, 0] = 0xFFFFFFFF
    x[:, 1] = U32(1 << 31)
    bits = (x[:, None, :] >> np.arange(32, dtype=U32)[None, :, None]) & 1
    y = _transpose32(x)
    want = (bits.transpose(1, 0, 2).astype(np.uint64)
            << np.arange(32, dtype=np.uint64)[None, :, None]).sum(1)
    np.testing.assert_array_equal(y, want.astype(U32))


@pytest.mark.parametrize("width", [1, 7, 31, 32, 33])
@pytest.mark.parametrize("sparse_max", [0, kmat.SPARSE_MAX, 32])
def test_decode_model_matches_plain_and_reference(width, sparse_max):
    """The kernel's decode (dense transpose or sparse per-lane, by the
    threshold; 0 transposes every warp that selects anything, 32 decodes
    every selected lane alone) equals
    ``materialize_torch`` and the reference's ``materialize_planes`` bit
    for bit, at a word count that is a multiple of no block (67 words:
    two full warps and a ragged one)."""
    jax = pytest.importorskip("jax")
    from repro.kernels import materialize as rmat
    for name, planes, mask in _model_cases(width, 67):
        got = _decode_model(planes, mask, sparse_max)
        want, cnt = kmat.materialize_torch([_t(planes)], _t(mask))
        n = int(cnt)
        assert len(got) == n, name
        np.testing.assert_array_equal(got, want[0, :n].numpy(), name)
        ref, rcnt = rmat.materialize_planes([jax.numpy.asarray(planes)],
                                            jax.numpy.asarray(mask))
        assert int(np.asarray(rcnt)[0]) == n
        np.testing.assert_array_equal(np.asarray(ref)[0, :n], got, name)


# --------------------------------------------------------------------------
# A model of the look-back kernel's scan and its state
# --------------------------------------------------------------------------
AGG, INCL = 1, 2


def _look_back_block(state, counts):
    """One block of ``csrc/materialize.cu::materialize_lookback``, one
    step per memory access that another block can observe; ``state`` is
    ``{"ticket", "done", "status"}``, a status word ``(flag, value)``,
    ``(0, 0)`` unpublished. Returns ``(tile, exclusive prefix)``."""
    n_tiles = len(counts)
    tile = state["ticket"]
    state["ticket"] += 1
    assert tile < n_tiles                   # the kernel traps
    yield
    total = counts[tile]
    state["status"][tile] = (AGG if tile else INCL, total)
    yield
    excl, j = 0, tile - 1
    while j >= 0:
        flag, value = state["status"][j]
        if not flag:                        # polled again later
            yield
            continue
        excl += value
        if flag == INCL:
            break
        j -= 1
        yield
    if tile:
        state["status"][tile] = (INCL, excl + total)
    yield
    last = state["done"] == n_tiles - 1
    state["done"] += 1
    if last:                                # the state back to zeros
        state["status"][:n_tiles] = [(0, 0)] * n_tiles
        state["ticket"] = state["done"] = 0
    return tile, excl


def _run_launch(state, counts, rng, in_flight):
    """One launch: blocks start in a random order, at most ``in_flight``
    running at once, and run interleaved step by step in a random order.
    Returns ``{tile: exclusive prefix}``."""
    waiting = list(range(len(counts)))
    rng.shuffle(waiting)
    running, out = [], {}
    while waiting or running:
        while waiting and len(running) < in_flight:
            waiting.pop()
            running.append(_look_back_block(state, counts))
        k = int(rng.integers(len(running)))
        try:
            next(running[k])
        except StopIteration as stop:
            tile, excl = stop.value
            out[tile] = excl
            running.pop(k)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_look_back_model_leaves_state_zero(seed):
    """Launches on one stream run one after another: each, however its
    blocks interleave, gets every tile once and the exclusive prefix of
    the tile counts, and leaves the state all zeros, so the next launch
    (larger, smaller or empty selections) needs no reset and no host
    bookkeeping."""
    rng = np.random.default_rng(seed)
    state = {"ticket": 0, "done": 0, "status": [(0, 0)] * 40}
    for n_tiles in (40, 7, 1, 40, 23):
        counts = [int(c) for c in rng.integers(0, 8193, n_tiles)]
        counts[int(rng.integers(n_tiles))] = 0
        got = _run_launch(state, counts, rng, int(rng.integers(1, 9)))
        assert got == {t: sum(counts[:t]) for t in range(n_tiles)}
        assert state == {"ticket": 0, "done": 0,
                         "status": [(0, 0)] * 40}


# --------------------------------------------------------------------------
# No fallback, and the kernel on the card
# --------------------------------------------------------------------------
def test_wrapper_raises_without_kernel(monkeypatch, tmp_path):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import build as kbuild
    monkeypatch.setattr(kbuild, "_libs", {})
    monkeypatch.setattr(kbuild, "_BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with FakeTensorMode():
        planes = torch.empty((5, 2048), dtype=torch.int32, device="cuda")
        mask = torch.empty(2048, dtype=torch.int32, device="cuda")
    before = kmat.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kmat.materialize(planes, mask)
    assert kmat.launches == before


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    for widths, density in CASES:
        for n_words in (1251, 1, 4096):
            _, _, planes, mask = _case(n_words * 32 - 7, widths, density,
                                       seed=n_words, n_words=n_words)
            cpu = [_t(p) for p in planes]
            before = kmat.launches
            got, cnt = kmat.materialize([p.cuda() for p in cpu],
                                        _t(mask).cuda())
            want, wcnt = kmat.materialize_torch(cpu, _t(mask))
            torch.cuda.synchronize()
            assert kmat.launches == before + 1
            n = int(wcnt)
            assert int(cnt) == n
            assert torch.equal(got[:, :n].cpu(), want[:, :n])


@pytest.mark.cuda
def test_kernel_layouts_and_decodes_match_plain_on_card():
    """Both layouts and both decodes, reached through the inputs: 67 and
    100,003 words are fewer tiles than an H100 holds at once (the
    look-back), 250,001 more (the two passes); the model's masks leave
    warps sparse (one record) and dense (all-ones, half) and mix them.
    Widths 1, 7, 31, 32, 33, each alone and all together."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    for n_words in (67, 100_003, 250_001):
        stacks = []
        for width in (1, 7, 31, 32, 33):
            for name, planes, mask in _model_cases(width, n_words):
                cpu = [_t(planes)]
                got, cnt = kmat.materialize_kernel(
                    [p.cuda() for p in cpu], _t(mask).cuda())
                want, wcnt = kmat.materialize_torch(cpu, _t(mask))
                n = int(wcnt)
                assert int(cnt) == n, (n_words, width, name)
                assert torch.equal(got[:, :n].cpu(), want[:, :n]), \
                    (n_words, width, name)
            stacks.append(_t(planes))
        got, cnt = kmat.materialize_kernel([p.cuda() for p in stacks],
                                           _t(mask).cuda())
        want, wcnt = kmat.materialize_torch(stacks, _t(mask))
        n = int(wcnt)
        assert int(cnt) == n
        assert torch.equal(got[:, :n].cpu(), want[:, :n])


@pytest.mark.cuda
def test_kernel_from_threads_on_one_stream():
    """Four host threads call the kernel at once on the default stream, as
    ``execute`` from several threads does: every result equals plain (the
    look-back's state on the card is shared by the stream's launches)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    import threading
    _, planes, mask = _model_cases(31, 20_001)[-1]
    cpu = [_t(planes)]
    want, wcnt = kmat.materialize_torch(cpu, _t(mask))
    n = int(wcnt)
    dev, dmask = [p.cuda() for p in cpu], _t(mask).cuda()
    results = []

    def run():
        for _ in range(50):
            results.append(kmat.materialize_kernel(dev, dmask))
    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert len(results) == 200
    for got, cnt in results:
        assert int(cnt) == n
        assert torch.equal(got[:, :n].cpu(), want[:, :n])
