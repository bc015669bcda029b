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
* The wrapper never falls back; on a card the kernel equals the plain
  version (``cuda`` marker).
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
