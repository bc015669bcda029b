"""Port: word primitives of ``repro_torch.core.engine`` against the
reference ``repro.core.engine``, bit for bit (tolerance 0), at random
widths and at record counts that are not a multiple of the tile."""
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro_torch.core import bitslice as tb
from repro_torch.core import engine as te
from repro_torch.kernels.common import popcount

SEED = 123


@pytest.fixture(scope="module")
def reng():
    pytest.importorskip("jax")
    from repro.core import engine
    return engine


def _planes(rng, n_records, n_bits):
    """Packed (uint32 numpy, int32 torch) planes of random values, with
    the padding words past ``n_records`` left zero like a relation's."""
    vals = rng.integers(0, 1 << n_bits, n_records)
    p = tb.pack_bits(vals, n_bits)
    return vals, p, te.to_planes(p, "cpu")


def _same(mine, theirs):
    np.testing.assert_array_equal(te.to_words(mine), np.asarray(theirs))


def test_swar_popcount_is_exact():
    words = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0xAAAAAAAA,
                      0x12345678, 0xF0F0F0F0], np.uint32)
    got = popcount(te.to_planes(words, "cpu"))
    assert got.dtype == torch.int32
    assert got[2].item() == 32 and got[3].item() == 1
    np.testing.assert_array_equal(got.numpy(), np.bitwise_count(words))
    rnd = np.random.default_rng(SEED).integers(0, 1 << 32, 4096,
                                               dtype=np.uint64)
    rnd = rnd.astype(np.uint32)
    np.testing.assert_array_equal(popcount(te.to_planes(rnd, "cpu")).numpy(),
                                  np.bitwise_count(rnd))


@settings(max_examples=12, deadline=None)
@given(st.integers(1, 20), st.integers(1, 20), st.integers(0, 1 << 22),
       st.sampled_from([100, 1000, 33_000]))
def test_comparators_match_reference(wa, wb, imm, n):
    pytest.importorskip("jax")
    from repro.core import engine as reng
    import jax.numpy as jnp
    rng = np.random.default_rng(SEED + wa * 31 + wb)
    _, pa_np, pa = _planes(rng, n, wa)
    _, pb_np, pb = _planes(rng, n, wb)
    imm = imm % (1 << wa)
    ja, jb = jnp.asarray(pa_np), jnp.asarray(pb_np)
    _same(te.eq_imm_planes(pa, imm), reng.eq_imm_planes(ja, imm))
    for mine, theirs in zip(te.cmp_imm_planes(pa, imm),
                            reng.cmp_imm_planes(ja, imm)):
        _same(mine, theirs)
    for mine, theirs in zip(te.cmp_planes(pa, pb), reng.cmp_planes(ja, jb)):
        _same(mine, theirs)


@settings(max_examples=6, deadline=None)
@given(st.integers(1, 12), st.integers(1, 8), st.integers(1, 1 << 12),
       st.sampled_from([100, 1000, 33_000]), st.booleans())
def test_arithmetic_matches_reference(wa, wb, imm, n, carry_in):
    pytest.importorskip("jax")
    from repro.core import engine as reng
    import jax.numpy as jnp
    rng = np.random.default_rng(SEED + wa * 17 + wb)
    va, pa_np, pa = _planes(rng, n, wa)
    vb, pb_np, pb = _planes(rng, n, wb)
    ja, jb = jnp.asarray(pa_np), jnp.asarray(pb_np)
    out = wa + wb
    cin = int(carry_in)
    _same(te.add_planes(pa, pb, out, carry_in=cin),
          reng.add_planes(ja, jb, out, carry_in=cin))
    _same(te.add_imm_planes(pa, imm, out), reng.add_imm_planes(ja, imm, out))
    _same(te.sub_planes(pa, pb, out), reng.sub_planes(ja, jb, out))
    for k in (1, wa, wa + 3):
        _same(te.extend_planes(pa, k), reng.extend_planes(ja, k))
        _same(te.shift_planes(pa, k, out), reng.shift_planes(ja, k, out))
    _same(te.imm_planes(imm, out, pa[0]),
          reng.imm_planes(imm, out, pa.shape[1:]))
    for mine, theirs in zip(te.mul_partial_products(pa, pb, None, out),
                            reng.mul_partial_products(ja, jb, None, out)):
        _same(mine, theirs)
    for mine, theirs in zip(te.mul_partial_products(pa, None, imm, out),
                            reng.mul_partial_products(ja, None, imm, out)):
        _same(mine, theirs)
    for mine, theirs in zip(te.csa_compress3(pa, pa, pa),
                            reng.csa_compress3(ja, ja, ja)):
        _same(mine, theirs)
    terms = [pa, pb, te.shift_planes(pa, 2, out)]
    jterms = [ja, jb, reng.shift_planes(ja, 2, out)]
    for mine, theirs in zip(te.csa_reduce(terms, out),
                            reng.csa_reduce(jterms, out)):
        _same(mine, theirs)
    _same(te.add_planes_csa(terms, out, carry_in=cin),
          reng.add_planes_csa(jterms, out, carry_in=cin))
    _same(te.mul_imm_planes_csa(pa, imm, out),
          reng.mul_imm_planes_csa(ja, imm, out))
    prod = te.mul_planes_csa(pa, pb, out)
    _same(prod, reng.mul_planes_csa(ja, jb, out))
    assert te.csa_tree_levels(wa + wb) == reng.csa_tree_levels(wa + wb)
    # And the product is the product (records past n are zero padding).
    np.testing.assert_array_equal(tb.unpack_bits(te.to_words(prod), n),
                                  (va * vb).astype(np.uint64))


def test_grouped_popcount_matches_reference(reng):
    import jax.numpy as jnp
    rng = np.random.default_rng(SEED)
    n = 40_000                                     # not a tile multiple
    _, p_np, p = _planes(rng, n, 13)
    m_np = np.stack([tb.pack_mask(rng.random(n) < q, p_np.shape[1])
                     for q in (0.0, 0.3, 1.0)])
    got = te.reduce_sum_bits_grouped(p, te.to_planes(m_np, "cpu"))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(reng.reduce_sum_bits_grouped(
            jnp.asarray(p_np), jnp.asarray(m_np))))


def test_block_choice_fits_shared_memory():
    """fused_program's launch: K = 2 words per thread and the block of two
    warps or more that keeps the most words resident per SM (counted up
    to RESIDENT_WORDS), the smaller block on a tie; one warp, then K = 1,
    when nothing larger fits; raises past that."""
    from repro_torch.kernels.common import (RESIDENT_WORDS, SMEM_BYTES,
                                            Launch, plan_launch)
    q1 = plan_launch(54 + 58, 630)                    # Q1: rows + slots
    assert q1 == Launch(threads=256, k=2)
    assert q1.blocks_per_sm(112, 630) == 1
    assert q1.smem_bytes(112, 630) <= SMEM_BYTES
    q6 = plan_launch(47 + 12, 27)
    assert q6 == Launch(threads=96, k=2) and q6.blocks_per_sm(59, 27) == 5
    q15 = plan_launch(13 + 4, 0)              # enough words at any size
    assert q15 == Launch(threads=64, k=2)
    assert q15.blocks_per_sm(17, 0) * q15.tile >= RESIDENT_WORDS
    assert plan_launch(112, 630, k=4) == Launch(threads=128, k=4)
    assert plan_launch(112, 630, k=1) == Launch(threads=512, k=1)
    assert plan_launch(900, 0) == Launch(threads=32, k=2)
    assert plan_launch(1700, 0) == Launch(threads=32, k=1)
    with pytest.raises(ValueError, match="shared memory"):
        plan_launch(1900, 0)
