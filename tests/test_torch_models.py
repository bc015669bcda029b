"""Port: the model layers (``repro_torch.models``: layers, attention, flash,
moe, ssm, xlstm), each function held against the reference's.

Inputs come from ``np.random.default_rng``; weights from the reference's
init, carried across with ``load_reference_params`` (which places a
module's leaves by name, stacked or not). Tolerances: the layers and
attention within 1e-5 x max(1, max|ref|) in float32 and 1e-2 x max(1,
max|ref|) in bf16 (both sides round the same bf16 inputs); flash, the
reference's cases (``tests/test_models.py``: causal, non-causal, softcap
30, window 64, S = 272) within 2e-5 of the reference's flash and of dense
attention; MoE routing integers exactly, ``moe_apply`` within 2e-5; the
SSM and the xLSTM cells within 1e-4 x max(1, max|ref|), and chunked
against the recurrence in the port alone within the reference's 1e-3
(sLSTM scan against decode 1e-4).
"""
import dataclasses

import numpy as np
import pytest
import torch

from _lm_parity import assert_close, np_leaf, np_tree
from repro_torch.configs import get_smoke_config
from repro_torch.configs.common import MoEConfig, SSMConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as X
from repro_torch.models.convert import load_reference_params
from repro_torch.models.flash import flash_attention

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.common import MoEConfig as RMoEConfig  # noqa: E402
from repro.configs.common import SSMConfig as RSSMConfig  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import lm as RLM  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.models import ssm as RSSM  # noqa: E402
from repro.models import xlstm as RX  # noqa: E402
from repro.models.flash import flash_attention as ref_flash  # noqa: E402

DTYPES = ("float32", "bfloat16")
INIT = L.Init("cpu", torch.Generator().manual_seed(0))


def rel(dtype):
    return 1e-5 if dtype == "float32" else 1e-2


def check(got, want, dtype, what=""):
    want = np_leaf(want)
    assert_close(np_leaf(got), want,
                 rel(dtype) * max(1.0, float(np.max(np.abs(want)))), what)


def pair(a, dtype):
    """A float32 numpy array as (jax, torch) arrays of ``dtype`` (the same
    bf16 rounding on both sides)."""
    a = np.asarray(a, np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def carried(module, params):
    """``module`` with the reference's ``params`` (a dict of JAX arrays)."""
    load_reference_params(module, np_tree(params))
    return module


def ref(fn, *arrays, **static):
    """The reference's ``fn(*arrays, **static)``, jitted with the keyword
    arguments closed over (one compile instead of one per op)."""
    return jax.jit(lambda *a: fn(*a, **static))(*arrays)


def tdt(dtype):
    return L.torch_dtype(dtype)


def jdt(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    jx, tx = pair(rng.normal(size=(2, 5, 32)) * 3, dtype)
    scale = rng.normal(size=32).astype(np.float32) * 0.1
    check(L.rmsnorm(torch.from_numpy(scale), tx),
          RL.rmsnorm({"scale": jnp.asarray(scale)}, jx), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm(dtype):
    rng = np.random.default_rng(1)
    jx, tx = pair(rng.normal(size=(2, 5, 32)) + 3, dtype)
    scale = 1 + rng.normal(size=32).astype(np.float32) * 0.1
    bias = rng.normal(size=32).astype(np.float32) * 0.1
    check(L.layernorm(torch.from_numpy(scale), torch.from_numpy(bias), tx),
          RL.layernorm({"scale": jnp.asarray(scale),
                        "bias": jnp.asarray(bias)}, jx), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ("rmsnorm", "layernorm"))
def test_norm_module(kind, dtype):
    rng = np.random.default_rng(2)
    jx, tx = pair(rng.normal(size=(3, 16)), dtype)
    p = RL.norm_init(kind, 16)
    check(carried(L.Norm(kind, 16, INIT), p)(tx),
          RL.norm_apply(kind, p, jx), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ("swiglu", "geglu", "gelu"))
def test_mlp(act, dtype):
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"), d_model=32,
                              d_ff=64, mlp_act=act)
    p = RLM._mlp_init(jax.random.PRNGKey(3), cfg, jdt(dtype))
    rng = np.random.default_rng(3)
    jx, tx = pair(rng.normal(size=(2, 5, 32)), dtype)
    got = carried(L.MLP(32, 64, act, INIT, tdt(dtype)), p)(tx)
    check(got, ref(RLM._mlp_apply, p, jx, cfg=cfg), dtype, act)
    if act == "swiglu":
        check(got, RL.swiglu(p, jx), dtype)


def test_gelu_is_the_tanh_form():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    got = L.gelu(torch.from_numpy(x)).numpy()
    assert_close(got, np.asarray(jax.nn.gelu(jnp.asarray(x))), 1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - exact).max() > 1e-4     # not the erf form


def test_empty_mlp_adds_zeros():
    x = torch.ones(2, 3, 8)
    assert (L.MLP(8, 0, "swiglu", INIT, torch.float32)(x) == 0).all()


@pytest.mark.parametrize("cap", (None, 30.0))
def test_softcap(cap):
    x = np.random.default_rng(4).normal(size=(4, 9)).astype(np.float32) * 50
    check(L.softcap(torch.from_numpy(x), cap),
          RL.softcap(jnp.asarray(x), cap), "float32")


def test_softplus():
    x = np.linspace(-30, 30, 301).astype(np.float32)
    check(L.softplus(torch.from_numpy(x)),
          jax.nn.softplus(jnp.asarray(x)), "float32")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("theta", (10000.0, 500000.0))
def test_apply_rope(theta, dtype):
    rng = np.random.default_rng(5)
    jx, tx = pair(rng.normal(size=(2, 7, 3, 16)), dtype)
    pos = rng.integers(0, 1000, (2, 7))
    assert np.array_equal(L.rope_freqs(16, theta), RL.rope_freqs(16, theta))
    check(L.apply_rope(tx, torch.from_numpy(pos), theta),
          RL.apply_rope(jx, jnp.asarray(pos), theta), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offset", (0, 5))
def test_sinusoidal_pos(offset, dtype):
    check(L.sinusoidal_pos(24, 64, tdt(dtype), offset=offset,
                           device="cpu"),
          RL.sinusoidal_pos(24, 64, jdt(dtype), offset=offset), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_unembed(dtype):
    p = RL.embed_init(jax.random.PRNGKey(6), 50, 32, jdt(dtype))
    e = carried(L.Embed(50, 32, INIT, tdt(dtype)), p)
    ids = np.random.default_rng(6).integers(0, 50, (2, 7))
    x = L.embed(e, torch.from_numpy(ids))
    check(x, RL.embed(p, jnp.asarray(ids)), dtype)
    check(L.unembed(x, e.table), RL.unembed(p, RL.embed(p, jnp.asarray(ids))),
          dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_entropy(dtype):
    rng = np.random.default_rng(7)
    jx, tx = pair(rng.normal(size=(2, 7, 50)) * 3, dtype)
    labels = rng.integers(0, 50, (2, 7))
    check(L.cross_entropy(tx, torch.from_numpy(labels)),
          RL.cross_entropy(jx, jnp.asarray(labels)), "float32")


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
# qwen2's smoke attention: GQA 7/1 heads with a qkv bias; gemma2's:
# softcap 50 and a window of 16.
ATTN_CFGS = ("qwen2", "gemma2")


def attn_setup(arch, dtype, seed=8):
    cfg = get_smoke_config("qwen2-0.5b" if arch == "qwen2" else "gemma2-9b")
    p = RA.attn_init(jax.random.PRNGKey(seed), cfg, jdt(dtype))
    if cfg.qkv_bias:                     # non-zero biases reach the adds
        rng = np.random.default_rng(seed)
        p = {k: (jnp.asarray(rng.normal(size=v.shape) * 0.1, v.dtype)
                 if k.startswith("b") else v) for k, v in p.items()}
    return cfg, p, carried(A.Attention(cfg, INIT, tdt(dtype)), p)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ATTN_CFGS)
def test_attention(arch, dtype):
    cfg, p, tp = attn_setup(arch, dtype)
    rng = np.random.default_rng(9)
    jx, tx = pair(rng.normal(size=(2, 20, cfg.d_model)), dtype)
    pos = np.broadcast_to(np.arange(20), (2, 20))
    for window in (None, cfg.sliding_window):
        check(A.attention(tp, tx, torch.from_numpy(pos.copy()), cfg, window),
              ref(RA.attention, p, jx, jnp.asarray(pos), cfg=cfg,
                  window=window), dtype,
              f"window {window}")


@pytest.mark.parametrize("window", (None, 4))
def test_causal_mask(window):
    assert np.array_equal(A.causal_mask(9, window, "cpu").numpy(),
                          np.asarray(RA.causal_mask(9, window)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ATTN_CFGS)
def test_attention_decode(arch, dtype):
    cfg, p, tp = attn_setup(arch, dtype)
    rng = np.random.default_rng(10)
    jx, tx = pair(rng.normal(size=(2, 1, cfg.d_model)), dtype)
    shape = (2, 12, cfg.n_kv_heads, cfg.head_dim)
    jk, tk = pair(rng.normal(size=shape), dtype)
    jv, tv = pair(rng.normal(size=shape), dtype)
    for window in (None, 4):
        y, cache = A.attention_decode(tp, tx, 7, A.KVCache(tk.clone(),
                                                           tv.clone()),
                                      cfg, window)
        ry, rc = ref(RA.attention_decode, p, jx, jnp.int32(7),
                     RA.KVCache(jk, jv), cfg=cfg, window=window)
        check(y, ry, dtype, "y")
        check(cache.k, rc.k, dtype, "k")
        check(cache.v, rc.v, dtype, "v")


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_and_encode_kv(dtype):
    cfg, p, tp = attn_setup("qwen2", dtype)
    rng = np.random.default_rng(11)
    jx, tx = pair(rng.normal(size=(2, 3, cfg.d_model)), dtype)
    je, te = pair(rng.normal(size=(2, 10, cfg.d_model)), dtype)
    rk, rv = ref(RA.encode_kv, p, je, cfg=cfg)
    k, v = A.encode_kv(tp, te, cfg)
    check(k, rk, dtype, "k")
    check(v, rv, dtype, "v")
    check(A.cross_attention(tp, tx, (k, v), cfg),
          ref(RA.cross_attention, p, jx, (rk, rv), cfg=cfg), dtype)


# --------------------------------------------------------------------------
# flash
# --------------------------------------------------------------------------
def dense_attn(q, k, v, causal=True, window=None, softcap=None):
    """Plain attention (torch, float32): the flash schedule's oracle."""
    B, S, nh, hd = q.shape
    T, nkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, nkv, nh // nkv, hd)
    s = torch.einsum("bqngh,bknh->bngqk", qg, k) / np.sqrt(hd)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qpos, kpos = torch.arange(S)[:, None], torch.arange(T)[None]
    m = torch.ones((S, T), dtype=torch.bool)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= (qpos - kpos) < window
    p = torch.softmax(torch.where(m, s, -1e30), -1)
    return torch.einsum("bngqk,bknh->bqngh", p, v).reshape(B, S, nh, hd)


def qkv(seed, shape_q, shape_kv):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in (shape_q, shape_kv, shape_kv)]


@pytest.mark.parametrize("kwargs", [
    dict(causal=True), dict(causal=False), dict(causal=True, softcap=30.0),
    dict(causal=True, window=64)])
def test_flash_matches_reference_and_dense(kwargs):
    q, k, v = qkv(0, (2, 256, 8, 32), (2, 256, 4, 32))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), q_block=64,
                          kv_block=64, **kwargs)
    want = np.asarray(ref(ref_flash, *map(jnp.asarray, (q, k, v)),
                          q_block=64, kv_block=64, **kwargs))
    assert_close(got.numpy(), want, 2e-5)
    assert_close(got.numpy(),
                 dense_attn(*map(torch.from_numpy, (q, k, v)),
                            **kwargs).numpy(), 2e-5)


def test_flash_odd_seq_autoblock():
    """S = 272 = 16 x 17 (a vision-prefixed length) picks dividing blocks."""
    q, k, v = qkv(1, (1, 272, 4, 16), (1, 272, 4, 16))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), q_block=64,
                          kv_block=128)
    want = np.asarray(ref(ref_flash, *map(jnp.asarray, (q, k, v)),
                          q_block=64, kv_block=128))
    assert_close(got.numpy(), want, 2e-5)
    assert_close(got.numpy(),
                 dense_attn(*map(torch.from_numpy, (q, k, v))).numpy(), 2e-5)


@pytest.mark.parametrize("window", (None, 16))
def test_flash_q_offset(window):
    """Chunked prefill: 32 queries at absolute positions 64.. over 96 keys."""
    q, k, v = qkv(2, (2, 32, 4, 16), (2, 96, 2, 16))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), q_offset=64,
                          window=window, q_block=16, kv_block=32)
    want = np.asarray(ref(ref_flash, *map(jnp.asarray, (q, k, v)),
                          q_offset=64, window=window, q_block=16,
                          kv_block=32))
    assert_close(got.numpy(), want, 2e-5)


def test_flash_bf16_matches_reference():
    q, k, v = qkv(3, (2, 64, 4, 16), (2, 64, 2, 16))
    pj = [pair(a, "bfloat16") for a in (q, k, v)]
    for kwargs in (dict(causal=True, softcap=50.0), dict(window=16)):
        got = flash_attention(*(t for _, t in pj), q_block=16, kv_block=32,
                              **kwargs)
        want = ref(ref_flash, *(j for j, _ in pj), q_block=16,
                   kv_block=32, **kwargs)
        check(got, want, "bfloat16")


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
def moe_cfgs(n_shared=0, k=2, E=8):
    return (MoEConfig(n_experts=E, top_k=k, d_ff_expert=32, n_shared=n_shared),
            RMoEConfig(n_experts=E, top_k=k, d_ff_expert=32,
                       n_shared=n_shared))


@pytest.mark.parametrize("logits_kind,capacity", [
    ("normal", 128), ("normal", 1), ("normal", None), ("ties", 128),
    ("ties", 3)])
def test_route_indices_equal_reference(logits_kind, capacity):
    """``src``, ``slots_tk`` and ``keep_tk`` equal the reference's as
    integers: full capacity, capacity 1 (drops), the default, and logits
    full of ties (``top_k`` toward the lower index, a stable sort)."""
    rng = np.random.default_rng(12)
    if logits_kind == "ties":
        logits = rng.integers(0, 3, (64, 8)).astype(np.float32)
    else:
        logits = rng.normal(size=(64, 8)).astype(np.float32)
    cfg, rcfg = moe_cfgs()
    cap = capacity or M.default_capacity(64, cfg)
    got = M._route_indices(torch.from_numpy(logits), cfg, cap)
    want = ref(RM._route_indices, jnp.asarray(logits), cfg=rcfg,
               capacity=cap)
    for name, g, w in zip(("src", "slots_tk", "weights", "keep_tk"), got,
                          want):
        if name == "weights":
            assert_close(g.numpy(), np.asarray(w), 1e-6, name)
        else:
            assert np.array_equal(g.numpy().astype(np.int64),
                                  np.asarray(w).astype(np.int64)), name
    if capacity == 1:
        assert not got[3].all()          # some choices were dropped


def test_default_capacity_equals_reference():
    for S, k, E in ((1, 1, 4), (1, 8, 64), (16, 8, 64), (64, 2, 8),
                    (4096, 1, 128)):
        cfg, _ = moe_cfgs(k=k, E=E)
        want = max(4, min(int(np.ceil(S * k / E * cfg.capacity_factor)),
                          S * k))
        assert M.default_capacity(S, cfg) == want


def moe_setup(n_shared, dtype="float32"):
    cfg, rcfg = moe_cfgs(n_shared)
    p = RM.moe_init(jax.random.PRNGKey(0), 16, rcfg, jdt(dtype))
    return cfg, rcfg, p, carried(M.MoE(16, cfg, INIT, tdt(dtype)), p)


@pytest.mark.parametrize("n_shared", (0, 1))
@pytest.mark.parametrize("capacity,seq_groups", [(128, 1), (None, 1),
                                                 (1, 1), (None, 2)])
def test_moe_apply_equals_reference(n_shared, capacity, seq_groups):
    cfg, rcfg, p, tp = moe_setup(n_shared)
    x = np.random.default_rng(13).normal(size=(3, 64, 16)).astype(np.float32)
    got = M.moe_apply(tp, torch.from_numpy(x), cfg, capacity=capacity,
                      seq_groups=seq_groups)
    want = ref(RM.moe_apply, p, jnp.asarray(x), cfg=rcfg,
               capacity=capacity, seq_groups=seq_groups)
    assert_close(got.numpy(), np.asarray(want), 2e-5)


def test_moe_apply_bf16_equals_reference():
    cfg, rcfg, p, tp = moe_setup(1, "bfloat16")
    jx, tx = pair(np.random.default_rng(14).normal(size=(2, 16, 16)),
                  "bfloat16")
    check(M.moe_apply(tp, tx, cfg), ref(RM.moe_apply, p, jx, cfg=rcfg), "bfloat16")


@pytest.mark.parametrize("n_shared", (0, 1))
def test_moe_ref(n_shared):
    """The dense oracle against the reference's, and against ``moe_apply``
    at full capacity in the port alone."""
    cfg, rcfg, p, tp = moe_setup(n_shared)
    x = np.random.default_rng(15).normal(size=(3, 64, 16)).astype(np.float32)
    got = M.moe_ref(tp, torch.from_numpy(x), cfg)
    assert_close(got.numpy(), np.asarray(ref(RM.moe_ref, p, jnp.asarray(x),
                                            cfg=rcfg)),
                 2e-5)
    full = M.moe_apply(tp, torch.from_numpy(x), cfg, capacity=128)
    assert_close(full.numpy(), got.numpy(), 2e-5)


# --------------------------------------------------------------------------
# SSM (Mamba2)
# --------------------------------------------------------------------------
def ssm_setup(n_groups=1, dtype="float32"):
    kw = dict(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=n_groups)
    cfg, rcfg = SSMConfig(**kw), RSSMConfig(**kw)
    p = RSSM.ssm_init(jax.random.PRNGKey(0), 32, rcfg, jdt(dtype))
    rng = np.random.default_rng(16)     # non-trivial A, dt bias, D
    p = dict(p, A_log=jnp.asarray(rng.normal(size=p["A_log"].shape) * 0.5,
                                  jnp.float32),
             D=jnp.asarray(1 + rng.normal(size=p["D"].shape) * 0.1,
                           jnp.float32))
    return cfg, rcfg, p, carried(SSM.SSM(32, cfg, INIT, tdt(dtype)), p)


def ref_bound(want, r=1e-4):
    return r * max(1.0, float(np.max(np.abs(np_leaf(want)))))


@pytest.mark.parametrize("n_groups", (1, 2))
def test_ssm_apply_and_ref_equal_reference(n_groups):
    cfg, rcfg, p, tp = ssm_setup(n_groups)
    x = np.random.default_rng(17).normal(size=(2, 64, 32)).astype(np.float32)
    want = ref(RSSM.ssm_apply, p, jnp.asarray(x), cfg=rcfg, chunk=16)
    got = SSM.ssm_apply(tp, torch.from_numpy(x), cfg, chunk=16)
    assert_close(got.numpy(), np.asarray(want), ref_bound(want))
    want_r = ref(RSSM.ssm_ref, p, jnp.asarray(x[:, :12]), cfg=rcfg)
    got_r = SSM.ssm_ref(tp, torch.from_numpy(x[:, :12]), cfg)
    assert_close(got_r.numpy(), np.asarray(want_r), ref_bound(want_r))


@pytest.mark.parametrize("n_groups", (1, 2))
def test_ssm_decode_equals_reference(n_groups):
    cfg, rcfg, p, tp = ssm_setup(n_groups)
    rng = np.random.default_rng(18)
    x = rng.normal(size=(2, 1, 32)).astype(np.float32)
    conv = rng.normal(size=(2, 3, 64)).astype(np.float32)
    st = rng.normal(size=(2, 4, 16, 16)).astype(np.float32)
    y, ns = SSM.ssm_decode(tp, torch.from_numpy(x),
                           SSM.SSMState(torch.from_numpy(conv),
                                        torch.from_numpy(st)), cfg)
    ry, rs = ref(RSSM.ssm_decode, p, jnp.asarray(x),
                 RSSM.SSMState(jnp.asarray(conv), jnp.asarray(st)),
                 cfg=rcfg)
    for g, w in ((y, ry), (ns.conv, rs.conv), (ns.ssm, rs.ssm)):
        assert_close(g.numpy(), np.asarray(w), ref_bound(w))


def test_ssm_chunked_matches_recurrence():
    cfg, _, _, tp = ssm_setup()
    x = torch.from_numpy(
        np.random.default_rng(19).normal(size=(2, 64, 32)).astype(np.float32))
    err = (SSM.ssm_apply(tp, x, cfg, chunk=16) - SSM.ssm_ref(tp, x, cfg))
    assert float(err.abs().max()) < 1e-3


def test_ssm_bf16_equals_reference():
    cfg, rcfg, p, tp = ssm_setup(1, "bfloat16")
    jx, tx = pair(np.random.default_rng(20).normal(size=(2, 32, 32)),
                  "bfloat16")
    check(SSM.ssm_apply(tp, tx, cfg, chunk=16),
          ref(RSSM.ssm_apply, p, jx, cfg=rcfg, chunk=16), "bfloat16")


# --------------------------------------------------------------------------
# xLSTM
# --------------------------------------------------------------------------
def mlstm_setup(dtype="float32"):
    p = RX.mlstm_init(jax.random.PRNGKey(0), 32, 4, jdt(dtype))
    return p, carried(X.MLSTM(32, 4, INIT, tdt(dtype)), p)


def slstm_setup(dtype="float32"):
    p = RX.slstm_init(jax.random.PRNGKey(1), 32, 4, jdt(dtype))
    return p, carried(X.SLSTM(32, 4, INIT, tdt(dtype)), p)


def test_mlstm_apply_and_ref_equal_reference():
    p, tp = mlstm_setup()
    x = np.random.default_rng(21).normal(size=(2, 64, 32)).astype(np.float32)
    want = ref(RX.mlstm_apply, p, jnp.asarray(x), n_heads=4, chunk=16)
    got = X.mlstm_apply(tp, torch.from_numpy(x), 4, chunk=16)
    assert_close(got.numpy(), np.asarray(want), ref_bound(want))
    want_r = ref(RX.mlstm_ref, p, jnp.asarray(x[:, :12]), n_heads=4)
    got_r = X.mlstm_ref(tp, torch.from_numpy(x[:, :12]), 4)
    assert_close(got_r.numpy(), np.asarray(want_r), ref_bound(want_r))


def test_mlstm_decode_equals_reference():
    p, tp = mlstm_setup()
    rng = np.random.default_rng(22)
    x = rng.normal(size=(2, 1, 32)).astype(np.float32)
    C = rng.normal(size=(2, 4, 8, 16)).astype(np.float32)
    n = rng.normal(size=(2, 4, 8)).astype(np.float32)
    y, st = X.mlstm_decode(tp, torch.from_numpy(x),
                           X.MLSTMState(torch.from_numpy(C),
                                        torch.from_numpy(n)), 4)
    ry, rs = ref(RX.mlstm_decode, p, jnp.asarray(x),
                 RX.MLSTMState(jnp.asarray(C), jnp.asarray(n)), n_heads=4)
    for g, w in ((y, ry), (st.C, rs.C), (st.n, rs.n)):
        assert_close(g.numpy(), np.asarray(w), ref_bound(w))


def test_mlstm_chunked_matches_recurrence():
    _, tp = mlstm_setup()
    x = torch.from_numpy(
        np.random.default_rng(23).normal(size=(2, 64, 32)).astype(np.float32))
    err = X.mlstm_apply(tp, x, 4, chunk=16) - X.mlstm_ref(tp, x, 4)
    assert float(err.abs().max()) < 1e-3


def test_slstm_apply_and_decode_equal_reference():
    p, tp = slstm_setup()
    rng = np.random.default_rng(24)
    x = rng.normal(size=(2, 32, 32)).astype(np.float32)
    want = ref(RX.slstm_apply, p, jnp.asarray(x), n_heads=4)
    assert_close(X.slstm_apply(tp, torch.from_numpy(x), 4).numpy(),
                 np.asarray(want), ref_bound(want))
    c, n, h = (rng.normal(size=(2, 32)).astype(np.float32) for _ in range(3))
    n = np.abs(n)
    y, st = X.slstm_decode(tp, torch.from_numpy(x[:, :1]),
                           X.SLSTMState(*map(torch.from_numpy, (c, n, h))), 4)
    ry, rs = ref(RX.slstm_decode, p, jnp.asarray(x[:, :1]),
                 RX.SLSTMState(*map(jnp.asarray, (c, n, h))), n_heads=4)
    for g, w in zip((y, *st), (ry, *rs)):
        assert_close(g.numpy(), np.asarray(w), ref_bound(w))


def test_slstm_scan_matches_decode():
    _, tp = slstm_setup()
    x = torch.from_numpy(
        np.random.default_rng(25).normal(size=(2, 32, 32)).astype(np.float32))
    st = X.slstm_init_state(2, 32, device="cpu")
    outs = []
    for t in range(32):
        o, st = X.slstm_decode(tp, x[:, t:t + 1], st, 4)
        outs.append(o)
    err = X.slstm_apply(tp, x, 4) - torch.cat(outs, 1)
    assert float(err.abs().max()) < 1e-4


def test_xlstm_bf16_equals_reference():
    p, tp = mlstm_setup("bfloat16")
    ps, tps = slstm_setup("bfloat16")
    jx, tx = pair(np.random.default_rng(26).normal(size=(2, 32, 32)),
                  "bfloat16")
    check(X.mlstm_apply(tp, tx, 4, chunk=16),
          ref(RX.mlstm_apply, p, jx, n_heads=4, chunk=16), "bfloat16")
    check(X.slstm_apply(tps, tx, 4), ref(RX.slstm_apply, ps, jx, n_heads=4), "bfloat16")
