"""Port: the LM (``repro_torch.models.LM``) for the dense, moe, gemma2 and
encdec block patterns, and the configs, held against the reference.

For each of those architectures at its ``SMOKE`` config in float32, with
the reference's weights carried across (``load_reference_params``) and
the same inputs: forward logits, ``init_cache``'s leaf shapes and dtypes,
8 teacher-forced decode steps' logits, the final cache leaf by leaf,
whisper's ``encode``, and ``loss``, within 1e-4 x max(1, max|ref|); the
same in bf16 for qwen2-0.5b and gemma2-9b within the reference's own
tolerance, max(0.01 x max|ref|, 0.25). The port alone: decode equals
forward for a dense model and through gemma2's ring buffer (S = 24 >
window 16). The configs equal the reference's field by field, and
``load_reference_params`` refuses a missing, extra, misshapen or bf16
leaf. The xlstm and zamba patterns are in ``test_torch_lm_recurrent.py``.

``-m cuda`` (skipped without a card): the ten smoke configs in float32,
the card against the CPU on the same weights.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from _lm_parity import (arch_run, assert_close, bf16_bound, f32_bound,
                        np_tree, ref_params)
from repro_torch import configs
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import LM, load_reference_params
from repro_torch.models.lm import decode_logits

ARCHS = ("llama4-maverick-400b-a17b", "olmoe-1b-7b", "paligemma-3b",
         "qwen1.5-0.5b", "gemma2-9b", "stablelm-3b", "qwen2-0.5b",
         "whisper-small")
BF16_ARCHS = ("qwen2-0.5b", "gemma2-9b")
_RUNS = {}


def runs(arch, dtype="float32"):
    pytest.importorskip("jax")
    if (arch, dtype) not in _RUNS:
        _RUNS[arch, dtype] = arch_run(arch, dtype)
    return _RUNS[arch, dtype]


def _bound(dtype, want):
    return f32_bound(want) if dtype == "float32" else bf16_bound(want)


CASES = [(a, "float32") for a in ARCHS] + [(a, "bfloat16") for a in BF16_ARCHS]


@pytest.mark.parametrize("arch,dtype", CASES)
def test_forward_logits(arch, dtype):
    r = runs(arch, dtype)
    want = r["ref"]["forward"]
    assert_close(r["port"]["forward"], want, _bound(dtype, want), arch)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_init_cache_layout(arch, dtype):
    r = runs(arch, dtype)
    assert r["port"]["init_cache"] == r["ref"]["init_cache"]


@pytest.mark.parametrize("arch,dtype", CASES)
def test_decode_logits(arch, dtype):
    r = runs(arch, dtype)
    want = r["ref"]["decode"]
    assert_close(r["port"]["decode"], want, _bound(dtype, want), arch)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_decode_final_cache(arch, dtype):
    r = runs(arch, dtype)
    ref, port = r["ref"]["cache"], r["port"]["cache"]
    assert [p for p, _ in port] == [p for p, _ in ref]
    for (path, got), (_, want) in zip(port, ref):
        assert_close(got, want, _bound(dtype, want), f"{arch}{path}")


@pytest.mark.parametrize("arch,dtype", CASES)
def test_loss(arch, dtype):
    r = runs(arch, dtype)
    want = r["ref"]["loss"]
    assert_close(r["port"]["loss"], want, _bound(dtype, want), arch)


def test_whisper_encode():
    r = runs("whisper-small")
    for i, (got, want) in enumerate(zip(r["port"]["encode"],
                                        r["ref"]["encode"])):
        assert_close(got, want, f32_bound(want), f"encode leaf {i}")


# --------------------------------------------------------------------------
# decode == forward in the port alone (the reference's two checks)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,B,S", [("qwen1.5-0.5b", 2, 12),
                                      ("qwen2-0.5b", 2, 12),
                                      ("gemma2-9b", 1, 24)])
def test_decode_matches_forward(arch, B, S):
    """Teacher-forced decode logits == forward logits in bf16, within the
    reference's tolerance; gemma2 at S = 24 > its window of 16 goes round
    the local layers' ring buffer."""
    cfg = get_smoke_config(arch)
    model = LM(cfg, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (B, S)))
    full = model.forward(tokens).float().numpy()
    dec = decode_logits(model, tokens).float().numpy()
    assert_close(dec, full, bf16_bound(full), arch)


def test_bf16_decode_gap_at_gemma2_head_width():
    """At gemma2's own head width (d_head 256, 16 q / 8 kv heads) and
    d_model 512, bf16 decode and forward differ beyond the smoke tolerance
    max(0.01 x max|logits|, 0.25) in the reference itself (the logit
    softcap holds max|logits| near 30, so the bound is 0.3). The port's
    gap is the reference's within one bf16 step at 30 (0.125); in float32
    both packages' gaps are within 1e-4 x max|logits|. So at full width
    the decode-vs-forward gate is float32 (``chip_smoke.py`` path k)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as rsmoke
    from repro.models.lm import LM as RefLM
    tokens = np.random.default_rng(0).integers(0, 1024, (2, 16))
    gaps = {}
    for dtype in ("bfloat16", "float32"):
        kw = dict(d_model=512, n_heads=16, n_kv_heads=8, d_head=256,
                  d_ff=512, vocab=1024, dtype=dtype)
        rm = RefLM(dataclasses.replace(rsmoke("gemma2-9b"), **kw))
        params = ref_params(rm)
        pm = LM(dataclasses.replace(get_smoke_config("gemma2-9b"), **kw),
                device="cpu")
        load_reference_params(pm, np_tree(params))
        full = np.asarray(jax.jit(rm.forward)(params, jnp.asarray(tokens)),
                          np.float32)
        cache, step, outs = rm.init_cache(2, 16), jax.jit(rm.decode_step), []
        for t in range(16):
            lg, cache = step(params, cache, jnp.asarray(tokens[:, t:t + 1]),
                             jnp.int32(t))
            outs.append(np.asarray(lg, np.float32))
        tok = torch.from_numpy(tokens)
        port_gap = (decode_logits(pm, tok).float()
                    - pm.forward(tok).float()).abs().max().item()
        gaps[dtype] = (np.abs(np.concatenate(outs, 1) - full).max(),
                       port_gap, full)
    ref_gap, port_gap, full = gaps["bfloat16"]
    assert ref_gap > bf16_bound(full)
    assert port_gap <= ref_gap + 0.125
    ref_gap, port_gap, full = gaps["float32"]
    assert max(ref_gap, port_gap) <= 1e-4 * np.abs(full).max()


def test_gemma2_ring_cache_is_window_sized():
    cfg = get_smoke_config("gemma2-9b")
    cache = LM(cfg, device="cpu").init_cache(1, 24)
    assert cache["local"].k.shape[2] == cfg.sliding_window
    assert cache["global"].k.shape[2] == 24


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_reference(arch):
    pytest.importorskip("jax")
    from repro.configs import get_config as rget
    from repro.configs import get_smoke_config as rsmoke
    for port, ref in ((get_config(arch), rget(arch)),
                      (get_smoke_config(arch), rsmoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert (port.head_dim, port.eff_n_heads, port.eff_n_kv_heads) == \
            (ref.head_dim, ref.eff_n_heads, ref.eff_n_kv_heads)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()


def test_shapes_and_runnable_cells_equal_reference():
    pytest.importorskip("jax")
    from repro.configs import common as rc
    from repro_torch.configs import common as pc
    assert {k: dataclasses.asdict(v) for k, v in pc.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rc.SHAPES.items()}
    assert pc.LONG_CONTEXT_ARCHS == rc.LONG_CONTEXT_ARCHS
    for arch in ARCH_IDS:
        for shape in pc.SHAPES:
            assert pc.cell_is_runnable(arch, shape) == \
                rc.cell_is_runnable(arch, shape), (arch, shape)
    assert list(configs.all_configs()) == ARCH_IDS


def test_attn_head_pad_shapes_and_logits():
    """``attn_head_pad`` pads the q heads and expands K/V in the weights:
    the reference's padded pytree fits the port and gives its logits."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models.lm import LM as RefLM
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              attn_head_pad=8, dtype="float32")
    rm = RefLM(cfg)
    params = ref_params(rm)
    pm = LM(cfg, device="cpu")
    load_reference_params(pm, np_tree(params))
    assert tuple(pm.blocks[0].attn.wq.shape) == (56, 8, 8)
    assert tuple(pm.blocks[0].attn.wk.shape) == (56, 8, 8)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 8))
    want = np.asarray(rm.forward(params, jnp.asarray(tokens)))
    got = pm.forward(torch.from_numpy(tokens)).numpy()
    assert_close(got, want, f32_bound(want))


# --------------------------------------------------------------------------
# load_reference_params
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def qwen_params():
    pytest.importorskip("jax")
    from repro.models.lm import LM as RefLM
    cfg = get_smoke_config("qwen2-0.5b")
    return cfg, ref_params(RefLM(cfg))


def test_load_reference_params_places_every_leaf(qwen_params):
    import jax
    cfg, params = qwen_params
    pm = LM(cfg, device="cpu")
    load_reference_params(pm, np_tree(params))
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    assert n_ref == sum(p.numel() for p in pm.parameters())
    wq = np.asarray(params["blocks"]["attn"]["wq"][1].astype("float32"))
    got = pm.blocks[1].attn.wq.float().numpy()
    assert got.dtype == np.float32 and (got == wq).all()   # bf16 bits kept
    assert pm.blocks[1].attn.wq.dtype == torch.bfloat16
    assert pm.final_norm.scale.dtype == torch.float32


def test_load_reference_params_refuses_missing_extra_and_bad_leaves(
        qwen_params):
    cfg, params = qwen_params
    tree = np_tree(params)
    pm = LM(cfg, device="cpu")
    missing = copy.deepcopy(tree)
    del missing["blocks"]["attn"]["bq"]
    with pytest.raises(KeyError, match="not set"):
        load_reference_params(pm, missing)
    extra = copy.deepcopy(tree)
    extra["blocks"]["attn"]["bx"] = extra["blocks"]["attn"]["bq"]
    with pytest.raises(KeyError, match="no place"):
        load_reference_params(pm, extra)
    bad = copy.deepcopy(tree)
    bad["final_norm"]["scale"] = bad["final_norm"]["scale"][:-1]
    with pytest.raises(ValueError, match="shape"):
        load_reference_params(pm, bad)
    short = copy.deepcopy(tree)
    short["blocks"] = {k: {n: a[:1] for n, a in v.items()}
                       for k, v in short["blocks"].items()}
    with pytest.raises(KeyError, match="not set"):
        load_reference_params(pm, short)
    raw = {"embed": {"table": np.asarray(params["embed"]["table"])}}
    with pytest.raises(TypeError, match="float32"):
        load_reference_params(pm, raw)


def test_lm_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        LM(get_smoke_config("qwen2-0.5b"))


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_config_card_equals_cpu(arch):
    """Each smoke config in float32 on the card against the CPU on the same
    weights: forward logits and 4 greedy decode steps within 1e-3 x
    max(1, max|logits|), the same greedy tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "false")
    from repro_torch.launch.serve import greedy_decode
    from _lm_parity import inputs
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    cpu = LM(cfg, device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    tokens, _, extra = inputs(cfg)
    tok = torch.from_numpy(tokens)
    ex = None if extra is None else torch.from_numpy(extra)
    want = cpu.forward(tok, ex).numpy()
    got = card.forward(tok.cuda(), None if ex is None else ex.cuda())
    bound = 1e-3 * max(1.0, float(np.abs(want).max()))
    assert_close(got.cpu().numpy(), want, bound, arch)
    cross = [None, None]
    if cfg.block_pattern == "encdec":
        cross = [cpu.encode(ex)[1], card.encode(ex.cuda())[1]]
    seq_c, _ = greedy_decode(cpu, tok[:, :1], 5, cross=cross[0])
    seq_g, _ = greedy_decode(card, tok[:, :1].cuda(), 5, cross=cross[1])
    assert (seq_c == seq_g).all(), arch
    lc = decode_logits(cpu, torch.from_numpy(seq_c[:, :4]), cross=cross[0])
    lg = decode_logits(card, torch.from_numpy(seq_c[:, :4]).cuda(),
                       cross=cross[1])
    assert_close(lg.cpu().numpy(), lc.numpy(),
                 1e-3 * max(1.0, float(lc.abs().max())), arch)
