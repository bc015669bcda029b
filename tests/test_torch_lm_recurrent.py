"""Port: the LM's recurrent block patterns, xlstm (units of 7 mLSTM + 1
sLSTM) and zamba (Mamba2 layers with one shared attention block every
``attn_every`` and a tail), held against the reference.

As ``test_torch_lm.py`` for the other patterns: at the ``SMOKE`` config in
float32 with the reference's weights carried across, forward logits,
``init_cache``'s leaf shapes and dtypes, 8 teacher-forced decode steps'
logits, the final recurrent states and K/V leaf by leaf, and ``loss``,
within 1e-4 x max(1, max|ref|). The port alone: teacher-forced decode
against forward (the chunked paths against the recurrences, end to end).
"""
import numpy as np
import pytest
import torch

from _lm_parity import arch_run, assert_close, f32_bound
from repro_torch.configs import get_smoke_config
from repro_torch.models import LM
from repro_torch.models.lm import decode_logits

ARCHS = ("xlstm-1.3b", "zamba2-7b")
_RUNS = {}


def runs(arch):
    pytest.importorskip("jax")
    if arch not in _RUNS:
        _RUNS[arch] = arch_run(arch)
    return _RUNS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits(arch):
    r = runs(arch)
    assert_close(r["port"]["forward"], r["ref"]["forward"],
                 f32_bound(r["ref"]["forward"]), arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_layout(arch):
    r = runs(arch)
    assert r["port"]["init_cache"] == r["ref"]["init_cache"]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits(arch):
    r = runs(arch)
    assert_close(r["port"]["decode"], r["ref"]["decode"],
                 f32_bound(r["ref"]["decode"]), arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_final_state(arch):
    r = runs(arch)
    ref, port = r["ref"]["cache"], r["port"]["cache"]
    assert [p for p, _ in port] == [p for p, _ in ref]
    for (path, got), (_, want) in zip(port, ref):
        assert_close(got, want, f32_bound(want), f"{arch}{path}")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss(arch):
    r = runs(arch)
    assert_close(r["port"]["loss"], r["ref"]["loss"],
                 f32_bound(r["ref"]["loss"]), arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Float32: the chunked mLSTM/SSD and the sLSTM scan of ``forward``
    against the one-step recurrences of ``decode_step``."""
    import dataclasses
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = LM(cfg, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab, (2, 16)))
    full = model.forward(tokens).numpy()
    dec = decode_logits(model, tokens).numpy()
    assert_close(dec, full, 1e-3 * max(1.0, float(np.abs(full).max())), arch)


def test_zamba_shares_one_attention_block():
    cfg = get_smoke_config("zamba2-7b")
    model = LM(cfg, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert sum(n.startswith("shared_attn.") for n in names) == \
        len(dict(model.shared_attn.named_parameters()))
    assert len(model.mamba) == 6 and len(model.tail) == 1
    cache = model.init_cache(2, 8)
    assert cache["attn"].k.shape[0] == 2       # one K/V a unit
