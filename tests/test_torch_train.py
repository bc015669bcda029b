"""Port: LM training (``repro_torch.launch.{steps,train}``, the grad path
through ``models.LM``, ``data.pipeline``, ``examples.train_lm``), held
against the reference.

With the reference's weights carried across (``load_reference_params``)
and the same inputs, for all ten smoke configs in float32: ``loss`` and
the gradient of every reference leaf (``models.convert.to_reference_tree``
stacks the port's per-layer gradients) against
``jax.value_and_grad(LM.loss)``, within 1e-4 x max(1, max|ref|); qwen2 also
in bf16 within the reference's bf16 tolerance. ``remat=True`` gives the
gradients of ``remat=False`` for every block pattern. Three steps of
``build_train_step`` equal the reference's train step composed from the
parts that run under the installed jax (``value_and_grad``, the clip, the
update; its ``launch.train.train`` and sharded step do not, ROADMAP H3)
for qwen2 (AdamW, with and without the int8 gradient round trip) and
llama4-maverick's smoke size with its own optimizer (Adafactor). The
token stream, the corpus and the bulk-bitwise admission equal the
reference's and numpy's; a run resumed from a checkpoint gives the
losses of an uninterrupted one; the CLI and the example train on the CPU;
the default device raises where there is no card.

``-m cuda`` (skipped without a card): three train steps of each smoke
config in float32 on the card against the CPU on the same weights.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _lm_parity import (assert_close, bf16_bound, f32_bound, flat, inputs,
                        np_leaf, np_tree, ref_params)
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs.common import ShapeConfig
from repro_torch.data.pipeline import (CorpusMeta, PimDataSelector,
                                       TokenBatcher, default_selection)
from repro_torch.launch import steps as steps_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import LM, load_reference_params
from repro_torch.models.convert import reference_params, to_reference_tree
from repro_torch.optim import optimizers as opt

ROOT = Path(__file__).resolve().parents[1]
PATTERNS = ("qwen2-0.5b", "olmoe-1b-7b", "gemma2-9b", "xlstm-1.3b",
            "zamba2-7b", "whisper-small")
N_STEPS = 3
_GRADS = {}


def _cfgs(arch, dtype="float32", **kw):
    from repro.configs import get_smoke_config as ref_smoke
    return (dataclasses.replace(ref_smoke(arch), dtype=dtype, **kw),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw))


def _batches(cfg, seed: int = 0):
    """(numpy batch, torch batch) of ``_lm_parity.inputs``."""
    tokens, labels, extra = inputs(cfg, seed)
    nb = {"tokens": tokens, "labels": labels, "extra": extra}
    return nb, {k: None if v is None else torch.from_numpy(v)
                for k, v in nb.items()}


def _jnp(batch):
    import jax.numpy as jnp
    return {k: None if v is None else jnp.asarray(v)
            for k, v in batch.items()}


def _port_model(cfg, params):
    pm = LM(cfg, device="cpu")
    load_reference_params(pm, np_tree(params))
    return pm


def _grads(model):
    return to_reference_tree(model, {n: p.grad for n, p in
                                     model.named_parameters()})


def grad_run(arch, dtype):
    """The loss and the gradients of both packages on one smoke config."""
    if (arch, dtype) not in _GRADS:
        import jax
        from repro.models.lm import LM as RefLM
        cfg_r, cfg_p = _cfgs(arch, dtype)
        rm = RefLM(cfg_r)
        params = ref_params(rm)
        nb, tb = _batches(cfg_p)
        loss_r, g_r = jax.jit(jax.value_and_grad(rm.loss))(params, _jnp(nb))
        pm = _port_model(cfg_p, params).requires_grad_(True)
        loss_p = pm.loss(tb)
        loss_p.backward()
        _GRADS[arch, dtype] = (
            (np_leaf(loss_r), [(p, np_leaf(a)) for p, a in flat(g_r)]),
            (np_leaf(loss_p), flat(_grads(pm))))
    return _GRADS[arch, dtype]


GRAD_CASES = [(a, "float32") for a in ARCH_IDS] + [("qwen2-0.5b",
                                                    "bfloat16")]


@pytest.mark.parametrize("arch,dtype", GRAD_CASES)
def test_loss_and_gradients_equal_reference(arch, dtype):
    pytest.importorskip("jax")
    (loss_r, g_r), (loss_p, g_p) = grad_run(arch, dtype)
    bound = f32_bound if dtype == "float32" else bf16_bound
    assert_close(loss_p, loss_r, bound(loss_r), f"{arch} loss")
    assert [p for p, _ in g_p] == [p for p, _ in g_r]
    for (path, got), (_, want) in zip(g_p, g_r):
        assert_close(got, want, bound(want), f"{arch} grad {path}")


@pytest.mark.parametrize("arch", PATTERNS)
def test_remat_gives_the_gradients_of_no_remat(arch):
    """Every block pattern's checkpointed bodies recompute the same
    activations: the gradients are bit for bit those without remat."""
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                                  remat=remat)
        pm = LM(cfg, device="cpu",
                generator=torch.Generator().manual_seed(0))
        pm.requires_grad_(True)
        loss = pm.loss(_batches(cfg)[1])
        loss.backward()
        out.append((loss.detach(), flat(_grads(pm))))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert [p for p, _ in g0] == [p for p, _ in g1]
    for (path, a), (_, b) in zip(g0, g1):
        np.testing.assert_array_equal(a, b, err_msg=f"{arch} {path}")


def _ref_steps(rm, cfg, params, batches, compression):
    """The reference's train step composed from its parts, as
    ``tests/test_models.py::test_arch_smoke`` composes it."""
    import jax
    from repro.distributed.compression import compress_tree
    from repro.optim import optimizers as ref_opt
    init_fn, update_fn = ref_opt.make_optimizer(cfg.optimizer)

    @jax.jit
    def step(params, state, batch):
        loss, grads = jax.value_and_grad(rm.loss)(params, batch)
        if compression:
            grads = compress_tree(grads)
        grads, gnorm = ref_opt.clip_by_global_norm(grads)
        params, state = update_fn(params, grads, state)
        return params, state, loss, gnorm

    state = init_fn(params)
    metrics = []
    for b in batches:
        params, state, loss, gnorm = step(params, state, _jnp(b))
        metrics.append((float(loss), float(gnorm)))
    return params, state, metrics


@pytest.mark.parametrize("arch,optimizer,compression", [
    ("qwen2-0.5b", "adamw", False), ("qwen2-0.5b", "adamw", True),
    ("llama4-maverick-400b-a17b", "adafactor", False)])
def test_train_steps_equal_composed_reference_step(arch, optimizer,
                                                   compression):
    """Three steps: the losses and grad norms within 1e-5 relative; every
    parameter leaf within 1e-3 of how far the reference moved it (max
    |p_3 - p_0|) plus one float32 step at its largest value (the final
    rounding), and with the int8 round trip so for all but 0.1 % of a
    leaf's elements, the rest within twice that distance; every
    optimizer-state leaf within 1e-4 x max(1, max|ref|)."""
    pytest.importorskip("jax")
    from repro.models.lm import LM as RefLM
    cfg_r, cfg_p = _cfgs(arch, optimizer=optimizer)
    rm = RefLM(cfg_r)
    params = ref_params(rm)
    shape = ShapeConfig("t", 16, 2, "train")
    batches = [_batches(cfg_p, seed)[0] for seed in range(N_STEPS)]
    r_params, r_state, r_metrics = _ref_steps(rm, cfg_r, params, batches,
                                              compression)

    pm = _port_model(cfg_p, params)
    step = steps_mod.build_train_step(cfg_p, shape, pm,
                                      grad_compression=compression)
    init_fn, _ = opt.make_optimizer(optimizer)
    state = init_fn(reference_params(pm))
    p_metrics = []
    for b in batches:
        state, m = step(state, steps_mod.to_device(b, "cpu"))
        p_metrics.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(p_metrics, r_metrics, rtol=1e-5)
    assert int(state.step) == N_STEPS

    r0 = dict(flat(np_tree(params)))
    got = flat(to_reference_tree(pm, dict(pm.named_parameters())))
    want = [(p, np_leaf(a)) for p, a in flat(r_params)]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        moved = float(np.abs(b - r0[path]).max())
        assert moved > 0 or not np.abs(a - r0[path]).any(), path
        ulp = float(np.spacing(np.float32(np.abs(b).max())))
        if not compression:
            assert_close(a, b, 1e-3 * moved + ulp, f"{arch} {path}")
            continue
        # An int8 code one apart at a rounding edge can change an
        # element's whole Adam step: rare, and never more than the steps.
        off = np.abs(a - b) > 1e-3 * moved + ulp
        assert off.mean() <= 1e-3, (path, off.mean())
        assert_close(a, b, 2 * moved + ulp, f"{arch} {path}")
    s_got = flat(tuple(state.inner))
    s_want = [(p, np_leaf(a)) for p, a in flat(tuple(r_state.inner))]
    assert [p for p, _ in s_got] == [p for p, _ in s_want]
    for (path, a), (_, b) in zip(s_got, s_want):
        assert_close(np_leaf(a), b, f32_bound(b), f"{arch} state {path}")


def test_prefill_serve_and_train_steps_by_shape_kind():
    """``build_step`` picks the step by ``shape.kind``: prefill is the
    model's forward with no graph, serve its decode step, train the
    train step."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              dtype="float32")
    pm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    nb, tb = _batches(cfg)
    prefill = steps_mod.build_step(cfg, ShapeConfig("p", 16, 2, "prefill"),
                                   pm)
    logits = prefill(tb["tokens"])
    assert not logits.requires_grad
    assert torch.equal(logits, pm.forward(tb["tokens"]))
    serve = steps_mod.build_step(cfg, ShapeConfig("d", 16, 2, "decode"), pm)
    got, cache = serve(pm.init_cache(2, 16), tb["tokens"][:, :1], 0)
    want, _ = pm.decode_step(pm.init_cache(2, 16), tb["tokens"][:, :1], 0)
    assert torch.equal(got, want) and cache.k.shape[0] == cfg.n_layers
    train = steps_mod.build_step(cfg, ShapeConfig("t", 16, 2, "train"), pm)
    state = opt.make_optimizer(cfg.optimizer)[0](reference_params(pm))
    state, m = train(state, steps_mod.to_device(nb, "cpu"))
    assert int(state.step) == 1 and np.isfinite(float(m["loss"]))
    assert all(p.grad is None for p in pm.parameters())


def test_token_batcher_equals_reference():
    pytest.importorskip("jax")
    from repro.data.pipeline import TokenBatcher as RefBatcher
    port, ref = TokenBatcher(100, 2, 8, seed=5), RefBatcher(100, 2, 8, seed=5)
    for _ in range(4):
        a, b = port.next_batch(), ref.next_batch()
        for k in ("tokens", "labels"):
            assert a[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
        assert a["extra"] is None and port.state() == ref.state()
    again = TokenBatcher(100, 2, 8, seed=5)
    again.load_state({"epoch": 0, "cursor": 2})
    want = RefBatcher(100, 2, 8, seed=5)
    want.load_state({"epoch": 0, "cursor": 2})
    np.testing.assert_array_equal(again.next_batch()["tokens"],
                                  want.next_batch()["tokens"])
    rolled = TokenBatcher(100, 2, 8, seed=5)
    rolled.load_state({"epoch": 0, "cursor": (1 << 16) - 1})
    rolled.next_batch()
    assert rolled.state() == {"epoch": 1, "cursor": 0}


def test_pim_data_selector_equals_reference_and_numpy():
    pytest.importorskip("jax")
    from repro.data.pipeline import CorpusMeta as RefMeta
    from repro.data.pipeline import PimDataSelector as RefSelector
    from repro_torch.db import queries
    meta = CorpusMeta.synthetic(5000, seed=1)
    ref_meta = RefMeta.synthetic(5000, seed=1)
    for col in ("length", "quality", "domain", "dedup_bucket"):
        np.testing.assert_array_equal(getattr(meta, col),
                                      getattr(ref_meta, col))
    sel = PimDataSelector(meta, device="cpu")
    assert sel.rel.planes["length"].device.type == "cpu"
    mask = sel.admit()
    cols = {"length": meta.length, "quality": meta.quality,
            "domain": meta.domain, "dedup_bucket": meta.dedup_bucket}
    np.testing.assert_array_equal(mask, RefSelector(ref_meta).admit())
    np.testing.assert_array_equal(mask,
                                  queries.eval_pred(cols, default_selection()))
    stats = sel.admission_stats()
    assert stats["n"] == int(mask.sum()) > 0


def test_train_resume_exactness(tmp_path):
    """Interrupted-and-resumed run == uninterrupted run (the port's
    counterpart of the reference's ``test_train_resume_exactness``)."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"), remat=False)
    shape = ShapeConfig("t", 32, 2, "train")
    kw = dict(log_every=0, use_pim_selector=False, device="cpu")
    _, _, losses_full = train_mod.train(cfg, shape, steps=6, ckpt_dir=None,
                                        **kw)
    d1 = tmp_path / "run1"
    train_mod.train(cfg, shape, steps=3, ckpt_dir=str(d1), ckpt_every=3,
                    **kw)
    history = []
    model, state, losses_resumed = train_mod.train(
        cfg, shape, steps=6, ckpt_dir=str(d1), ckpt_every=3, history=history,
        **kw)
    assert len(losses_resumed) == 3
    np.testing.assert_allclose(losses_full[3:], losses_resumed, rtol=2e-4)
    assert [h["step"] for h in history] == [4, 5, 6]
    assert int(state.step) == 6
    from repro_torch.checkpoint import checkpoint as ckpt
    assert ckpt.complete_steps(str(d1)) == [3, 6]


def test_train_cli_smoke_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "4"], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env={"PYTHONPATH": str(ROOT / "src"),
                                     "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "PIM selector admitted" in out.stdout


def test_example_trains_on_cpu(capsys):
    """The example's lm-12m config, 3 steps at batch 2 x 32 tokens (its
    own check: the last loss below the first; the CPU run is
    deterministic)."""
    from repro_torch.examples import train_lm
    out = train_lm.main(["--steps", "3", "--batch", "2", "--seq", "32",
                         "--device", "cpu"])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert "loss:" in capsys.readouterr().out


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from repro_torch.examples import train_lm
    cfg = get_smoke_config("qwen2-0.5b")
    shape = ShapeConfig("t", 16, 2, "train")
    for call in (lambda: train_mod.train(cfg, shape, steps=1),
                 lambda: PimDataSelector(CorpusMeta.synthetic(100)),
                 lambda: train_mod.main(["--smoke", "--steps", "1"]),
                 lambda: train_lm.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_steps_card_equal_cpu(arch):
    """Each smoke config in float32, three train steps on the card and on
    the CPU from the same weights and batches: losses and grad norms
    within 1e-4 relative, parameters within 1e-4 x max(1, max|p|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "false")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    shape = ShapeConfig("t", 16, 2, "train")
    sides = {}
    for dev in ("cuda", "cpu"):
        pm = LM(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        step = steps_mod.build_train_step(cfg, shape, pm)
        state = opt.make_optimizer(cfg.optimizer)[0](reference_params(pm))
        metrics = []
        for seed in range(N_STEPS):
            state, m = step(state, steps_mod.to_device(
                _batches(cfg, seed)[0], dev))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        sides[dev] = (metrics, {n: p.detach().cpu()
                                for n, p in pm.named_parameters()})
    np.testing.assert_allclose(sides["cuda"][0], sides["cpu"][0], rtol=1e-4)
    for name, want in sides["cpu"][1].items():
        got = sides["cuda"][1][name]
        bound = 1e-4 * max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= bound, name
