"""Shared by the port's LM tests (``tests/test_torch_lm*.py``): run one
architecture through the reference (``repro.models.lm.LM``, JAX on the
CPU, jitted, no gradient) and through the port (``repro_torch.models.LM``
on the CPU) on the same weights — the reference's ``init(PRNGKey(0))``
carried across with ``load_reference_params`` — and the same inputs
(``np.random.default_rng``), and return both sides as numpy.

Imported as a sibling module (like ``_hypothesis_compat``); JAX is
imported only inside ``arch_run``, which the tests reach after
``pytest.importorskip("jax")``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

B, S, STEPS = 2, 16, 8
_F32_PARAMS = {}


def np_leaf(a) -> np.ndarray:
    """A JAX or torch array as numpy; bf16 as float32 (exact)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy() \
            if a.dtype == torch.bfloat16 else a.detach().cpu().numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def dtype_name(a) -> str:
    if isinstance(a, torch.Tensor):
        return str(a.dtype).removeprefix("torch.")
    return np.asarray(a).dtype.name


def flat(tree, path: str = ""):
    """(path, leaf) pairs of a cache: dict keys sorted (as ``jax.tree``
    orders them), tuples by field; ``None`` holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flat(tree[k], f"{path}/{k}")]
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or range(len(tree))
        return [kv for n, t in zip(names, tree) for kv in flat(t, f"{path}/{n}")]
    return [(path, tree)]


def layout(tree):
    """[(path, shape, dtype name)] of a cache's leaves."""
    return [(p, tuple(t.shape), dtype_name(t)) for p, t in flat(tree)]


def np_tree(tree):
    """A reference params pytree with numpy float32/int leaves."""
    import jax
    return jax.tree.map(np_leaf, tree)


def ref_params(ref_model):
    """``ref_model.init(PRNGKey(0))`` of the reference. The float32 draw is
    compiled once a config and kept; another dtype casts it leaf by leaf
    to the dtypes ``init`` gives (``jax.eval_shape``, no compile): every
    init draws in float32 and casts, so the bits are ``init``'s own."""
    import dataclasses as dc

    import jax
    cfg = ref_model.cfg
    f32 = dc.replace(cfg, dtype="float32")
    if f32 not in _F32_PARAMS:
        _F32_PARAMS[f32] = jax.jit(type(ref_model)(f32).init)(
            jax.random.PRNGKey(0))
    params = _F32_PARAMS[f32]
    if cfg.dtype == "float32":
        return params
    shapes = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
    return jax.tree.map(lambda a, s: a.astype(s.dtype), params, shapes)


def inputs(cfg, seed: int = 0):
    """tokens, labels (B, S) and the frontend stub's embeddings (vision:
    (B, n_frontend_tokens, d); audio frames: (B, S, d)), float32."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S))
    labels = rng.integers(0, cfg.vocab, (B, S))
    extra = None
    if cfg.frontend == "vision_stub":
        extra = rng.normal(size=(B, cfg.n_frontend_tokens, cfg.d_model))
    elif cfg.frontend == "audio_stub":
        extra = rng.normal(size=(B, S, cfg.d_model))
    if extra is not None:
        extra = extra.astype(np.float32)
    return tokens, labels, extra


def arch_run(arch: str, dtype: str = "float32", seed: int = 0) -> dict:
    """Both packages on one smoke config in ``dtype``: forward logits, the
    loss, ``init_cache``'s layout, ``STEPS`` teacher-forced decode steps'
    logits and the final cache (encdec: ``encode``'s output and cross K/V
    first). Returns {"ref": {...}, "port": {...}} of numpy values."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as ref_smoke
    from repro.models.lm import LM as RefLM
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import LM, load_reference_params

    cfg_r = dataclasses.replace(ref_smoke(arch), dtype=dtype)
    cfg_p = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    rm = RefLM(cfg_r)
    params = ref_params(rm)
    pm = LM(cfg_p, device="cpu")
    load_reference_params(pm, np_tree(params))

    tokens, labels, extra = inputs(cfg_p, seed)
    j = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
         "extra": None if extra is None else jnp.asarray(extra)}
    t = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels),
         "extra": None if extra is None else torch.from_numpy(extra)}
    ref, port = {}, {}
    fwd, loss = jax.jit(lambda p, b: (rm.forward(p, b["tokens"], b["extra"]),
                                      rm.loss(p, b)))(params, j)
    ref["forward"], ref["loss"] = np_leaf(fwd), np_leaf(loss)
    port["forward"] = np_leaf(pm.forward(t["tokens"], t["extra"]))
    port["loss"] = np_leaf(pm.loss(t))

    rc, pc = rm.init_cache(B, STEPS), pm.init_cache(B, STEPS)
    ref["init_cache"], port["init_cache"] = layout(rc), layout(pc)
    if cfg_p.block_pattern == "encdec":
        enc_r, rc["cross"] = jax.jit(rm.encode)(params, j["extra"])
        enc_p, pc["cross"] = pm.encode(t["extra"])
        ref["encode"] = [np_leaf(enc_r)] + [np_leaf(a) for a in rc["cross"]]
        port["encode"] = [np_leaf(enc_p)] + [np_leaf(a) for a in pc["cross"]]
    step = jax.jit(rm.decode_step)
    rl, pl = [], []
    for pos in range(STEPS):
        lg, rc = step(params, rc, j["tokens"][:, pos:pos + 1], jnp.int32(pos))
        rl.append(np_leaf(lg))
        lg, pc = pm.decode_step(pc, t["tokens"][:, pos:pos + 1], pos)
        pl.append(np_leaf(lg))
    ref["decode"], port["decode"] = np.concatenate(rl, 1), np.concatenate(pl, 1)
    ref["cache"] = [(p, np_leaf(a)) for p, a in flat(rc)]
    port["cache"] = [(p, np_leaf(a)) for p, a in flat(pc)]
    return {"ref": ref, "port": port, "cfg": cfg_p}


def f32_bound(want) -> float:
    """The float32 tolerance: 1e-4 x max(1, max|ref|)."""
    return 1e-4 * max(1.0, float(np.max(np.abs(want))))


def bf16_bound(want) -> float:
    """The reference's own bf16 tolerance (``tests/test_models.py``):
    max(0.01 x max|ref|, 0.25)."""
    return max(0.01 * float(np.max(np.abs(want))), 0.25)


def assert_close(got, want, bound: float, what: str = "") -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= bound, (what, err, bound)
