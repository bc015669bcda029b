"""Port: the optimizers, the schedule, the global-norm clip
(``repro_torch.optim``) and the int8 gradient compression
(``repro_torch.distributed.compression``), held against the reference.

Inputs are drawn with numpy from a seed and go through both packages.
The trees are in the reference's layout: a stacked ``(L, d)`` norm scale,
a stacked ``(L, d, f)`` matrix and a 1-D bias. Over 5 AdamW and 5
Adafactor updates the parameters and every state leaf equal the
reference's within 1e-6 relative in float32 and one bf16 step in bf16.
The same updates applied layer by layer (one ``(d,)`` and one ``(d, f)``
leaf a layer, as the port's modules hold them) give other numbers:
AdamW would not decay the norm scale, Adafactor would not factor it and
would clip each layer's RMS on its own. The int8 codes and scales equal
the reference's exactly and the error-feedback residual is exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.distributed import compression as C
from repro_torch.optim import optimizers as opt

L_, D, F = 3, 8, 6
STEPS = 5


def _tree(rng):
    return {"blocks": {"norm": {"scale": rng.normal(size=(L_, D))},
                       "mlp": {"w": rng.normal(size=(L_, D, F))}},
            "bias": rng.normal(size=(D,))}


def _np_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _np_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _to_torch(tree, dtype):
    return _np_map(lambda a: torch.tensor(a, dtype=torch.float32).to(dtype),
                   tree)


def _to_jax(tree, dtype):
    import jax.numpy as jnp
    return _np_map(lambda a: jnp.asarray(a, jnp.float32).astype(dtype), tree)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flat(tree[k],
                                                         f"{path}/{k}")]
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or range(len(tree))
        return [kv for n, t in zip(names, tree)
                for kv in _flat(t, f"{path}/{n}")]
    return [(path, _np(tree))]


def _assert_trees(got, want, rel, what):
    g, w = _flat(got), _flat(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        assert a.shape == b.shape, (what, path, a.shape, b.shape)
        bound = rel * np.maximum(np.abs(b), 1e-30)
        bad = np.abs(a - b) > bound
        assert not bad.any(), (what, path, float(np.abs(a - b).max()))


def _run_both(kind, dtype_name):
    """STEPS updates of ``kind`` through both packages from the same
    parameters and gradients; returns ((params, state) port, reference)."""
    import jax.numpy as jnp
    from repro.optim import optimizers as ref
    rng = np.random.default_rng(3)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(STEPS)]
    tdt = torch.float32 if dtype_name == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    kw = dict(peak_lr=1e-2, warmup=2, total=8)
    p_init, p_upd = opt.make_optimizer(kind, **kw)
    r_init, r_upd = ref.make_optimizer(kind, **kw)
    pp, rp = _to_torch(params, tdt), _to_jax(params, jdt)
    ps, rs = p_init(pp), r_init(rp)
    for g in grads:
        pp, ps = p_upd(pp, _to_torch(g, tdt), ps)
        rp, rs = r_upd(rp, _to_jax(g, jdt), rs)
    return (pp, ps), (rp, rs)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_updates_on_reference_leaves_equal_reference(kind, dtype):
    pytest.importorskip("jax")
    (pp, ps), (rp, rs) = _run_both(kind, dtype)
    rel = 1e-6 if dtype == "float32" else 2.0 ** -7
    _assert_trees(pp, rp, rel, f"{kind} {dtype} params")
    assert int(ps.step) == int(rs.step) == STEPS
    _assert_trees(tuple(ps.inner), tuple(rs.inner), rel,
                  f"{kind} {dtype} state")
    for (path, a), (_, b) in zip(_flat(tuple(ps.inner)),
                                 _flat(tuple(rs.inner))):
        assert a.dtype == b.dtype, path
    if kind == "adafactor":
        # the stacked (L, d) norm scale is factored: vr (L,), vc (d,), bf16
        assert ps.inner.vr["blocks"]["norm"]["scale"].shape == (L_,)
        assert ps.inner.vc["blocks"]["norm"]["scale"].shape == (D,)
        assert ps.inner.vr["blocks"]["norm"]["scale"].dtype == torch.bfloat16


def _per_layer(tree):
    """The stacked groups split into one leaf a layer (the port modules'
    own layout)."""
    return {"blocks": {str(i): {"norm": {"scale": tree["blocks"]["norm"]
                                         ["scale"][i]},
                                "mlp": {"w": tree["blocks"]["mlp"]["w"][i]}}
                       for i in range(L_)},
            "bias": tree["bias"]}


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_layer_by_layer_leaves_would_compute_something_else(kind):
    """The trap the reference leaves avoid: per-layer leaves change
    AdamW's decay of the norm scale (ndim 1 instead of 2), and Adafactor's
    factoring and RMS clip of both stacked groups."""
    pytest.importorskip("jax")
    (pp, _), (rp, _) = _run_both(kind, "float32")
    rng = np.random.default_rng(3)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(STEPS)]
    init, upd = opt.make_optimizer(kind, peak_lr=1e-2, warmup=2, total=8)
    lp = _per_layer(_to_torch(params, torch.float32))
    ls = init(lp)
    for g in grads:
        lp, ls = upd(lp, _per_layer(_to_torch(g, torch.float32)), ls)
    scale = np.stack([_np(lp["blocks"][str(i)]["norm"]["scale"])
                      for i in range(L_)])
    want = _np(rp["blocks"]["norm"]["scale"])
    np.testing.assert_allclose(_np(pp["blocks"]["norm"]["scale"]), want,
                               rtol=1e-6)
    assert np.abs(scale - want).max() > 1e-4
    if kind == "adafactor":
        w = np.stack([_np(lp["blocks"][str(i)]["mlp"]["w"])
                      for i in range(L_)])
        assert np.abs(w - _np(rp["blocks"]["mlp"]["w"])).max() > 1e-6
    np.testing.assert_allclose(_np(lp["bias"]), _np(rp["bias"]), rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 100, 5050, 10000])
def test_wsd_schedule_equals_reference(step):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.optim import optimizers as ref
    got = opt.wsd_schedule(3e-4)(torch.tensor(step, dtype=torch.int32))
    want = ref.wsd_schedule(3e-4)(jnp.int32(step))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-7)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_equals_reference(max_norm):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.optim import optimizers as ref
    tree = _tree(np.random.default_rng(5))
    pt = _to_torch(tree, torch.float32)
    pt["bias"] = pt["bias"].to(torch.bfloat16)
    jt = _to_jax(tree, jnp.float32)
    jt["bias"] = jt["bias"].astype(jnp.bfloat16)
    (got, gn), (want, wn) = (opt.clip_by_global_norm(pt, max_norm),
                             ref.clip_by_global_norm(jt, max_norm))
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    assert got["bias"].dtype == torch.bfloat16
    _assert_trees(got, want, 1e-6 if max_norm > 1 else 2.0 ** -7,
                  "clipped")


def test_optimizers_descend():
    """The reference's ``test_optimizers_descend``, through the port."""
    def loss_fn(p):
        return torch.sum((p["w"] - 3.0) ** 2)
    for kind in ("adamw", "adafactor"):
        init, update = opt.make_optimizer(kind, peak_lr=0.1, warmup=1)
        params = {"w": torch.zeros((4, 4))}
        state = init(params)
        l0 = float(loss_fn(params))
        for _ in range(50):
            w = params["w"].clone().requires_grad_(True)
            (g,) = torch.autograd.grad(loss_fn({"w": w}), [w])
            params, state = update(params, {"w": g}, state)
        assert float(loss_fn(params)) < l0 * 0.5, kind


def test_grad_clip():
    """The reference's ``test_grad_clip``, through the port."""
    g = {"a": torch.full((10,), 100.0)}
    clipped, norm = opt.clip_by_global_norm(g, max_norm=1.0)
    total = torch.sqrt(sum(torch.sum(x.float() ** 2)
                           for x in opt.tree_leaves(clipped)))
    assert float(total) <= 1.01
    assert float(norm) > 100


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compression_equals_reference(dtype):
    """int8 codes and scales equal the reference's exactly; the round trip
    and the error-feedback pair too, and the residual carries exactly the
    quantisation error of grads + residual."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.distributed import compression as RC
    rng = np.random.default_rng(0)
    g = rng.normal(size=(64, 64)).astype(np.float32)
    r = (rng.normal(size=(64, 64)) * 1e-3).astype(np.float32)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    pg, jg = torch.tensor(g).to(tdt), jnp.asarray(g).astype(jdt)
    q, s = C.quantize_leaf(pg)
    rq, rs = RC.quantize_leaf(jg)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    np.testing.assert_array_equal(_np(C.compress_tree({"w": pg})["w"]),
                                  _np(RC.compress_tree({"w": jg})["w"]))
    got_g, got_r = C.compress_with_feedback({"w": pg},
                                            {"w": torch.tensor(r)})
    want_g, want_r = RC.compress_with_feedback({"w": jg},
                                               {"w": jnp.asarray(r)})
    np.testing.assert_array_equal(_np(got_g["w"]), _np(want_g["w"]))
    np.testing.assert_array_equal(_np(got_r["w"]), _np(want_r["w"]))
    acc = pg.float() + torch.tensor(r)
    np.testing.assert_array_equal(
        (acc - C.dequantize_leaf(*C.quantize_leaf(acc))).numpy(),
        got_r["w"].numpy())
    res0 = C.init_residual({"w": pg})["w"]
    assert res0.dtype == torch.float32 and not res0.any()
