"""Shared by the port's mesh tests (``tests/test_torch_mesh_*.py``):
the (2, 4) CPU mesh, the smoke configs' batches (``_lm_parity.inputs``),
train steps on one device, on a mesh (parameters and optimizer state as
pieces) and the reference's train step composed from its parts (its own
sharded step does not run under the installed jax, ROADMAP H3), and the
tree comparison within ``rel`` x max(1, max|want|).
"""
import numpy as np
import torch

from _lm_parity import flat, inputs, np_tree
from repro_torch.configs.common import ShapeConfig
from repro_torch.distributed import sharding as S
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import LM, load_reference_params
from repro_torch.models.convert import reference_params, to_reference_tree
from repro_torch.optim import optimizers as opt

N_STEPS = 3
SHAPE = ShapeConfig("t", 16, 2, "train")


def cpu_mesh(data=2, model=4):
    return make_debug_mesh(data, model, device="cpu")


def batches_of(cfg, n=N_STEPS):
    out = []
    for seed in range(n):
        tokens, labels, extra = inputs(cfg, seed)
        out.append({"tokens": tokens, "labels": labels, "extra": extra})
    return out


def to_torch(b):
    return {k: None if v is None else torch.from_numpy(np.asarray(v))
            for k, v in b.items()}


def single_steps(cfg, model, batches, shape=SHAPE):
    step = steps_mod.build_train_step(cfg, shape, model)
    state = opt.make_optimizer(cfg.optimizer)[0](reference_params(model))
    out = []
    for b in batches:
        state, m = step(state, to_torch(b))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, to_reference_tree(model, dict(model.named_parameters()))


def mesh_steps(cfg, model, batches, mesh, shape=SHAPE):
    step = steps_mod.build_train_step(cfg, shape, mesh=mesh).fn
    params = step.mm.shard_model(model)
    state = step.init_opt()
    out = []
    for b in batches:
        params, state, m = step(params, state, to_torch(b))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    full = S.tree_map(lambda t: t.detach().cpu().numpy(),
                      step.mm.gather_tree(params))
    return out, full, step, state


def ref_steps(cfg_r, params, batches):
    """The reference's train step composed from its parts (as
    ``tests/test_models.py::test_arch_smoke`` composes it)."""
    import jax
    import jax.numpy as jnp

    from repro.models.lm import LM as RefLM
    from repro.optim import optimizers as ref_opt
    rm = RefLM(cfg_r)
    init_fn, update_fn = ref_opt.make_optimizer(cfg_r.optimizer)

    @jax.jit
    def step(params, state, batch):
        loss, grads = jax.value_and_grad(rm.loss)(params, batch)
        grads, gnorm = ref_opt.clip_by_global_norm(grads)
        params, state = update_fn(params, grads, state)
        return params, state, loss, gnorm

    state = init_fn(params)
    out = []
    for b in batches:
        jb = {k: None if v is None else jnp.asarray(v) for k, v in b.items()}
        params, state, loss, gnorm = step(params, state, jb)
        out.append((float(loss), float(gnorm)))
    return out, params


def port_model(cfg, params):
    pm = LM(cfg, device="cpu")
    load_reference_params(pm, np_tree(params))
    return pm


def assert_trees_close(got: dict, want: dict, rel: float, what: str):
    g, w = flat(got), flat(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        bound = rel * max(1.0, float(np.abs(b).max()))
        assert float(np.abs(a - b).max()) <= bound, (what, path)
