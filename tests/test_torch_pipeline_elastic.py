"""Port: pipeline stages, elastic restore and the meshes
(``repro_torch.distributed.pipeline_parallel``, ``launch.elastic``,
``launch.mesh``, ``checkpoint.restore(..., shardings=)``), held against
the reference.

``pipeline_apply`` over 4 stages and 8 microbatches equals the direct
composition, and equals the reference's ``pipeline_apply`` (run on 4
forced CPU devices in a subprocess, ``tests/_mesh_subprocess.py``) on the
same numpy inputs within 1e-5. A checkpoint of a run on the (2, 4) mesh
restored with ``remesh_and_restore(..., n_surviving=4,
model_parallel=2)`` gives every leaf bit for bit, cut by the new mesh's
plan, and 2 further steps there give the losses of an uninterrupted
4-step run. ``make_mesh_for_devices``' shapes equal the reference's for
n in {1, 2, 4, 8, 12, 48, 256, 512} (one forced-512-device subprocess),
and the production and debug meshes have the reference's shapes and axis
names.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from _mesh_subprocess import run_forced_multidevice
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.configs.common import ShapeConfig
from repro_torch.data.pipeline import TokenBatcher
from repro_torch.distributed import sharding as S
from repro_torch.distributed.pipeline_parallel import (bubble_fraction,
                                                       pipeline_apply)
from repro_torch.launch import input_specs
from repro_torch.launch import steps as steps_mod
from repro_torch.launch import train as train_mod
from repro_torch.launch.elastic import remesh_and_restore
from repro_torch.launch.mesh import (make_debug_mesh, make_mesh_for_devices,
                                     make_production_mesh)
from repro_torch.optim import optimizers as opt

N_STAGES, N_MICRO, MB, D = 4, 8, 2, 16


def _stage(w, x):
    return torch.tanh(x @ w["w"])


def test_pipeline_apply_equals_direct_and_reference(tmp_path):
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((N_STAGES, D, D)) / np.sqrt(D)).astype(
        np.float32)
    xs = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    got = pipeline_apply(make_debug_mesh(1, N_STAGES, device="cpu"), _stage,
                         {"w": torch.from_numpy(ws)}, torch.from_numpy(xs))
    y = torch.from_numpy(xs)
    for s in range(N_STAGES):
        y = torch.tanh(y @ torch.from_numpy(ws[s]))
    assert float((got - y).abs().max()) <= 1e-6
    assert bubble_fraction(N_STAGES, N_MICRO) == 3 / 11

    pytest.importorskip("jax")
    np.save(tmp_path / "ws.npy", ws)
    np.save(tmp_path / "xs.npy", xs)
    run_forced_multidevice(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.distributed.pipeline_parallel import pipeline_apply
        mesh = jax.make_mesh((1, {N_STAGES}), ("data", "model"))
        ws = jnp.asarray(np.load(r"{tmp_path}/ws.npy"))
        xs = jnp.asarray(np.load(r"{tmp_path}/xs.npy"))
        out = pipeline_apply(mesh, lambda w, x: jnp.tanh(x @ w["w"]),
                             {{"w": ws}}, xs)
        np.save(r"{tmp_path}/ref.npy", np.asarray(out))
    """, devices=N_STAGES, timeout=300)
    ref = np.load(tmp_path / "ref.npy")
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_mesh_shapes_equal_reference():
    pytest.importorskip("jax")
    ns = (1, 2, 4, 8, 12, 48, 256, 512)
    out = run_forced_multidevice(f"""
        import json
        from repro.launch.mesh import (make_debug_mesh, make_mesh_for_devices,
                                       make_production_mesh)
        meshes = [make_mesh_for_devices(n) for n in {ns}]
        meshes += [make_mesh_for_devices(4, model_parallel=2),
                   make_mesh_for_devices(12, model_parallel=8),
                   make_production_mesh(), make_production_mesh(multi_pod=True),
                   make_debug_mesh(2, 4)]
        print("SHAPES", json.dumps([[list(m.shape.values()), list(m.axis_names)]
                                    for m in meshes]))
    """, devices=512, timeout=300)
    want = json.loads(out.split("SHAPES", 1)[1])
    got = [make_mesh_for_devices(n, device="cpu") for n in ns]
    got += [make_mesh_for_devices(4, 2, device="cpu"),
            make_mesh_for_devices(12, 8, device="cpu"),
            make_production_mesh(device="cpu"),
            make_production_mesh(multi_pod=True, device="cpu"),
            make_debug_mesh(2, 4, device="cpu")]
    assert [[list(m.shape), list(m.axis_names)] for m in got] == want


def test_elastic_restore_bit_for_bit_and_resumed_losses(tmp_path):
    """Lose half the mesh: a run saved after 2 steps on (2, 4) comes back
    on the (2, 2) mesh of 4 survivors, every leaf bit for bit, and steps
    3 and 4 there give the uninterrupted run's losses."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              dtype="float32", remat=False)
    shape = ShapeConfig("t", 16, 4, "train")
    kw = dict(log_every=0, use_pim_selector=False,
              mesh=make_debug_mesh(2, 4, device="cpu"))
    _, _, full = train_mod.train(cfg, shape, steps=4, **kw)
    params, state, _ = train_mod.train(cfg, shape, steps=2,
                                       ckpt_dir=str(tmp_path), ckpt_every=2,
                                       **kw)
    assert ckpt.complete_steps(str(tmp_path)) == [2]

    p_struct = input_specs.params_struct(cfg)
    o_struct = opt.make_optimizer(cfg.optimizer)[0](p_struct)
    step, p2, o2, mesh = remesh_and_restore(
        str(tmp_path), cfg, shape, n_surviving=4, example_params=p_struct,
        example_opt=o_struct, model_parallel=2, device="cpu")
    assert step == 2 and mesh.shape == (2, 2)
    saved = {"params": params, "opt": state}
    back = {"params": p2, "opt": o2}
    for (path, a), (_, b) in zip(S.tree_items(back), S.tree_items(saved)):
        assert a.sharding.mesh == mesh, path
        assert len(a.pieces) == len(a.sharding.pieces(a.shape))
        x, y = S.gather(a), S.gather(b)
        assert x.dtype == y.dtype and torch.equal(x, y), path

    fn = steps_mod.build_train_step(cfg, shape, mesh=mesh).fn
    batcher = TokenBatcher(cfg.vocab, shape.global_batch, shape.seq_len, None)
    batcher.cursor = 2
    losses = []
    for _ in range(2):
        batch = steps_mod.to_device(batcher.next_batch(), "cpu")
        p2, o2, m = fn(p2, o2, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, full[2:], rtol=1e-5)
