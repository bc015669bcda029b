"""Port: the sharding rules and the shard store
(``repro_torch.distributed.sharding``, ``launch.steps``' ``_fsdp_augment``,
``opt_state_shardings`` and ``make_sharder``), held against the reference.

Every spec the port computes equals the reference's, leaf by leaf, with
the reference's ``ShardingRules`` on a ``jax.sharding.AbstractMesh`` of
the same shape (no devices needed): ``param_spec`` after ``_fsdp_augment``
for every leaf of all ten full configs on the 16 x 16, 2 x 16 x 16 and
(2, 4) meshes, with the planned bytes a position equal to the sum of the
reference's ``NamedSharding.shard_shape`` bytes; ``opt_state_shardings``
for an AdamW and an Adafactor config; ``batch_spec``; ``cache_shardings``
at ``decode_32k`` and ``long_500k``. The sharder's spec for each kind
equals the one the reference's ``make_sharder`` passes to
``with_sharding_constraint`` (recorded by replacing ``jax`` in the
reference module's namespace for the test). ``shard_tensor``/``gather``
round-trip bit for bit, and a piece replicated outside its spec is held
once, on the position where those axes are 0.
"""
import math
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.core.distributed import make_mesh
from repro_torch.distributed import sharding as S
from repro_torch.distributed.sharded_steps import Sharder
from repro_torch.launch import input_specs, steps
from repro_torch.optim import optimizers as opt

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model"))]


def norm(spec):
    """A spec as a tuple of axis-name tuples (``'a'`` and ``('a',)``
    alike), trailing unsharded dims dropped."""
    out = [() if e is None else (e,) if isinstance(e, str) else tuple(e)
           for e in tuple(spec)]
    while out and out[-1] == ():
        out.pop()
    return tuple(out)


def ref_mesh(shape, axes):
    from jax.sharding import AbstractMesh
    return AbstractMesh(shape, axes)


def port_mesh(shape, axes):
    return make_mesh(shape, axes, device="cpu")


def ref_specs(tree):
    """{path: normalised spec} of a reference tree of NamedShardings."""
    import jax
    out = {}
    for path, ns in jax.tree.leaves_with_path(tree):
        key = "/".join(str(getattr(k, "key", getattr(k, "name", getattr(
            k, "idx", k)))) for k in path)
        out[key] = norm(ns.spec)
    return out


def port_specs(tree):
    return {path: norm(ns.spec) for path, ns in S.tree_items(tree)}


@pytest.mark.parametrize("shape,axes", MESHES, ids=["16x16", "2x16x16", "2x4"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_and_planned_bytes_equal_reference(arch, shape, axes):
    pytest.importorskip("jax")
    from repro.configs import get_config as ref_config
    from repro.distributed.sharding import ShardingRules as RefRules
    from repro.launch import input_specs as ref_ispec
    from repro.launch import steps as ref_steps
    import jax
    rr = RefRules(ref_mesh(shape, axes), ref_config(arch))
    r_struct = ref_ispec.params_struct(ref_config(arch))
    r_shard = ref_steps._fsdp_augment(rr, rr.params_shardings(r_struct),
                                      r_struct)
    pr = S.ShardingRules(port_mesh(shape, axes), get_config(arch))
    p_struct = input_specs.params_struct(get_config(arch))
    p_shard = steps._fsdp_augment(pr, pr.params_shardings(p_struct),
                                  p_struct)
    assert port_specs(p_shard) == ref_specs(r_shard)

    want = sum(math.prod(ns.shard_shape(a.shape)) * a.dtype.itemsize
               for ns, a in zip(jax.tree.leaves(r_shard),
                                jax.tree.leaves(r_struct)))
    got = sum(ns.planned_bytes(t.shape, t.dtype) for (_, ns), (_, t) in
              zip(S.tree_items(p_shard), S.tree_items(p_struct)))
    assert got == want


@pytest.mark.parametrize("shape,axes", MESHES, ids=["16x16", "2x16x16", "2x4"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama4-maverick-400b-a17b"])
def test_opt_state_shardings_equal_reference(arch, shape, axes):
    """qwen2-0.5b's AdamW moments and llama4-maverick's Adafactor
    factors (``vr`` drops the last dim, ``vc`` the one before)."""
    pytest.importorskip("jax")
    import jax
    from repro.configs import get_config as ref_config
    from repro.distributed.sharding import ShardingRules as RefRules
    from repro.launch import input_specs as ref_ispec
    from repro.launch import steps as ref_steps
    from repro.optim import optimizers as ref_opt
    cfg_r = ref_config(arch)
    rr = RefRules(ref_mesh(shape, axes), cfg_r)
    r_struct = ref_ispec.params_struct(cfg_r)
    r_shard = ref_steps._fsdp_augment(rr, rr.params_shardings(r_struct),
                                      r_struct)
    r_init, _ = ref_opt.make_optimizer(cfg_r.optimizer)
    r_opt = ref_steps.opt_state_shardings(rr, r_shard,
                                          jax.eval_shape(r_init, r_struct))

    cfg = get_config(arch)
    pr = S.ShardingRules(port_mesh(shape, axes), cfg)
    p_struct = input_specs.params_struct(cfg)
    p_shard = steps._fsdp_augment(pr, pr.params_shardings(p_struct),
                                  p_struct)
    p_init, _ = opt.make_optimizer(cfg.optimizer)
    p_opt = steps.opt_state_shardings(pr, p_shard, p_init(p_struct))
    assert cfg.optimizer == ("adafactor" if "llama4" in arch else "adamw")
    assert port_specs(p_opt) == ref_specs(r_opt)


def test_batch_spec_equals_reference():
    pytest.importorskip("jax")
    from repro.configs import get_config as ref_config
    from repro.distributed.sharding import ShardingRules as RefRules
    for shape, axes in MESHES:
        rr = RefRules(ref_mesh(shape, axes), ref_config("qwen2-0.5b"))
        pr = S.ShardingRules(port_mesh(shape, axes), get_config("qwen2-0.5b"))
        for batch in (1, 2, 3, 8, 16, 32, 128, 256):
            for rank in (2, 3):
                assert norm(pr.batch_spec(batch, rank)) == \
                    norm(rr.batch_spec(batch, rank)), (shape, batch, rank)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shardings_equal_reference(arch):
    """Every cache leaf's spec at ``decode_32k`` and ``long_500k``, on the
    three meshes (the K/V rule and the recurrent states' rule)."""
    pytest.importorskip("jax")
    from repro.configs import get_config as ref_config
    from repro.distributed.sharding import ShardingRules as RefRules
    from repro.launch import input_specs as ref_ispec
    for shape_name in ("decode_32k", "long_500k"):
        cache_r = ref_ispec.decode_input_specs(ref_config(arch),
                                               SHAPES[shape_name])[0]
        cache_p = input_specs.decode_input_specs(get_config(arch),
                                                 SHAPES[shape_name])[0]
        for shape, axes in MESHES:
            rr = RefRules(ref_mesh(shape, axes), ref_config(arch))
            pr = S.ShardingRules(port_mesh(shape, axes), get_config(arch))
            got = port_specs(pr.cache_shardings(cache_p))
            want = ref_specs(rr.cache_shardings(cache_r))
            assert got == want, (shape_name, shape)


SHARDER_SHAPES = {
    "hidden": [(8, 16, 64), (3, 16, 64), (256, 4096, 896)],
    "logits": [(8, 16, 512), (3, 16, 512), (32, 128, 151936)],
    "attn_heads": [(8, 16, 16, 64), (3, 16, 14, 64)],
    "moe_group": [(16, 8, 64), (6, 8, 64), (512, 16, 64)],
    "moe_buf": [(8, 8, 4, 64), (3, 8, 4, 64), (512, 128, 4, 64)],
    "moe_buf3": [(8, 32, 64), (3, 32, 64)],
    "other": [(8, 16)],
}


@pytest.mark.parametrize("arch,moe_ep", [
    ("olmoe-1b-7b", True), ("olmoe-1b-7b", False),
    ("llama4-maverick-400b-a17b", True), ("qwen2-0.5b", True)])
def test_sharder_specs_equal_reference(arch, moe_ep, monkeypatch):
    """The spec the port's sharder records for each kind equals the one
    the reference's ``make_sharder`` constrains to (``None`` where the
    reference leaves the activation unconstrained)."""
    pytest.importorskip("jax")
    import dataclasses

    import jax
    from repro.configs import get_config as ref_config
    from repro.distributed.sharding import ShardingRules as RefRules
    from repro.launch import steps as ref_steps
    got_ref = []
    stub = types.SimpleNamespace(lax=types.SimpleNamespace(
        with_sharding_constraint=lambda x, s: got_ref.append(s.spec) or x))
    monkeypatch.setattr(ref_steps, "jax", stub)
    cfg_r = dataclasses.replace(ref_config(arch), moe_ep=moe_ep)
    cfg_p = dataclasses.replace(get_config(arch), moe_ep=moe_ep)
    for shape, axes in MESHES:
        ref_sharder = ref_steps.make_sharder(
            RefRules(ref_mesh(shape, axes), cfg_r), cfg_r)
        port = steps.make_sharder(S.ShardingRules(port_mesh(shape, axes),
                                                  cfg_p), cfg_p)
        assert isinstance(port, Sharder)
        for kind, shapes in SHARDER_SHAPES.items():
            for sh in shapes:
                got_ref.clear()
                x = jax.ShapeDtypeStruct(sh, "float32")
                assert ref_sharder(x, kind) is x
                want = norm(got_ref[0]) if got_ref else None
                t = torch.empty(sh, device="meta")
                assert port(t, kind) is t
                got = port.last_specs[kind]
                assert (None if got is None else norm(got)) == want, \
                    (shape, kind, sh)


@pytest.mark.parametrize("spec,n_pieces", [
    (S.P(None, "model"), 4), (S.P("data", None), 2),
    (S.P(("data", "model"), None), 8), (S.P(), 1),
    (S.P(None, ("model", "data")), 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_shard_gather_roundtrip_and_held_once(spec, n_pieces, dtype):
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    ns = S.NamedSharding(mesh, spec)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((16, 24)).astype(np.float32))
    x = (x * 1000).to(dtype)
    st = S.shard_tensor(x, ns)
    assert len(st.pieces) == n_pieces
    used = set(ns.axes_used())
    for p in st.pieces:
        coords = S.coords_of(mesh, p.position)
        assert all(coords[a] == 0 for a in mesh.axis_names if a not in used)
        assert tuple(p.data.shape) == ns.shard_shape(x.shape)
        assert p.data.untyped_storage().data_ptr() != \
            x.untyped_storage().data_ptr()
    assert len({p.position for p in st.pieces}) == n_pieces
    back = S.gather(st)
    assert back.dtype == x.dtype and torch.equal(back, x)
    store = S.ShardStore(mesh)
    assert store.resident_bytes({"x": st}) == {
        torch.device("cpu"): x.numel() * x.element_size()}
    assert ns.planned_bytes(x.shape, dtype) * n_pieces == \
        x.numel() * x.element_size()


def test_store_counts_moves_between_positions():
    """A gather onto a position moves every piece held elsewhere; a
    scatter-add of a whole leaf back moves the same bytes."""
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    store = S.ShardStore(mesh)
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    st = store.shard(x, S.NamedSharding(mesh, S.P("data", "model")))
    full = store.gather(st, position=0)
    assert torch.equal(full, x)
    assert store.moved["all-gather"] == 7 * 8 * 4
    zero = store.like(st, torch.zeros_like)
    store.scatter_add(zero, full, src=0)
    assert torch.equal(store.gather(zero), x)
    assert store.moved["reduce-scatter"] == 7 * 8 * 4
    # position 0 received 7 pieces in each of the two gathers and sent 7
    # in the scatter; none crossed an 8-card node (the mesh is 8
    # positions)
    assert store.busiest() == {("all-gather", False): 2 * 7 * 8 * 4,
                               ("reduce-scatter", False): 7 * 8 * 4}
