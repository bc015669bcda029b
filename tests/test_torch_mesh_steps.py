"""Port: the train, serve and prefill steps on a mesh
(``repro_torch.launch.steps.build_*_step(..., mesh=)``,
``distributed.sharded_steps``, ``launch.train.train(mesh=)``,
``launch.serve.serve(mesh=)``), held against the port's single-device
steps and the reference.

(``tests/test_torch_mesh_reference.py`` holds 3 train steps of all ten
smoke configs on the (2, 4) mesh against the single-device step and the
reference's.) Greedy serving on the mesh gives the
single-device tokens exactly, with caches cut along the sequence at T
16,384 (over ``model``, and over dp + ``model`` where the batch does not
divide). The counterparts of the reference's
``test_{train,serve}_step_shards_on_debug_mesh`` (olmoe at
``ShapeConfig("t", 32, 8, "train")``, gemma2 at ``ShapeConfig("d", 64, 8,
"decode")``) and ``test_train_resume_exactness`` run on the mesh. fsdp
landing on a stacked leaf's layer dim, Adafactor's factored moments over
sharded dims, the admission that refuses ``train_4k`` on a 16 x 16 mesh
of one card before anything is allocated, ROADMAP C12 (weights gathered
at use, expert stacks and sequence-cut caches computed piece by piece),
and the default device raising without a card.

``-m cuda`` (skipped without a card): the sharded train and serve steps
on a (2, 4) mesh of the card against the CPU mesh.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _mesh_parity import (SHAPE, assert_trees_close, batches_of, cpu_mesh,
                          mesh_steps, single_steps, to_torch)
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro_torch.configs.common import ShapeConfig
from repro_torch.distributed import sharding as S
from repro_torch.distributed import sharded_steps as ss
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import LM
from repro_torch.models import attention as A
from repro_torch.models.convert import reference_params, to_reference_tree
from repro_torch.optim import optimizers as opt

@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "zamba2-7b"])
def test_mesh_adafactor_equals_single_device(arch):
    """Adafactor on pieces: the row and column means of g^2, ``vr``'s row
    mean and the update's RMS are reduced over the pieces of a sharded
    dim; the parameters and both factors equal the single-device
    update's."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              optimizer="adafactor")
    gen = torch.Generator().manual_seed(0)
    base = LM(cfg, device="cpu", generator=gen)
    batches = batches_of(cfg)

    def copy():
        m = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
        m.load_state_dict(base.state_dict())
        return m
    single_model = copy()
    step1 = steps_mod.build_train_step(cfg, SHAPE, single_model)
    state1 = opt.make_optimizer("adafactor")[0](reference_params(single_model))
    single = []
    for b in batches:
        state1, m = step1(state1, to_torch(b))
        single.append((float(m["loss"]), float(m["grad_norm"])))
    mesh, p_mesh, step, state = mesh_steps(cfg, copy(), batches, cpu_mesh())
    assert any(len(st.pieces) > 1 for _, st in S.tree_items(state.inner.vr))
    np.testing.assert_allclose(mesh, single, rtol=1e-5)
    got = S.tree_map(lambda t: t.detach().float().numpy(), {
        "vr": step.mm.gather_tree(state.inner.vr),
        "vc": step.mm.gather_tree(state.inner.vc)})
    want = S.tree_map(lambda t: t.detach().float().numpy(),
                      {"vr": state1.inner.vr, "vc": state1.inner.vc})
    assert_trees_close(got, want, 1e-5, f"{arch} factors")
    assert_trees_close(p_mesh, to_reference_tree(
        single_model, dict(single_model.named_parameters())), 1e-5, arch)


def test_fsdp_on_the_layer_dim_of_a_stacked_leaf():
    """A config whose big leaves divide over the dp size only along the
    layer dim: ``_fsdp_augment`` puts 'data' there, each piece holds some
    layers of the stack, and 3 steps equal the single-device ones."""
    cfg = dataclasses.replace(
        get_smoke_config("qwen2-0.5b"), dtype="float32", fsdp=True,
        d_model=33, n_heads=3, n_kv_heads=1, d_head=12, d_ff=8192,
        n_layers=4)
    mm = ss.MeshModel(cfg, cpu_mesh())
    spec = mm.sharding(("blocks", "mlp", "w_gate")).spec
    assert spec[0] == "data" and spec[2] == "model"
    assert mm.sharding(("blocks", "mlp", "w_down")).spec[0] == "data"
    base = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    batches = batches_of(cfg)

    def copy():
        m = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
        m.load_state_dict(base.state_dict())
        return m
    single, p_single = single_steps(cfg, copy(), batches)
    mesh, p_mesh, step, _ = mesh_steps(cfg, copy(), batches, cpu_mesh())
    np.testing.assert_allclose(mesh, single, rtol=1e-5)
    assert_trees_close(p_mesh, p_single, 1e-5, "fsdp on L")


def test_train_step_shards_on_debug_mesh():
    """The counterpart of the reference's test of this name: olmoe at
    ``ShapeConfig("t", 32, 8, "train")`` on the (2, 4) mesh, its experts
    over ``model``: one step equals the single-device step, and the dry
    run counts its FLOPs."""
    from repro_torch.launch import roofline
    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"),
                              dtype="float32")
    shape = ShapeConfig("t", 32, 8, "train")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32),
             "extra": None}
    base = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    m2 = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    m2.load_state_dict(base.state_dict())
    single, p_single = single_steps(cfg, base, [batch], shape)
    mesh, p_mesh, step, _ = mesh_steps(cfg, m2, [batch], cpu_mesh(), shape)
    assert step.mm.expert[("blocks", "moe", "w_gate")] == 1
    np.testing.assert_allclose(mesh, single, rtol=1e-5)
    assert_trees_close(p_mesh, p_single, 1e-5, "olmoe")
    costs, mem = roofline.costs_of_step(
        steps_mod.build_train_step(cfg, shape, mesh=cpu_mesh()))
    assert costs.flops > 0 and mem["temp_bytes"] > 0


def test_serve_step_shards_on_debug_mesh():
    """The counterpart of the reference's test of this name: gemma2 at
    ``ShapeConfig("d", 64, 8, "decode")`` on the (2, 4) mesh; 4 decode
    steps' logits equal the single-device ones."""
    cfg = dataclasses.replace(get_smoke_config("gemma2-9b"), dtype="float32")
    shape = ShapeConfig("d", 64, 8, "decode")
    bundle = steps_mod.build_serve_step(cfg, shape, mesh=cpu_mesh())
    assert bundle.args[1]["global"].k.shape[:3] == (1, 8, 64)
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    step = bundle.fn
    params = step.mm.shard_model(model, free=False)
    cache = step.init_cache(8, 64)
    ref_cache = model.init_cache(8, 64)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (8, 4)))
    for pos in range(4):
        got, cache = step(params, cache, tokens[:, pos:pos + 1], pos)
        want, ref_cache = model.decode_step(ref_cache, tokens[:, pos:pos + 1],
                                            pos)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * max(1.0, float(
                                       want.abs().max())))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_mesh_serve_gives_single_device_tokens(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    kw = dict(device="cpu")
    want, _ = serve_mod.serve(cfg, 2, 1, 8, generator=torch.Generator()
                              .manual_seed(3), **kw)
    got, _ = serve_mod.serve(cfg, 2, 1, 8, generator=torch.Generator()
                             .manual_seed(3), mesh=cpu_mesh(), **kw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch,batch", [
    ("qwen2-0.5b", 2), ("qwen2-0.5b", 1), ("gemma2-9b", 1),
    ("zamba2-7b", 1), ("llama4-maverick-400b-a17b", 2)])
def test_seq_sharded_cache_serves_single_device_tokens(arch, batch,
                                                       monkeypatch):
    """A 16,384-slot cache: cut over ``model`` (batch over dp) or over dp
    + ``model`` (batch 1): attended piece by piece, never gathered; the
    greedy tokens equal one device's."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    calls = []
    real = A.sdpa_pieces
    monkeypatch.setattr(A, "sdpa_pieces", lambda *a, **k: calls.append(
        len(a[1].parts)) or real(*a, **k))
    seqs = []
    for mesh in (None, cpu_mesh()):
        seq, _ = serve_mod.serve(cfg, batch, 1, 8, device="cpu",
                                 generator=torch.Generator().manual_seed(5),
                                 mesh=mesh, max_len=16384)
        seqs.append(seq)
    np.testing.assert_array_equal(seqs[1], seqs[0])
    assert calls and set(calls) == {4 if batch == 2 else 8}


def test_sdpa_pieces_equals_sdpa():
    """The (max, sum, weighted accumulator) combine over pieces equals
    ``_sdpa`` over the whole cache, in float32 and bf16."""
    cfg = get_smoke_config("gemma2-9b")
    rng = np.random.default_rng(0)
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 1e-2)):
        q = torch.from_numpy(rng.standard_normal((2, 1, 4, 16))).to(dtype)
        k = torch.from_numpy(rng.standard_normal((2, 64, 2, 16))).to(dtype)
        v = torch.from_numpy(rng.standard_normal((2, 64, 2, 16))).to(dtype)
        mask = A.decode_mask(2, 64, 40, None, "cpu")
        want = A._sdpa(q, k, v, mask, cfg).float()
        ks = A.SeqPieces([(i, k[:, i:i + 16]) for i in range(0, 64, 16)])
        vs = A.SeqPieces([(i, v[:, i:i + 16]) for i in range(0, 64, 16)])
        got = A.sdpa_pieces(q, ks, vs, lambda j: A.decode_valid(j, 40, None),
                            cfg).float()
        assert float((got - want).abs().max()) <= tol


def test_c12_weights_gathered_at_use_experts_and_cache_in_pieces(
        monkeypatch):
    """ROADMAP C12: a mesh step gathers each weight sharded over ``model``
    or fsdp whole onto each dp slice's position (all-gather bytes: every
    piece held elsewhere, a slice); an expert stack over ``model`` runs a
    block a coordinate and is never gathered whole."""
    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"),
                              dtype="float32")
    step = steps_mod.build_train_step(cfg, SHAPE, mesh=cpu_mesh()).fn
    mm = step.mm
    params = mm.shard_model(LM(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(0)))
    gathered = []
    real = S.ShardStore.gather
    monkeypatch.setattr(S.ShardStore, "gather", lambda self, st, pos=0, **k:
                        gathered.append(st.shape) or real(self, st, pos, **k))
    mm.store.moved.clear()
    step(params, step.init_opt(), to_torch(batches_of(cfg, 1)[0]))
    stack = params["blocks"]["moe"]["w_gate"]
    assert stack.shape not in gathered
    assert len(stack.pieces) == 4
    want = 0
    for leaf in mm.leaves:
        if mm.expert[leaf.path] is not None:
            continue
        st = params
        for k in leaf.path:
            st = st[k]
        for _, pos in mm.batch_slices(2):
            want += sum(p.data.numel() * 4 for p in st.pieces
                        if p.position != pos)
    assert mm.store.moved["all-gather"] == want


def test_train_resume_exactness_on_mesh(tmp_path):
    """The counterpart of the reference's ``test_train_resume_exactness``
    on the (2, 4) mesh: a run saved at step 3 (whole leaves, assembled
    from the pieces) and resumed into the pieces gives the uninterrupted
    run's losses."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"), remat=False)
    shape = ShapeConfig("t", 32, 2, "train")
    kw = dict(log_every=0, use_pim_selector=False, mesh=cpu_mesh())
    _, _, full = train_mod.train(cfg, shape, steps=6, **kw)
    d1 = tmp_path / "run1"
    train_mod.train(cfg, shape, steps=3, ckpt_dir=str(d1), ckpt_every=3, **kw)
    params, state, resumed = train_mod.train(cfg, shape, steps=6,
                                             ckpt_dir=str(d1), ckpt_every=3,
                                             **kw)
    np.testing.assert_allclose(full[3:], resumed, rtol=2e-4)
    assert isinstance(params["embed"]["table"], S.ShardedTensor)
    assert int(state.step.pieces[0].data) == 6


def test_train_4k_on_one_card_mesh_refused_before_allocating(monkeypatch):
    """A ``train_4k`` step of qwen2-0.5b on a 16 x 16 mesh whose positions
    share one device: the plan's bytes (256 positions, 2.5 GB of float32
    logits each) exceed its memory, so ``train`` raises before a
    parameter is drawn."""
    def no_model(*a, **k):
        raise AssertionError("a model was built before the admission")
    monkeypatch.setattr(train_mod, "LM", no_model)
    with pytest.raises(MemoryError, match="256 positions"):
        train_mod.train(get_config("qwen2-0.5b"), SHAPES["train_4k"],
                        steps=1, use_pim_selector=False,
                        mesh=make_production_mesh(device="cpu"))


def test_sharded_entry_points_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = get_smoke_config("qwen2-0.5b")
    for call in (lambda: make_debug_mesh(2, 4),
                 lambda: make_production_mesh(),
                 lambda: steps_mod.build_train_step(cfg, SHAPE,
                                                    mesh=make_debug_mesh()),
                 lambda: train_mod.main(["--smoke", "--steps", "1"]),
                 lambda: serve_mod.main(["--smoke", "--mesh"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def _card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b", "gemma2-9b",
                                  "xlstm-1.3b", "zamba2-7b", "whisper-small"])
def test_mesh_train_steps_card_equal_cpu(arch):
    """3 sharded train steps on a (2, 4) mesh of the card against the
    (2, 4) CPU mesh from the same weights: losses and grad norms within
    1e-4 relative, parameters within 1e-4 x max(1, max|p|)."""
    _card_or_skip()
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    base = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    batches = batches_of(cfg)
    out = {}
    for dev in ("cuda", "cpu"):
        m = LM(cfg, device=dev, generator=torch.Generator().manual_seed(1))
        m.load_state_dict(base.state_dict())
        out[dev] = mesh_steps(cfg, m, batches,
                              make_debug_mesh(2, 4, device=dev))[:2]
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    got = S.tree_map(lambda t: t, out["cuda"][1])
    assert_trees_close(got, out["cpu"][1], 1e-4, arch)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama4-maverick-400b-a17b",
                                  "zamba2-7b"])
def test_mesh_serve_card_equals_single_card(arch):
    """Greedy serving on a (2, 4) mesh of the card, a 16,384-slot cache
    cut along the sequence, gives the single-card tokens."""
    _card_or_skip()
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    seqs = [serve_mod.serve(cfg, 2, 1, 8, device="cuda", mesh=mesh,
                            generator=torch.Generator("cuda").manual_seed(5),
                            max_len=16384)[0]
            for mesh in (None, make_debug_mesh(2, 4))]
    np.testing.assert_array_equal(seqs[1], seqs[0])
