"""Port: the dry-run tooling (``repro_torch.launch.{roofline,dryrun,rescore,
report,input_specs}``, ``models.scan_utils``), held against the reference.

The roofline arithmetic equals the reference's on the same inputs
(``units_of``, ``with_units``, ``seq_fit``, ``extrapolate``,
``slstm_flops_correction``, ``model_flops``, ``Roofline``, ``rescore``
and the two ``report`` tables on the same synthetic cell dicts), with the
port's H100 constants set to the reference's for the comparison; no TPU
constant is left in the port. ``costs_of_step`` runs the train and serve
steps of every smoke config on fake tensors on the (2, 4) mesh with the
plan's argument bytes, and the CLI's cell for qwen2-0.5b at full width
(``decode_32k``, 16 x 16) has the reference's keys, the H100's fit limit
and the plan's argument bytes. The dry-run's flash block overrides change
flash's output by at most 1e-6. The input stand-ins allocate nothing.
"""
import json
import math
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro_torch.configs.common import ShapeConfig
from repro_torch.distributed import sharding as S
from repro_torch.launch import dryrun, input_specs, report, rescore
from repro_torch.launch import roofline as R
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import scan_utils
from repro_torch.models.flash import flash_attention

ROOT = pathlib.Path(__file__).resolve().parents[1]
COSTS = [(3.0e12, 5.0e10, {"all-gather": 7_000_000, "all-reduce": 1_000}),
         (5.5e12, 8.0e10, {"all-gather": 9_000_000, "reduce-scatter": 5})]


@pytest.fixture
def reference_constants(monkeypatch):
    """The port's constants set to the reference's (197 TF/s, 819 GB/s,
    50 GB/s every link) for a like-for-like comparison."""
    from repro.launch import roofline as RR
    for mod in (R, rescore):
        monkeypatch.setattr(mod, "PEAK_FLOPS", RR.PEAK_FLOPS)
        monkeypatch.setattr(mod, "HBM_BW", RR.HBM_BW)
    monkeypatch.setattr(R, "NVLINK_BW", RR.ICI_BW)
    monkeypatch.setattr(R, "NET_BW", RR.ICI_BW)
    return RR


def _pair(RR, i):
    f, b, c = COSTS[i]
    return RR.CellCosts(f, b, dict(c)), R.CellCosts(f, b, dict(c))


def _same(got: R.CellCosts, want) -> None:
    assert got.flops == pytest.approx(want.flops, rel=1e-12)
    assert got.bytes_accessed == pytest.approx(want.bytes_accessed, rel=1e-12)
    assert got.coll_bytes == want.coll_bytes


def test_roofline_arithmetic_equals_reference(reference_constants):
    RR = reference_constants
    from repro.configs import get_config as ref_config
    r1, p1 = _pair(RR, 0)
    r2, p2 = _pair(RR, 1)
    _same(R.seq_fit(p1, p2, 512, 1024, 4096), RR.seq_fit(r1, r2, 512, 1024,
                                                        4096))
    _same(p2.sub(p1), r2.sub(r1))
    _same(p1.scale_add(p2, 2.5), r1.scale_add(r2, 2.5))
    for arch in ARCH_IDS:
        cp, cr = get_config(arch), ref_config(arch)
        assert R.units_of(cp) == RR.units_of(cr)
        for u in (1, 2):
            assert R.with_units(cp, u).n_layers == RR.with_units(cr, u).n_layers
        _same(R.extrapolate(p1, p2, cp), RR.extrapolate(r1, r2, cr))
        for shape in SHAPES.values():
            for n in (256, 512):
                assert R.slstm_flops_correction(cp, shape, n) == \
                    RR.slstm_flops_correction(cr, shape, n)
            assert R.model_flops(cp, shape) == RR.model_flops(cr, shape)
            for traffic in (None, 3.3e11):
                got = R.make_roofline(p2, cp, shape, 256, traffic).row()
                want = RR.make_roofline(r2, cr, shape, 256, traffic).row()
                assert got.keys() == want.keys()
                for k, v in want.items():
                    assert got[k] == (v if isinstance(v, str) else
                                      pytest.approx(v, rel=1e-12)), k


def _cells():
    """Synthetic dry-run results: ok cells of three archs on both meshes,
    a skipped one and an error."""
    cells = []
    for i, (arch, shape) in enumerate([("qwen2-0.5b", "train_4k"),
                                       ("olmoe-1b-7b", "decode_32k"),
                                       ("gemma2-9b", "prefill_32k")]):
        for mesh in ("16x16", "2x16x16"):
            per_dev = (5e9, 120e9)[i % 2]
            cells.append({
                "arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
                "full_compile": {
                    "compile_s": 12.5 + i, "argument_bytes": 3e9 + i,
                    "bytes_per_device": per_dev,
                    "fits_16GB": per_dev < 16e9, "fits": per_dev < 80e9,
                    "collectives_in_hlo": {"all-gather": 4e8 * (i + 1),
                                           "reduce-scatter": 2e8}},
                "costs": {"flops_per_dev": 2e13 * (i + 1),
                          "traffic_bytes_per_dev": 6e11 / (i + 1),
                          "collective_bytes_per_dev": {
                              "all-gather": 4e8 * (i + 1),
                              "reduce-scatter": 2e8}}})
    cells.append({"arch": "qwen2-0.5b", "shape": "long_500k",
                  "mesh": "16x16", "status": "skipped", "reason": "skipped: "
                  "pure full-attention arch; long_500k requires sub-quadratic"})
    cells.append({"arch": "zamba2-7b", "shape": "train_4k", "mesh": "16x16",
                  "status": "error", "error": "Boom: x"})
    return cells


def _rows(table: str):
    """The data rows of a markdown table, each cell stripped, with the
    last (free-text) column dropped."""
    lines = table.splitlines()[2:]
    return [[c.strip() for c in ln.strip("|").split("|")][:-1] for ln in lines]


def test_rescore_and_report_equal_reference(reference_constants, tmp_path,
                                            monkeypatch):
    from repro.launch import report as ref_report
    from repro.launch import rescore as ref_rescore
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    for d in (ref_dir, port_dir):
        d.mkdir()
    for c in _cells():
        tag = "pod2x16x16" if c["mesh"] == "2x16x16" else "pod16x16"
        name = f"{c['arch']}__{c['shape']}__{tag}.json"
        for d in (ref_dir, port_dir):
            (d / name).write_text(json.dumps(c))
        got, want = rescore.rescore(c), ref_rescore.rescore(c)
        assert (got is None) == (want is None)
        if want is not None:
            assert got.keys() == want.keys()
            for k, v in want.items():
                assert got[k] == (v if isinstance(v, str) else
                                  pytest.approx(v, rel=1e-12)), k
    monkeypatch.setattr(ref_report, "RESULTS", ref_dir)
    monkeypatch.setattr(ref_rescore, "RESULTS", ref_dir)
    monkeypatch.setattr(dryrun, "RESULTS", port_dir)
    monkeypatch.setattr(rescore, "RESULTS", port_dir)
    assert _rows(report.dryrun_table()) == _rows(ref_report.dryrun_table())
    assert _rows(report.roofline_table()) == _rows(ref_report.roofline_table())
    assert len(_rows(report.roofline_table())) == 5
    assert rescore.all_rows().keys() == ref_rescore.all_rows().keys()


def test_no_tpu_constant_in_the_port():
    src = ROOT / "src" / "repro_torch"
    text = "\n".join(p.read_text() for p in src.rglob("*.py"))
    for const in ("197e12", "819e9", "16e9", "fits_16GB"):
        assert const not in text, const
    assert (R.PEAK_FLOPS, R.HBM_BW, R.NVLINK_BW, R.NET_BW, R.CARD_BYTES) == \
        (989.4e12, 3.35e12, 450e9, 50e9, 80e9)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_costs_of_step_on_fake_tensors(arch):
    """The train and serve steps of each smoke config run on fake tensors
    on the (2, 4) mesh: FLOPs counted, the step's temporaries tracked,
    the plan's argument bytes a position."""
    cfg = get_smoke_config(arch)
    mesh = make_debug_mesh(2, 4, device="cpu")
    for shape in (ShapeConfig("t", 32, 8, "train"),
                  ShapeConfig("d", 64, 8, "decode")):
        bundle = steps_mod.build_step(cfg, shape, mesh=mesh)
        costs, mem = R.costs_of_step(bundle)
        assert costs.flops > 0 and mem["temp_bytes"] > 0, shape.kind
        assert mem["argument_bytes"] == bundle.fn.plan_bytes(*bundle.args)
        assert costs.coll_bytes["all-gather"] > 0
        assert bundle.fn.only_first_slice is False


def test_dryrun_cli_writes_a_cell_with_h100_constants(tmp_path, monkeypatch):
    """``python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape
    decode_32k``: qwen2-0.5b at full width and depth on the 16 x 16 mesh,
    its argument bytes a position the plan's (parameters, the cache and a
    dp slice of the tokens, by ``shard_shape``)."""
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k"])
    d = json.loads(dryrun.cell_path("qwen2-0.5b", "decode_32k",
                                    False).read_text())
    assert d["status"] == "ok" and d["mesh"] == "16x16"
    fc = d["full_compile"]
    assert set(fc) >= {"argument_bytes", "temp_bytes", "output_bytes",
                       "alias_bytes", "bytes_per_device", "fits",
                       "collectives_in_hlo"}
    assert fc["fits"] == (fc["bytes_per_device"] < 80e9)
    cfg = get_config("qwen2-0.5b")
    rules = S.ShardingRules(dryrun.make_production_mesh(device="cpu"), cfg)
    p = input_specs.params_struct(cfg)
    shard = steps_mod._fsdp_augment(rules, rules.params_shardings(p), p)
    cache, tokens, _ = input_specs.decode_input_specs(cfg,
                                                      SHAPES["decode_32k"])
    want = sum(ns.planned_bytes(t.shape, t.dtype) for (_, ns), (_, t) in
               zip(S.tree_items(shard), S.tree_items(p)))
    want += sum(ns.planned_bytes(t.shape, t.dtype) for (_, ns), (_, t) in
                zip(S.tree_items(rules.cache_shardings(cache)),
                    S.tree_items(cache)))
    want += tokens.numel() * 4 // 16
    assert fc["argument_bytes"] == want
    assert d["roofline_method"] == "full_depth"
    assert d["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert d["costs"]["flops_per_dev"] > 0


def test_flash_block_overrides_keep_the_output(monkeypatch):
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 64, 4, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 64, 2, 16)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 64, 2, 16)).astype(
        np.float32))
    for kw in ({}, {"window": 24}, {"softcap": 30.0}, {"causal": False}):
        want = flash_attention(q, k, v, q_block=16, kv_block=16, **kw)
        monkeypatch.setattr(scan_utils, "FLASH_Q_BLOCK", 32)
        monkeypatch.setattr(scan_utils, "FLASH_KV_BLOCK", 64)
        got = flash_attention(q, k, v, q_block=16, kv_block=16, **kw)
        monkeypatch.setattr(scan_utils, "FLASH_Q_BLOCK", None)
        monkeypatch.setattr(scan_utils, "FLASH_KV_BLOCK", None)
        assert float((got - want).abs().max()) <= 1e-6, kw


def test_input_specs_allocate_nothing():
    """llama4-maverick's 784 B parameters and its ``train_4k`` batch as
    meta tensors: nothing drawn, nothing allocated."""
    cfg = get_config("llama4-maverick-400b-a17b")
    p = input_specs.params_struct(cfg)
    leaves = [t for _, t in S.tree_items(p)]
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) > 7e11
    assert p["blocks"]["moe"]["w_gate"].shape == (48, 128, 5120, 8192)
    batch = input_specs.train_input_specs(cfg, SHAPES["train_4k"])
    assert batch["tokens"].shape == (256, 4096) and batch["extra"] is None
    w = input_specs.train_input_specs(get_config("whisper-small"),
                                      SHAPES["train_4k"])["extra"]
    assert w.shape == (256, 4096, 768) and w.dtype == torch.bfloat16
    cache, tokens, pos = input_specs.decode_input_specs(
        get_config("whisper-small"), SHAPES["decode_32k"])
    assert cache["cross"][0].shape[2] == input_specs.ENC_STUB_LEN
    assert tokens.shape == (128, 1) and pos == 0
    assert math.prod(cache["self"].k.shape) > 0
