"""Dry-run of one (arch x shape x mesh) cell on fake tensors.

The counterpart of ``repro.launch.dryrun``. For one cell it builds the
step on the production mesh (``launch.steps.build_step(..., mesh=)``: the
reference's plan, fsdp included) and runs one dp position's share of it
on fake tensors (``roofline.costs_of_step``: no data, no device, every
layer at full depth, the flash blocks at the reference dry-run's 2,048 x
4,096). It reports the plan's argument bytes a position, the peak of the
step's temporaries, ``bytes_per_device`` and ``fits`` (80 GB, an H100's
memory), the FLOPs and the collective bytes a position, and the roofline
terms with the H100's constants. The sequence loops of the recurrent
patterns run a Python step a token, too slow on fake tensors at 4,096
and 32,768 tokens: those cells (``run_all_dryruns.HEAVY``) run at S/8
and S/4 and fit cost(S) = a*S + b*S^2 (``roofline.seq_fit``; the JSON's
``roofline_method`` says "seq_extrapolated"). Results go to
``results/dryrun_torch/`` (reruns skip a cell already there)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k [--multipod] [--force]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback

from ..configs import SHAPES, cell_is_runnable, get_config
from ..models import scan_utils
from . import roofline as R
from . import steps as steps_mod
from .mesh import make_production_mesh

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"
FLASH_BLOCKS = (2048, 4096)


def cell_path(arch: str, shape: str, multipod: bool) -> pathlib.Path:
    mesh_tag = "pod2x16x16" if multipod else "pod16x16"
    return RESULTS / f"{arch}__{shape}__{mesh_tag}.json"


def _costs(cfg, shape, mesh):
    return R.costs_of_step(steps_mod.build_step(cfg, shape, mesh=mesh))


def run_cell(arch: str, shape_name: str, multipod: bool,
             rooflines: bool = True, seq_extrapolate: bool = False,
             overrides: dict | None = None, tag: str = "") -> dict:
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multipod, device="cpu")
    n_chips = len(mesh.devices)
    out = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multipod else "16x16", "status": "ok"}
    if tag:
        out["tag"] = tag
    runnable, why = cell_is_runnable(arch, shape_name)
    if not runnable:
        out["status"] = "skipped"
        out["reason"] = why
        return out

    t0 = time.time()
    scan_utils.FLASH_Q_BLOCK, scan_utils.FLASH_KV_BLOCK = FLASH_BLOCKS
    try:
        if seq_extrapolate:
            s1, s2 = shape.seq_len // 8, shape.seq_len // 4
            pts = [_costs(cfg, dataclasses.replace(shape, seq_len=s), mesh)
                   for s in (s1, s2)]
            costs = R.seq_fit(pts[0][0], pts[1][0], s1, s2, shape.seq_len)
            mem = dict(pts[1][1])
            mem["temp_bytes"] = int(R.seq_fit(
                R.CellCosts(pts[0][1]["temp_bytes"], 0, {}),
                R.CellCosts(pts[1][1]["temp_bytes"], 0, {}),
                s1, s2, shape.seq_len).flops)
            arg_full = steps_mod.build_step(cfg, shape, mesh=mesh)
            mem["argument_bytes"] = arg_full.fn.plan_bytes(*arg_full.args)
            method = "seq_extrapolated"
        else:
            costs, mem = _costs(cfg, shape, mesh)
            method = "full_depth"
    finally:
        scan_utils.FLASH_Q_BLOCK = scan_utils.FLASH_KV_BLOCK = None
    per_dev = (mem["argument_bytes"] + mem["temp_bytes"]
               + mem["output_bytes"] - mem["alias_bytes"])
    out["full_compile"] = {
        "compile_s": round(time.time() - t0, 1),
        **mem,
        "bytes_per_device": int(per_dev),
        "fits": bool(per_dev < R.CARD_BYTES),
        "hlo_flops_per_dev_uncorrected": costs.flops,
        "collectives_in_hlo": costs.coll_bytes,
    }
    print(f"[{arch} {shape_name} {'multi' if multipod else 'single'}] "
          f"ran in {out['full_compile']['compile_s']}s, "
          f"{per_dev / 1e9:.2f} GB/device, fits={per_dev < R.CARD_BYTES}")
    if rooflines:
        traffic = 2.0 * (mem["argument_bytes"] + mem["temp_bytes"]
                         + mem["output_bytes"])
        rl = R.make_roofline(costs, cfg, shape, n_chips,
                             traffic_bytes=traffic)
        out["costs"] = {
            "flops_per_dev": costs.flops,
            "logical_bytes_per_dev": costs.bytes_accessed,
            "traffic_bytes_per_dev": traffic,
            "collective_bytes_per_dev": costs.coll_bytes,
            "network_bytes_per_dev": costs.net_bytes,
        }
        out["roofline"] = rl.row()
        out["roofline_method"] = method
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--seq-extrapolate", action="store_true")
    ap.add_argument("--override", default="",
                    help="comma-separated cfg overrides k=v")
    ap.add_argument("--tag", default="", help="result filename suffix")
    args = ap.parse_args(argv)

    path = cell_path(args.arch, args.shape, args.multipod)
    if args.tag:
        path = path.with_name(path.stem + "__" + args.tag + ".json")
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.exists() and not args.force:
        print(f"cached: {path}")
        return
    try:
        overrides = {}
        for kv in args.override.split(","):
            if kv:
                k, v = kv.split("=")
                overrides[k] = (v == "True" if v in ("True", "False")
                                else int(v) if v.isdigit() else float(v))
        out = run_cell(args.arch, args.shape, args.multipod,
                       rooflines=not args.no_roofline,
                       seq_extrapolate=args.seq_extrapolate,
                       overrides=overrides or None, tag=args.tag)
    except Exception as e:
        out = {"arch": args.arch, "shape": args.shape,
               "mesh": "2x16x16" if args.multipod else "16x16",
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-3000:]}
        print(out["error"])
    path.write_text(json.dumps(out, indent=2, default=float))
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
