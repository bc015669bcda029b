#!/usr/bin/env python3
"""Run one cell of the benchmark and print its result line.

    python3 pimbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration and traffic mix; the run reads them from
``pimbench/configs/`` and ``pimbench/traffic/``. With ``--trace 0`` the
result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, the card's busy time in the traced window and a
breakdown. The last line of standard output is the result, a JSON object;
the last lines of standard error give each number the comparison
checked, beside its limit. The run exits with a code other than 0, and
prints no result, when no CUDA card (or too few) is visible, when the
program's package cannot be imported, or when JAX or the JAX package was
loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
LIMITS = {"unanswered": 0, "mask_bits_wrong": 0, "agg_wrong": 0,
          "rows_wrong": 0, "storage_rows_wrong": 0, "refresh_rows_gap": 0,
          "empty_window": 0}


def forbidden_modules():
    """Top-level names of loaded modules that the run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_cell(name: str, root: Path = ROOT):
    """(benchmark, cell, configuration, traffic mix) of one cell."""
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; cells: {sorted(cells)}")
    cell = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(root / cfg["file"]) as f:
        config = json.load(f)
    with open(root / "pimbench" / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return bench, cell, config, traffic


def limits_of(run) -> dict:
    """Every check's limit: ``LIMITS`` for the base checks, extended by
    those the cell's deployment adds (``run.limits``), which may not name
    a base check."""
    clash = sorted(set(run.limits) & set(LIMITS))
    if clash:
        raise ValueError(f"the deployment's checks {clash} are base checks")
    return {**LIMITS, **run.limits}


def is_correct(checks, failed, limits) -> bool:
    """Every record right, and every check at or under its limit."""
    return failed == 0 and all(v <= limits[k] for k, v in checks.items())


def cell_metrics(bench, cell, trace: bool):
    """The metric entries this cell reports in a run of this kind."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell["name"] in m["workloads"]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench, cell, config, traffic = load_cell(args.workload)

    import torch
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s), "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from pimbench import harness

    trace = bool(args.trace)
    run, checks, attempted, failed, device = harness.run_cell(
        cell, config, traffic, args.seed, args.seconds, trace, "cuda", T0)
    metrics = harness.read_metrics(run, cell_metrics(bench, cell, trace))

    found = forbidden_modules()
    if found:
        print(f"no result: the run loaded {found}", file=sys.stderr)
        return 3

    limits = limits_of(run)
    correct = is_correct(checks, failed, limits)
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device,
           "dropped_at_close": int(run.phases["dropped_at_close"])}
    if trace and run.trace is not None:
        out["breakdown"] = {
            "device_ops": run.trace.top_ops(10),
            "idle_gaps": run.trace.idle_by_host(run.samples, 10)}
    out["checks"] = {k: {"value": v, "limit": limits[k]}
                     for k, v in checks.items()}
    sys.stdout.flush()
    print("phases_s " + " ".join(f"{k}={v:.3f}" for k, v in run.phases.items())
          + f" setup={run.setup_s:.3f} queries={len(run.queries)}"
          f" refreshes={len(run.refreshes)}", file=sys.stderr)
    if run.trace is not None:
        print(f"trace marked={run.trace.marked} device_events="
              f"{len(run.trace.events)} fused_program="
              f"{run.trace.kernel_count('fused_program')} materialize="
              f"{run.trace.kernel_count('materialize')} samples="
              f"{len(run.samples)}", file=sys.stderr)
    print(f"attempted {attempted} failed {failed} correct {correct}",
          file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k} {v} limit {limits[k]}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
