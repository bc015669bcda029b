#!/usr/bin/env python3
"""The controls of the comparison: references that break a guarantee the
configuration states, judged in the program's place.

* ``float32`` (every configuration): the reference with its expressions
  and sums in float32, the nearest precision below the exact integers the
  configuration states. Aggregates and end-to-end rows of SF 1 leave
  float32's 24-bit mantissa, so it fails ``agg_wrong`` / ``rows_wrong``.
* ``stale`` (configurations with refreshes): the exact reference read one
  refresh before the last one acknowledged when the query was submitted,
  breaking the visibility guarantee; it fails ``mask_bits_wrong``
  and ``agg_wrong``.

Run on the card, a short window a seed, every seed in one process:

    python3 pimbench/control.py --workload <cell> --seconds 10 --seeds 1 2 3

Each seed prints one JSON line: the program's numbers (the lower reading
of each limit) and each control's (the upper).
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def controls_for(traffic):
    """{name: answer(record, view)} of the controls a mix can have."""
    from pimbench import reference

    def float32(r, view):
        return reference.evaluate(r.q, *view(r.state_lo), precision="float32")

    def stale(r, view):
        return reference.evaluate(r.q, *view(max(0, r.state_lo - 1)))

    out = {"float32": float32}
    if traffic.get("refresh") is not None:
        out["stale"] = stale
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from pimbench import harness
    from pimbench.run import load_cell
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    _, cell, config, traffic = load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        run, checks, attempted, failed, dev = harness.run_cell(
            cell, config, traffic, seed, args.seconds, False, "cuda",
            controls=controls_for(traffic))
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "attempted": attempted, "failed": failed,
                          "program": checks, "controls": run.controls,
                          "run_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
