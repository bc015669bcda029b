#!/usr/bin/env python3
"""Find the highest rate an open-loop cell's program sustains: the sweep
that the fixed rates of the open-loop mixes are set from. The benchmark's
runs never run it.

    python3 pimbench/sweep.py --seed 7 --seconds 20 \\
        --plan sf1-filter-streams:2,3,4,5 --plan sf1-join-streams:15,20,25

One process on one card: the cells of every ``--plan`` share one
configuration, so the tables are generated and loaded once and each
cell's templates warmed up once; then one window a rate, in the order
given, each against a fresh ``QueryService`` as in a run. Prints a JSON
line a window: the rate offered, the queries answered inside the window
a second, the queries still in the benchmark's queue at the close
(``dropped``), and the latency of the answered ones. No answer is
compared here.
"""
import argparse
import asyncio
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--plan", action="append", required=True,
                    help="<open-loop cell>:<rate>,<rate>,...")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from pimbench import harness, tpch_gen
    from pimbench.run import load_cell
    from repro_torch.db.database import PimDatabase
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    plans = []
    for p in args.plan:
        name, rates = p.split(":")
        _, cell, config, traffic = load_cell(name)
        if traffic["loop"] != "open":
            raise SystemExit(f"{name} is not an open-loop cell")
        plans.append((name, config, traffic,
                      [float(r) for r in rates.split(",")]))
    if len({json.dumps(c, sort_keys=True) for _, c, _, _ in plans}) != 1:
        raise SystemExit("the cells of one sweep share one configuration")
    config = plans[0][1]
    t0 = time.perf_counter()
    tables = tpch_gen.generate(sf=float(config["scale_factor"]),
                               seed=args.seed)
    db = PimDatabase({r: dict(c) for r, c in tables.items()}, device="cuda",
                     wear_policy=config["wear_policy"])
    print(json.dumps({"setup_s": time.perf_counter() - t0}), flush=True)
    for name, _, traffic, rates in plans:
        plan = harness.load_plan(traffic)
        asyncio.run(harness._warmup(db, plan, None))
        for rate in rates:
            out = asyncio.run(harness._window(
                db, plan, dict(traffic, rate_qps=rate), args.seed,
                args.seconds, None, 0))
            queries, _, w0, w1 = out[:4]
            lat = [r.t_done - r.t_submit for r in queries
                   if r.answered and r.t_submit < w1]
            done = sum(1 for r in queries if r.answered and r.t_done <= w1)
            print(json.dumps({
                "workload": name, "offered_qps": rate,
                "answered_qps": done / args.seconds,
                "dropped": sum(1 for r in queries if r.dropped),
                "errors": sum(1 for r in queries if r.error),
                "p50_ms": 1e3 * float(np.percentile(lat, 50)) if lat else None,
                "p95_ms": 1e3 * float(np.percentile(lat, 95)) if lat else None,
                "drained_s": time.perf_counter() - w1}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
