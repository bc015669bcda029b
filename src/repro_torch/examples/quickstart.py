"""Quickstart: bulk-bitwise analytics on a bit-sliced relation.

Builds a small relation on the device, runs a compiled filter + aggregate
program on the PIM-style engine, checks it against numpy, and prints the
paper's headline metric — how many bytes the host reads with and without
bulk-bitwise PIM.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

``main(argv)`` returns the numbers it prints.
"""
import argparse

import numpy as np

from repro_torch.core import cost_model, engine
from repro_torch.db.compiler import Agg, And, Between, Cmp, Col, Compiler, Lit

N = 200_000


def make_orders(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {
        "amount": rng.integers(1, 50_000, N),        # cents
        "status": rng.integers(0, 4, N),             # dict-encoded
        "day": rng.integers(0, 365, N),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the relation (default cuda)")
    args = ap.parse_args(argv)
    orders = make_orders()

    # 1. build the PIM-resident copy (bit-sliced planes)
    rel = engine.PimRelation.from_columns("orders", orders,
                                          device=args.device)
    print(f"relation: {N} records, {rel.layout.row_bits} bits/record, "
          f"{rel.layout.n_crossbars} crossbar-equivalents, "
          f"util {rel.layout.memory_utilization():.1%}")

    # 2. compile SELECT sum(amount), count(*) WHERE status=2 AND day in
    #    [90,180)
    pred = And(Cmp("eq", Col("status"), Lit(2)),
               Between(Col("day"), 90, 179))
    c = Compiler(rel)
    mask = c.compile_filter(pred, with_transform=False)
    regs = c.compile_aggregates(mask, [Agg("sum", Col("amount"), "revenue"),
                                       Agg("count", None, "n")])

    # 3. execute on the bulk-bitwise engine
    eng = engine.Engine(rel)
    eng.run(c.program)
    revenue = int(eng.read_scalar(regs["revenue"][1]))
    n = int(eng.read_scalar(regs["n"][1]))

    # 4. verify against numpy
    sel = ((orders["status"] == 2) & (orders["day"] >= 90)
           & (orders["day"] <= 179))
    if (revenue, n) != (int(orders["amount"][sel].sum()), int(sel.sum())):
        raise SystemExit(f"revenue={revenue} n={n} do not match numpy")
    print(f"revenue={revenue} over n={n} rows — matches numpy ✓")

    # 5. the paper's headline: host reads
    cost = cost_model.classify_program(eng.trace)
    scan_bytes = N * (16 + 2 + 9) // 8          # full-width column scan
    pim_bytes = cost_model.pim_read_bytes_aggregate(rel.layout.n_crossbars,
                                                    2)
    print(f"bulk-bitwise program: {cost.cycles_total} stateful-logic cycles "
          f"({cost.cycles_total * 30e-9 * 1e6:.0f} us at 30 ns)")
    print(f"host reads: baseline scan {scan_bytes:,} B -> PIM "
          f"{pim_bytes:,} B ({scan_bytes / pim_bytes:.0f}x reduction)")
    return {"revenue": revenue, "n": n, "cycles": cost.cycles_total,
            "scan_bytes": scan_bytes, "pim_bytes": pim_bytes}


if __name__ == "__main__":
    main()
