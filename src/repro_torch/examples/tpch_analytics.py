"""TPC-H analytics end-to-end: the paper's evaluation, miniaturised.

Generates TPC-H at a small scale factor, executes the paper's query set
through ``PimDatabase.execute`` on the bulk-bitwise engine (FUSED: the
hand-written kernels on a CUDA device) AND the column-scan oracle
(``Engine.ORACLE``), verifies equality, and prints the paper-scale
(SF=1000) modeled speedup/energy/endurance — the numbers Figs. 8/11/15
report. Queries with a host stage then run END TO END (PIM filter +
materialization on the device + host join/agg/order), and the decoded
result rows of one joined query (Q3 by default) are printed. A CONCURRENT
batch (Q1+Q6+Q14 by default) goes through ``db.execute([...])``: linked
and launched as one fused program per relation, with the launch and
plane-read amortization printed from ``db.last_batch_stats``. The same
workload is then replayed as a concurrent STREAM through the async
serving front end (``repro_torch.serve.QueryService``). Finally an HTAP
STREAMING round trickle-inserts rows into ``lineitem`` (``repro_torch.
dml``: ISA write programs into reserved append capacity) between Q6
re-runs, verifies it against the NumPy mutable-table oracle, and prints
the endurance delta the write pressure produces in the cost report.

    PYTHONPATH=src python -m repro_torch.examples.tpch_analytics \
        [--sf 0.01] [--device cpu]

``main(argv)`` returns the numbers it prints; ``ok`` is true when every
check above held.
"""
import argparse

import numpy as np

from repro_torch import dml
from repro_torch.core import bitslice
from repro_torch.db import Engine, database, queries, tpch
from repro_torch.launch.serve import serve_trace


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=0.003)
    ap.add_argument("--queries", nargs="*", default=None)
    ap.add_argument("--e2e", default="Q3",
                    help="query whose full joined result rows to print")
    ap.add_argument("--batch", nargs="*", default=["Q1", "Q6", "Q14"],
                    help="queries to run concurrently as ONE fused batch")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the relations (default cuda)")
    args = ap.parse_args(argv)
    out: dict = {"rows": [], "reports": {}}

    print(f"generating TPC-H sf={args.sf} ...")
    db = database.PimDatabase(tpch.generate(sf=args.sf, seed=42),
                              device=args.device)
    specs = queries.all_queries()
    if args.queries:
        specs = [q for q in specs if q.name in args.queries]

    print(f"{'query':9s} {'kind':7s} {'cycles':>9s} {'speedup':>8s} "
          f"{'readred':>8s} {'energy':>7s} {'endur(10y)':>10s} verified")
    for spec in specs:
        # filter_only(): the paper's mask/aggregate scope of every query,
        # host stage (if any) dropped — the cost report's subject.
        pim = db.execute(spec.filter_only())
        base = db.execute(spec.filter_only(), engine=Engine.ORACLE)
        ok = all((pim.relations[r].mask == base.relations[r].mask).all()
                 for r in spec.filters) and pim.aggregates == base.aggregates
        rep = database.cost_report(pim, sf_scale=1000 / args.sf)
        e2e = " +host" if spec.host is not None else ""
        print(f"{spec.name:9s} {spec.kind + e2e:13s} "
              f"{rep.cycles['total']:>9d} "
              f"{rep.speedup:>8.1f} {rep.read_reduction:>8.1f} "
              f"{rep.energy_saving:>7.2f} "
              f"{rep.endurance_ops_per_cell_10y:>10.2e} "
              f"{'✓' if ok else 'MISMATCH'}")
        out["rows"].append((spec.name, bool(ok)))
        out["reports"][spec.name] = rep

    # Full end-to-end result rows of one joined query: the PIM stage hands
    # the host only the selected records, the host completes
    # join/group/order, and the rows decode back to currency/dates/strings.
    spec = queries.get_query(args.e2e)
    if spec.host is None:
        print(f"\n{spec.name} has no host stage; pick one of "
              f"{[q.name for q in queries.all_queries() if q.host]}")
        out["ok"] = all(ok for _, ok in out["rows"])
        return out
    res = db.execute(spec)
    e2e_ok = res.rows == db.execute(spec, engine=Engine.ORACLE).rows
    mat = ", ".join(f"{r}:{n}" for r, n in res.materialized_rows.items())
    print(f"\n== {spec.name} end to end: PIM stage {res.pim_s * 1e3:.1f} ms "
          f"(materialized rows {mat}), host stage {res.host_s * 1e3:.1f} ms "
          f"{'✓' if e2e_ok else 'MISMATCH'} ==")
    print(" | ".join(f"{c:>16s}" for c in res.columns))
    for row in res.decoded_rows():
        print(" | ".join(f"{str(v):>16s}" for v in row))
    out["e2e"] = {"name": spec.name, "rows": res.rows, "ok": e2e_ok,
                  "materialized_rows": dict(res.materialized_rows)}

    # Concurrent batch: the same queries submitted together fuse into one
    # linked launch per relation — shared source planes stream once,
    # structurally equal predicate subtrees compile once (CSE), and each
    # query demuxes its own results from the shared ProgramResult.
    batch_specs = [queries.get_query(n) for n in args.batch]
    results = db.execute(batch_specs)
    stats = db.last_batch_stats
    print(f"\n== concurrent batch {'+'.join(args.batch)}: "
          f"{stats['n_queries']} queries -> {stats['n_dispatches']} fused "
          f"dispatches (PIM {stats['pim_s'] * 1e3:.1f} ms, "
          f"demux {stats['demux_s'] * 1e3:.1f} ms) ==")
    for rel, rs in sorted(stats["relations"].items()):
        print(f"  {rel:10s} {rs['n_programs']} programs: "
              f"{rs['instrs_unlinked']} instrs -> {rs['instrs_linked']} "
              f"linked ({rs['instrs_deduped']} deduped by CSE), "
              f"{rs['plane_reads']} plane reads "
              f"({rs['source_plane_reads']} source, streamed once for all "
              f"{rs['n_programs']} queries)")
    batch_ok = []
    for spec, res in zip(batch_specs, results):
        oracle = db.execute(spec, engine=Engine.ORACLE)
        if spec.host is not None:
            ok = res.rows == oracle.rows
            print(f"  {spec.name}: {len(res.rows)} result rows (host stage "
                  f"on demuxed materialization) "
                  f"{'✓' if ok else 'MISMATCH'}")
        else:
            ok = res.aggregates == oracle.aggregates
            print(f"  {spec.name}: "
                  f"{sum(len(g) for g in res.aggregates.values())}"
                  f" aggregates {'✓' if ok else 'MISMATCH'}")
        batch_ok.append((spec.name, ok))
    out["batch"] = {"n_queries": stats["n_queries"],
                    "n_dispatches": stats["n_dispatches"], "ok": batch_ok}

    # Streamed serving: the batch queries arrive CONCURRENTLY (x2 repeats,
    # so the result cache and in-flight coalescing both engage) through
    # the async front end — admission windows re-create the fused batch
    # above on the fly.
    trace = [queries.get_query(n) for n in args.batch * 2]
    serve_trace(db, trace)                      # warm the tape cache
    served, sstats, wall = serve_trace(db, trace)
    lat = sstats["latency_ms"]
    serve_ok = all(r.rows == w.rows and r.aggregates == w.aggregates
                   for r, w in zip(served, results * 2))
    print(f"\n== served {len(trace)} concurrent submissions in "
          f"{wall * 1e3:.1f} ms ({len(trace) / wall:.0f} qps, "
          f"p50 {lat['p50']:.1f} ms, p99 {lat['p99']:.1f} ms) "
          f"{'✓' if serve_ok else 'MISMATCH'} ==")
    print(f"  {sstats['dispatches']} dispatches, "
          f"{sstats['coalesced']} coalesced, "
          f"{sstats['cache']['hits']} cache hits, "
          f"windows: {sstats['batcher']['windows']}")
    out["serve"] = {"n": len(trace), "ok": serve_ok,
                    "errors": sstats["errors"],
                    "dispatches": sstats["dispatches"]}

    # HTAP streaming: trickle-insert batches into lineitem between Q6
    # re-runs. Each insert is an ISA write program (PlaneWrite per
    # attribute + the valid bit) into reserved append-segment capacity,
    # so the layout — and every recorded tape — survives; versions bump so
    # cached results can never go stale. The endurance figure moves
    # because the wear-leveling allocator's busiest-row write count rides
    # into the cost report (dml_row_ops).
    spec6 = queries.get_query("Q6")
    q6 = spec6.filter_only()
    rep0 = db.report(db.execute(q6), sf_scale=1000 / args.sf)
    src = {a: np.asarray(c) for a, c in db.tables["lineitem"].items()}
    n0 = src["l_quantity"].size
    oracle = dml.MutableTable(db.tables["lineitem"])
    rng = np.random.default_rng(0)
    rounds, k, cells = 5, 32, 0
    prev = []
    for _ in range(rounds):
        idx = rng.integers(0, n0, k)
        rows = {a: c[idx] for a, c in src.items()}
        # Rolling staging buffer: each round expires the previous batch —
        # the churn pattern that makes slot choice (wear policy) matter.
        muts = [dml.Insert("lineitem", rows)]
        if prev:
            muts.append(dml.Delete("lineitem", row_ids=prev))
        st = db.apply(muts)["lineitem"]
        new_ids = oracle.insert(rows)
        if prev:
            oracle.delete(row_ids=prev)
        prev = new_ids                     # ids align: same assignment rule
        cells += st["cells_written"]
        r6 = db.execute(q6)
    exp = oracle.aggregate(spec6.filters["lineitem"], spec6.aggregates)
    got = tuple(r6.aggregates["all"][a.name] for a in spec6.aggregates)
    rep1 = db.report(r6, sf_scale=1000 / args.sf)
    d = db.dml_state("lineitem")
    unleveled = dml.replay(d.segments.events,
                           bitslice.pad_words(n0) * bitslice.WORD_BITS,
                           n0, "first_fit").busiest_row_ops()
    print(f"\n== HTAP stream: {rounds} rounds x {k} staged rows into "
          f"lineitem (previous batch expired each round), Q6 after each "
          f"(v{st['version']}) ==")
    print(f"  Q6 vs mutable oracle: "
          f"{'✓ bit-identical' if exp == got else 'MISMATCH'}")
    print(f"  {cells} cells written; busiest row "
          f"{d.segments.busiest_row_ops():.0f} "
          f"ops leveled (rotate) vs {unleveled:.0f} first-fit replay")
    print(f"  reserved append capacity: {rep1.bytes_reserved / 1024:.0f} KiB "
          f"of {rep1.bytes_resident / 1024:.0f} KiB resident")
    print(f"  endurance (10y, paper scale): "
          f"{rep0.endurance_ops_per_cell_10y:.2e} -> "
          f"{rep1.endurance_ops_per_cell_10y:.2e} ops/cell "
          f"(dml_row_ops {rep1.dml_row_ops:.0f})")
    out["htap"] = {"ok": exp == got, "cells": cells,
                   "busiest": d.segments.busiest_row_ops(),
                   "unleveled": unleveled, "version": st["version"]}
    out["ok"] = (all(ok for _, ok in out["rows"]) and e2e_ok
                 and all(ok for _, ok in batch_ok) and serve_ok
                 and sstats["errors"] == 0 and exp == got)
    return out


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
