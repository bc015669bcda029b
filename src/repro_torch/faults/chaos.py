"""Deterministic chaos soak: the htap_stream workload under injected faults.

The counterpart of ``repro.faults.chaos``: the same schedule, seeds,
budget and report, with the database on ``device`` (default ``cuda``).
Replays the rolling-staging-buffer HTAP scenario (INSERT a batch,
DELETE the previous batch, hot in-place UPDATEs, Q1/Q6 analytics
through ``QueryService``) while injecting every fault class the model
knows: a scheduled cell flip, a ghost valid-bit flip in never-allocated
capacity, a stuck-at-1 cell, endurance-driven row death (the hot rows'
real wear counters cross the budget mid-run), and transient dispatch
faults sized to exercise retry-success, retry-exhaustion (degraded
windows), a circuit-breaker trip, and the half-open recovery probe.

Everything is scheduled, nothing is sampled: the same seed and scale
factor produce the same injection coordinates, the same detection
rounds, and the same recovery counters — on any device: they equal
the reference's ``chaos_soak`` counters in ``benchmarks/baseline.json``.

Invariants asserted every round (folded into the report's ``parity``):

- Q6 aggregates bit-identical to an independent ``MutableTable``
  oracle driven by the same mutation stream; Q1 identical to the numpy
  baseline — *including* the rounds right after repair.
- No post-mutation / post-repair query is ever served from the result
  cache (versions invalidate by construction).
- The service never raises to a caller (availability: faulted windows
  retry or degrade, they don't fail).

Run standalone (non-zero exit on any violation)::

    PYTHONPATH=src python -m repro_torch.faults.chaos --sf 0.002 --device cpu
"""
from __future__ import annotations

import argparse
import asyncio
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.faults.recovery import FaultManager

#: Attributes the hot-row UPDATE touches each round (all narrow enough
#: that every assigned value stays in width -> in-place plane rewrite).
HOT_ATTRS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
N_HOT = 8


def run_chaos(sf: float = 0.002, rounds: int = 6, batch: int = 64,
              seed: int = 7, inject: bool = True, device="cuda",
              on_manager: Optional[Callable[[FaultManager], None]] = None
              ) -> Dict[str, object]:
    """One full chaos soak on a fresh database on ``device``; returns the
    report. ``on_manager`` is called with the soak's
    :class:`FaultManager` before the first round (to read its scrub and
    read-back logs afterwards)."""
    from repro_torch.db import database, queries, tpch
    from repro_torch.dml import Delete, Insert, MutableTable, Update
    from repro_torch.serve import QueryService

    db = database.PimDatabase(tpch.generate(sf=sf, seed=0), device=device)
    layout = db.relations["lineitem"].layout
    u_bits = sum(layout.attributes[a].n_bits for a in HOT_ATTRS)
    # Budget sits 1.2 hot-updates past one full row write: the hot rows
    # (updated every round, zero bulk-load wear) cross it mid-run and
    # die — leaving at least one more round whose dropped update the
    # write-verify pass must catch — while a freshly remapped or
    # inserted row (one row write + a valid clear) stays safely under.
    budget = layout.row_bits + 1.2 * u_bits
    fm = FaultManager(db, endurance_budget=budget)
    fm.guard_relation("lineitem")
    if on_manager is not None:
        on_manager(fm)

    q1 = queries.get_query("Q1").filter_only()
    q6 = queries.get_query("Q6").filter_only()
    spec6 = queries.get_query("Q6")
    oracle = MutableTable(db.tables["lineitem"])
    src = {a: np.asarray(c) for a, c in db.tables["lineitem"].items()}
    n0 = oracle.n_rows
    capacity = layout.capacity_records
    rng = np.random.default_rng(seed)
    hot_ids = list(range(N_HOT))

    # Scheduled cell injections: round -> (attr, slot, plane, kind).
    # Slots avoid the hot rows (so soft stays soft) and the append
    # region; the ghost slot (capacity-1) is never allocated at these
    # scales (n0 + rounds*batch + remaps << capacity growth threshold).
    ep0 = np.asarray(oracle.columns()["l_extendedprice"])
    stuck_slot = None
    for s in range(16, n0):
        if (int(ep0[s]) >> 0) & 1 == 0:   # stored bit 0 -> stuck-at-1
            stuck_slot = s                # is immediately observable
            break
    cell_faults = {
        1: ("l_quantity", 20, 0, "flip"),
        2: ("__valid__", capacity - 1, 0, "flip"),
        3: ("l_extendedprice", stuck_slot, 0, "stuck1"),
        4: ("l_extendedprice", 100, 5, "flip"),
    }
    # Transient dispatch faults queued at end of round -> count.
    # 1 @ r0: next window retries once and succeeds.
    # 6 @ r2: two windows exhaust retries (3 attempts each), degrade,
    #         and trip the breaker; r4 runs degraded then half-open
    #         probes; the probe succeeds and closes the breaker.
    dispatch_faults = {0: 1, 2: 6}

    inject_round: Dict[tuple, int] = {}
    latency = {"rounds": 0}
    seen_detected: set = set()
    violations: List[str] = []

    async def soak():
        svc = QueryService(db, max_window=4, max_wait_s=0.001,
                           fault_manager=fm)
        prev_ids: List[int] = []
        async with svc:
            t0 = time.perf_counter()
            for rnd in range(rounds):
                # 1. DML: rolling batch + hot in-place updates.
                idx = rng.integers(0, n0, batch)
                muts = [Insert("lineitem",
                               {a: c[idx] for a, c in src.items()})]
                if prev_ids:
                    muts.append(Delete("lineitem", row_ids=prev_ids))
                muts.append(Update(
                    "lineitem",
                    {"l_quantity": (rnd * 7) % 50 + 1,
                     "l_extendedprice": 100 + rnd,
                     "l_discount": rnd % 10,
                     "l_tax": rnd % 8},
                    row_ids=hot_ids))
                await svc.apply(muts)
                new_ids = oracle.insert(muts[0].rows)
                for m in muts[1:]:
                    oracle.apply(m)
                prev_ids = new_ids
                # 2. Endurance: worn rows die (latently).
                if inject:
                    fm.update_wear("lineitem")
                # 3. Integrity scrub: detect + repair before queries.
                await svc.scrub()
                for key in fm.detected - seen_detected:
                    seen_detected.add(key)
                    if key in inject_round:
                        latency["rounds"] += rnd - inject_round[key]
                # 4. Analytics: parity + staleness asserted per round.
                r1 = await svc.submit(q1)
                r6 = await svc.submit(q6)
                exp = oracle.aggregate(spec6.filters["lineitem"],
                                       spec6.aggregates)
                got = tuple(r6.aggregates["all"][a.name]
                            for a in spec6.aggregates)
                if exp != got:
                    violations.append(f"r{rnd}: Q6 != oracle")
                if r1.aggregates != db.run_baseline(q1).aggregates:
                    violations.append(f"r{rnd}: Q1 != baseline")
                if r1.cached or r6.cached:
                    violations.append(f"r{rnd}: stale cache serve")
                # 5. Scheduled injections (detected by NEXT scrub).
                if inject and rnd in cell_faults:
                    attr, slot, plane, kind = cell_faults[rnd]
                    if kind == "flip":
                        fm.inject_flip("lineitem", attr, slot, plane)
                    else:
                        fm.inject_stuck("lineitem", attr, slot, plane, 1)
                    inject_round[("lineitem", attr, slot)] = rnd
                if inject and rnd in dispatch_faults:
                    fm.model.inject_dispatch_faults(dispatch_faults[rnd])
            wall = time.perf_counter() - t0
        return svc, wall

    fm.arm()
    try:
        svc, wall = asyncio.run(soak())
    finally:
        fm.disarm()

    stats = svc.stats()
    undetected = fm.undetected()
    if undetected:
        violations.append(f"undetected faults: {sorted(undetected)}")
    if stats["errors"]:
        violations.append(f"{stats['errors']} service errors")
    n_queries = 2 * rounds
    return {
        "ok": not violations,
        "violations": violations,
        "parity": not any("oracle" in v or "baseline" in v
                          for v in violations),
        "all_detected": not undetected,
        "rounds": rounds,
        "batch": batch,
        "wall_s": wall,
        "n_queries": n_queries,
        "qps": n_queries / wall if wall else 0.0,
        "injected": fm.n_injected,
        "detected_injected": len(fm.detected & fm.injected),
        "detect_latency_rounds": latency["rounds"],
        "write_faults": fm.n_write_faults,
        "worn_dead": fm.n_worn_dead,
        "repaired_rows": fm.n_repaired_rows,
        "remapped_rows": fm.n_remapped_rows,
        "retired_slots": db.dml_state("lineitem").segments.n_retired,
        "scrubs": fm.n_scrubs,
        "dispatches": stats["dispatches"],
        "transient_faults": stats["transient_faults"],
        "retries": stats["retries"],
        "degraded_windows": stats["degraded_windows"],
        "recovered_queries": stats["fault_recovered"],
        "breaker_state": fm.breaker.state,
        "breaker_trips": fm.breaker.n_trips,
        "breaker_recoveries": fm.breaker.n_recoveries,
    }


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=0.002)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--no-inject", action="store_true",
                    help="clean control run (no faults)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the relations live (default cuda; cpu "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    rep = run_chaos(sf=args.sf, rounds=args.rounds, seed=args.seed,
                    inject=not args.no_inject, device=args.device)
    for k in ("ok", "parity", "all_detected", "injected",
              "detected_injected", "detect_latency_rounds", "write_faults",
              "worn_dead", "repaired_rows", "remapped_rows", "dispatches",
              "transient_faults", "retries", "degraded_windows",
              "recovered_queries", "breaker_state", "breaker_trips",
              "breaker_recoveries", "qps"):
        print(f"{k}: {rep[k]}")
    if not rep["ok"]:
        print("VIOLATIONS:")
        for v in rep["violations"]:
            print(f"  - {v}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
