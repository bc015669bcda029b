"""Serving driver: a PIMDB query-trace replay through ``QueryService``.

The counterpart of the ``--mode db`` half of ``repro.launch.serve``
(its ``--mode lm`` decode loop belongs to the language-model scaffolding,
which the port does not hold). Replays a query trace (comma-separated
TPC-H names, with ``xN`` repeats, e.g. ``Q1,Q6x3,Q3``) through the async
``repro_torch.serve.QueryService`` at fixed concurrency, and reports qps,
p50/p99 latency, dispatch/plane-read totals and cache behaviour.
``--compare`` also runs the same trace as a sequential ``db.execute``
loop, for the speedup and an explicit bit-parity check (exit 1 on a
mismatch)::

    PYTHONPATH=src python -m repro_torch.launch.serve --mode db \\
        --sf 0.002 --device cpu --compare

``--device cuda`` (the default) keeps the relations on the card.
"""
from __future__ import annotations

import argparse
import asyncio
import os
import sys
import time

DEFAULT_TRACE = "Q1,Q6,Q14,Q3,Q12,Q6,Q14,Q1,Q6,Q19,Q3,Q6,Q14,Q12,Q1,Q6"


def parse_trace(trace: str):
    """``Q1,Q6x3,Q3`` -> [Q1, Q6, Q6, Q6, Q3] QuerySpecs."""
    from repro_torch.db import queries
    specs = []
    for tok in trace.split(","):
        tok = tok.strip()
        if not tok:
            continue
        name, _, rep = tok.partition("x")
        specs.extend(queries.get_query(name) for _ in range(int(rep or 1)))
    return specs


def serve_trace(db, specs, *, concurrency: int = 8, max_window: int = 8,
                max_wait_s: float = 0.002, cache_capacity: int = 256):
    """Replay ``specs`` through a QueryService at fixed concurrency.
    Returns (results in trace order, service stats, wall seconds)."""
    from repro_torch.serve import QueryService

    async def run():
        svc = QueryService(db, max_window=max_window, max_wait_s=max_wait_s,
                           cache_capacity=cache_capacity,
                           max_pending=max(concurrency, max_window))
        gate = asyncio.Semaphore(concurrency)

        async def one(spec):
            async with gate:
                return await svc.submit(spec)

        async with svc:
            t0 = time.perf_counter()
            results = await asyncio.gather(*[one(s) for s in specs])
            wall = time.perf_counter() - t0
            stats = svc.stats()
        return results, stats, wall

    return asyncio.run(run())


def _arm_watchdog(timeout_s: float):
    """Hard wall-clock limit for a replay run: if the deadline passes,
    kill the whole process with exit code 124 (the ``timeout(1)``
    convention) — a wedged event loop or dispatch worker must fail CI,
    never hang it.  Returns the started timer (daemon thread)."""
    import threading

    def die():
        sys.stderr.write(
            f"serve replay exceeded --timeout-s={timeout_s}; aborting\n")
        sys.stderr.flush()
        os._exit(124)

    t = threading.Timer(timeout_s, die)
    t.daemon = True
    t.start()
    return t


def serve_db_main(args) -> None:
    from repro_torch.db import Engine, PimDatabase, tpch

    watchdog = _arm_watchdog(args.timeout_s) if args.timeout_s else None
    tables = tpch.generate(sf=args.sf, seed=args.seed)
    db = PimDatabase(tables, device=args.device)
    specs = parse_trace(args.trace)
    print(f"replaying {len(specs)} queries (sf={args.sf}, "
          f"device={args.device}, concurrency={args.concurrency}, "
          f"window={args.window}, max_wait={args.max_wait_ms}ms)")
    # Warm the tape cache and the kernels so the replay measures serving.
    serve_trace(db, specs, concurrency=args.concurrency,
                max_window=args.window,
                max_wait_s=args.max_wait_ms / 1e3)
    results, stats, wall = serve_trace(
        db, specs, concurrency=args.concurrency, max_window=args.window,
        max_wait_s=args.max_wait_ms / 1e3)
    lat = stats["latency_ms"]
    print(f"served {len(results)} queries in {wall * 1e3:.1f} ms "
          f"({len(results) / wall:.1f} qps)")
    print(f"latency p50={lat['p50']:.2f}ms p99={lat['p99']:.2f}ms "
          f"mean={lat['mean']:.2f}ms")
    print(f"dispatches={stats['dispatches']} "
          f"plane_reads={stats['plane_reads']} "
          f"coalesced={stats['coalesced']} cache={stats['cache']}")
    print(f"batcher={stats['batcher']}")
    if args.compare:
        for s in specs:
            db.execute(s, engine=Engine.FUSED)      # warm
        t0 = time.perf_counter()
        seq = [db.execute(s, engine=Engine.FUSED) for s in specs]
        seq_wall = time.perf_counter() - t0
        # Explicit parity check with a non-zero exit: a bare assert is
        # stripped under -O and would let a silent mismatch pass CI.
        mismatched = [sr.spec.name for r, sr in zip(results, seq)
                      if r.rows != sr.rows or r.aggregates != sr.aggregates]
        if mismatched:
            print(f"PARITY FAILURE: service != sequential for "
                  f"{mismatched}", file=sys.stderr)
            sys.exit(1)
        print(f"sequential execute loop: {seq_wall * 1e3:.1f} ms "
              f"({len(specs) / seq_wall:.1f} qps) -> "
              f"service speedup {seq_wall / wall:.2f}x (bit-parity ok)")
    if watchdog is not None:
        watchdog.cancel()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=("db",), default="db",
                    help="db: the query-trace replay (the only mode here)")
    ap.add_argument("--sf", type=float, default=0.005)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the relations live (default cuda; cpu "
                         "runs the kernels' plain versions)")
    ap.add_argument("--trace", default=DEFAULT_TRACE)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--timeout-s", type=float, default=600.0,
                    help="hard wall-clock limit for the replay (exit 124 "
                         "on expiry; 0 disables)")
    serve_db_main(ap.parse_args(argv))


if __name__ == "__main__":
    main()
