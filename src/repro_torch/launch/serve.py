"""Serving drivers: the LM greedy decode loop, and a PIMDB query-trace
replay through ``QueryService``.

The counterpart of ``repro.launch.serve``.

``--mode lm`` (the default): builds ``--arch``'s model (``--smoke`` for
its reduced config) with seeded random weights, greedy-decodes a batch
of one-token prompts, and reports tokens/s::

    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --smoke \
        --device cpu

``--mode db``: replays a query trace (comma-separated TPC-H names, with
``xN`` repeats, e.g. ``Q1,Q6x3,Q3``) through the async
``repro_torch.serve.QueryService`` at fixed concurrency, and reports qps,
p50/p99 latency, dispatch/plane-read totals and cache behaviour.
``--compare`` also runs the same trace as a sequential ``db.execute``
loop, for the speedup and an explicit bit-parity check (exit 1 on a
mismatch)::

    PYTHONPATH=src python -m repro_torch.launch.serve --mode db \
        --sf 0.002 --device cpu --compare

``--device cuda`` (the default) keeps the model or the relations on the
card, and fails where there is none.
"""
from __future__ import annotations

import argparse
import asyncio
import os
import sys
import time

import torch


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def greedy_decode(model, tokens, max_len: int, *, cross=None,
                  cache_len=None):
    """Greedy-decode from first tokens (B, 1) to ``max_len`` positions
    through ``model.decode_step`` (``cross``: an encdec model's stacked
    cross K/V from ``encode``; ``cache_len``: the cache's slots, default
    ``max_len``). Returns (seq (B, max_len) numpy ids, tokens/s over the
    ``max_len - 1`` steps)."""
    cache = model.init_cache(tokens.shape[0], cache_len or max_len)
    if cross is not None:
        cache["cross"] = cross
    return _greedy(model.decode_step, cache, tokens, max_len, model.device)


def _greedy(step, cache, tokens, max_len: int, device):
    B = tokens.shape[0]
    out = [tokens]
    _sync(device)
    t0 = time.perf_counter()
    for pos in range(max_len - 1):
        logits, cache = step(cache, tokens, pos)
        tokens = logits[:, -1:].argmax(-1)
        out.append(tokens)
    seq = torch.cat(out, dim=1).cpu().numpy()
    dt = time.perf_counter() - t0
    return seq, B * (max_len - 1) / dt


def mesh_serving(cfg, mesh, batch: int, max_len: int, generator=None):
    """``serve``'s model on ``mesh``: its weights drawn as on one device
    (on the first position's device) and cut into the plan's pieces,
    leaf by leaf; its first tokens (and encdec frames, encoded on the
    mesh). Returns (step, params, cache, first tokens). Raises before
    drawing anything where the plan does not fit the devices."""
    from repro_torch.distributed import sharded_steps as ss
    from repro_torch.models.lm import LM, default_generator
    dev = mesh.devices[0]
    mm = ss.MeshModel(cfg, mesh)
    step = ss.MeshServeStep(mm)
    ss.admit(mesh, ss.plan_parts(
        mm, "decode", batch // len(mm.batch_slices(batch)), max_len,
        cache_struct=mm.model.init_cache(batch, max_len)))
    gen = generator if generator is not None else default_generator(dev)
    params = mm.shard_model(LM(cfg, device=dev, generator=gen))
    cross = None
    if cfg.block_pattern == "encdec":
        frames = torch.randn((batch, 64, cfg.d_model), generator=gen,
                             device=gen.device).to(torch.bfloat16)
        cross = ss.MeshPrefillStep(mm).encode(params, frames.to(dev))
    tokens = torch.randint(0, cfg.vocab, (batch, 1), generator=gen,
                           device=gen.device).to(dev)
    return step, params, step.init_cache(batch, max_len, cross=cross), tokens


@torch.inference_mode()
def serve(cfg, batch: int, prompt_len: int, gen_len: int, *, device="cuda",
          generator=None, mesh=None, max_len=None):
    """Build ``cfg``'s model with weights drawn from ``generator`` (default:
    seeded with 0 on ``device``), draw ``batch`` one-token prompts from it
    (and for encdec 64 stub frames, encoded into the cross cache), and
    greedy-decode ``prompt_len + gen_len`` positions. Returns (seq,
    tokens/s) like the reference's ``serve``; ``max_len``: the cache's
    slots (default ``prompt_len + gen_len``). With ``mesh`` the weights
    and the cache are the plan's pieces on it (``mesh_serving``; the same
    draws, so the same tokens as on one device)."""
    from repro_torch.models.lm import LM, default_generator
    n_pos = prompt_len + gen_len
    if mesh is not None:
        step, params, cache, tokens = mesh_serving(
            cfg, mesh, batch, max_len or n_pos, generator)
        return _greedy(lambda c, t, p: step(params, c, t, p), cache, tokens,
                       n_pos, mesh.devices[0])
    gen = generator if generator is not None else default_generator(device)
    model = LM(cfg, device=device, generator=gen)
    cross = None
    if cfg.block_pattern == "encdec":
        frames = torch.randn((batch, 64, cfg.d_model), generator=gen,
                             device=gen.device).to(torch.bfloat16)
        _, cross = model.encode(frames.to(device))
    tokens = torch.randint(0, cfg.vocab, (batch, 1), generator=gen,
                           device=gen.device).to(device)
    return greedy_decode(model, tokens, n_pos, cross=cross,
                         cache_len=max_len)


# -- PIMDB query-trace replay ------------------------------------------------
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


def serve_lm_main(args) -> None:
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = None
    if args.mesh:
        mesh = (make_debug_mesh(1, 1, device=args.device) if args.smoke else
                make_production_mesh(multi_pod=args.multipod,
                                     device=args.device))
    seq, tps = serve(cfg, args.batch, 1, args.gen_len, device=args.device,
                     mesh=mesh)
    where = args.device if mesh is None else \
        f"a {mesh.shape} mesh of {args.device}"
    print(f"decoded {seq.shape} at {tps:.1f} tok/s ({cfg.name} on {where})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=("lm", "db"), default="lm")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", action="store_true",
                    help="lm: serve on the production mesh (--smoke: the "
                         "(1, 1) debug mesh), every position on --device")
    ap.add_argument("--multipod", action="store_true",
                    help="lm --mesh: the 2 x 16 x 16 mesh")
    ap.add_argument("--sf", type=float, default=0.005)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model (lm) or the relations (db) live "
                         "(default cuda; cpu runs the kernels' plain "
                         "versions)")
    ap.add_argument("--trace", default=DEFAULT_TRACE)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--timeout-s", type=float, default=600.0,
                    help="hard wall-clock limit for the --mode db replay "
                         "(exit 124 on expiry; 0 disables)")
    args = ap.parse_args(argv)
    if args.mode == "db":
        serve_db_main(args)
    else:
        serve_lm_main(args)


if __name__ == "__main__":
    main()
