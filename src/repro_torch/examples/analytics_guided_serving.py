"""Serving with bulk-bitwise request admission: the paper's technique at
the serving layer.

Request metadata (user tier, prompt length, region, rate bucket) is
bit-sliced into a relation on the device; the admission policy runs as
one bulk-bitwise filter over the whole queue (the eager engine's
``eq_imm``/``cmp_imm`` predicates), is checked against numpy, and then a
small admitted batch is greedy-decoded with the LM serving stack
(``launch.serve.serve``, the qwen2 smoke config, seeded random weights).

    PYTHONPATH=src python -m repro_torch.examples.analytics_guided_serving [--device cpu]

``main(argv)`` returns the numbers it prints.
"""
import argparse

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.core import engine
from repro_torch.db.compiler import And, Cmp, Col, Compiler, InSet, Lit
from repro_torch.launch.serve import serve

N_REQ = 50_000


def make_queue(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {
        "tier": rng.integers(0, 4, N_REQ),          # 0=free .. 3=enterprise
        "prompt_len": rng.integers(1, 8192, N_REQ),
        "region": rng.integers(0, 12, N_REQ),
        "rate_bucket": rng.integers(0, 100, N_REQ),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the queue and the model "
                         "(default cuda)")
    args = ap.parse_args(argv)
    queue = make_queue()

    rel = engine.PimRelation.from_columns("queue", queue, device=args.device)
    policy = And(InSet(Col("tier"), (2, 3)),            # paid tiers
                 Cmp("le", Col("prompt_len"), Lit(4096)),
                 Cmp("lt", Col("rate_bucket"), Lit(80)))
    c = Compiler(rel)
    mask_reg = c.compile_filter(policy)
    eng = engine.Engine(rel)
    eng.run(c.program)
    admitted = eng.read_mask(mask_reg)[:N_REQ]
    want = (np.isin(queue["tier"], (2, 3)) & (queue["prompt_len"] <= 4096)
            & (queue["rate_bucket"] < 80))
    if not (admitted == want).all():
        raise SystemExit(f"admission mask differs from numpy on "
                         f"{int((admitted != want).sum())} requests")
    n = int(admitted.sum())
    print(f"admission filter over {N_REQ} requests: {n} admitted "
          f"({admitted.mean():.1%}), equal to numpy; host read "
          f"{N_REQ // 8:,} B instead of {N_REQ * 4:,} B of metadata")

    cfg = get_smoke_config("qwen2-0.5b")
    seq, tps = serve(cfg, batch=4, prompt_len=1, gen_len=12,
                     device=args.device)
    print(f"decoded admitted batch: {seq.shape} at {tps:.0f} tok/s "
          f"({cfg.name}, {args.device})")
    return {"admitted": n, "shape": tuple(seq.shape), "tok_s": tps,
            "seq": seq}


if __name__ == "__main__":
    main()
