"""End-to-end training driver: data -> train step -> checkpoint/resume.

The counterpart of ``repro.launch.train`` on one device (``device``
stands where the reference has its mesh): the model from ``cfg`` with
weights drawn from ``generator`` (default: seeded with 0 on ``device``),
resume from the newest complete checkpoint, the bulk-bitwise example
selection (``data.pipeline.PimDataSelector`` over a 20,000-example
synthetic corpus, on ``device``), the deterministic token stream
fast-forwarded to the resumed step, async checkpoints every
``ckpt_every`` steps, and the losses returned::

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

``--device cuda`` (the default) trains on the card and fails where there
is none.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from ..checkpoint import checkpoint as ckpt
from ..configs import SHAPES, get_config, get_smoke_config
from ..configs.common import ShapeConfig
from ..data.pipeline import CorpusMeta, PimDataSelector, TokenBatcher
from ..models import convert
from ..models.lm import LM, require_cuda
from ..optim import optimizers as opt
from . import steps as steps_mod


def train(cfg, shape: ShapeConfig, steps: int = 20,
          ckpt_dir: str | None = None, ckpt_every: int = 10,
          resume: bool = True, log_every: int = 5,
          use_pim_selector: bool = True, device="cuda", generator=None,
          history: list | None = None):
    """Train to ``steps`` steps. Returns (model, opt_state, losses of the
    steps run). ``history``, where given, gets one dict a step: ``step``,
    ``loss``, ``grad_norm`` and ``seconds`` (host wall, to the loss on the
    host)."""
    require_cuda(device)
    model = LM(cfg, device=device, generator=generator)
    init_fn, _ = opt.make_optimizer(cfg.optimizer)
    train_step = steps_mod.build_train_step(cfg, shape, model)
    leaves = convert.reference_leaves(model)

    # --- init or resume ---
    opt_state = init_fn(convert.reference_params(model))
    start_step = 0
    if ckpt_dir and resume and ckpt.latest_step(ckpt_dir) is not None:
        start_step, tree = ckpt.restore(
            ckpt_dir, {"params": convert.reference_params(model),
                       "opt": opt_state}, device=device)
        convert.load_tree(leaves, tree["params"])
        opt_state = tree["opt"]
        print(f"resumed from step {start_step}")

    # --- data (bulk-bitwise example selection) ---
    if use_pim_selector:
        selector = PimDataSelector(CorpusMeta.synthetic(20000), device=device)
        admitted = selector.admit()
        print(f"PIM selector admitted {admitted.mean():.1%} of corpus")
    else:
        admitted = None
    batcher = TokenBatcher(cfg.vocab, shape.global_batch, shape.seq_len,
                           admitted)
    # resume-exactness: the deterministic stream is keyed by (epoch,
    # cursor); fast-forward so a restored run sees the same batches an
    # uninterrupted one would (loader state lives with the checkpoint).
    batcher.cursor = start_step

    losses = []
    pending = None
    t0 = time.time()
    for step in range(start_step, steps):
        ts = time.perf_counter()
        batch = steps_mod.to_device(batcher.next_batch(), device)
        opt_state, metrics = train_step(opt_state, batch)
        losses.append(float(metrics["loss"]))
        if history is not None:
            history.append({"step": step + 1, "loss": losses[-1],
                            "grad_norm": float(metrics["grad_norm"]),
                            "seconds": time.perf_counter() - ts})
        if log_every and (step + 1) % log_every == 0:
            print(f"step {step+1} loss={losses[-1]:.4f} "
                  f"({(time.time()-t0)/(step-start_step+1):.2f}s/step)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = ckpt.save(ckpt_dir, step + 1,
                                {"params": convert.reference_params(model),
                                 "opt": opt_state},
                                blocking=False)
    if pending is not None:
        pending.join()
    return model, opt_state, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, remat off, batch 4 x 64 tokens")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model trains (default cuda)")
    args = ap.parse_args(argv)

    if args.smoke:
        cfg = get_smoke_config(args.arch)
        cfg = dataclasses.replace(cfg, remat=False)
        shape = ShapeConfig("smoke", 64, 4, "train")
    else:
        cfg = get_config(args.arch)
        shape = SHAPES[args.shape]
    _, _, losses = train(cfg, shape, steps=args.steps,
                         ckpt_dir=args.ckpt_dir, device=args.device)
    return losses


if __name__ == "__main__":
    main()
