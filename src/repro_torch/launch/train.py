"""End-to-end training driver: data -> train step -> checkpoint/resume.

The counterpart of ``repro.launch.train``: the model from ``cfg`` with
weights drawn from ``generator`` (default: seeded with 0 on ``device``),
resume from the newest complete checkpoint, the bulk-bitwise example
selection (``data.pipeline.PimDataSelector`` over a 20,000-example
synthetic corpus, on ``device``), the deterministic token stream
fast-forwarded to the resumed step, async checkpoints every
``ckpt_every`` steps, and the losses returned::

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

``--device cuda`` (the default) trains on the card and fails where there
is none.

With ``mesh=`` (a ``launch.mesh`` mesh) the parameters and the optimizer
state are the reference plan's pieces on it and each step runs
``launch.steps.build_train_step(..., mesh=)``'s sharded step; before
anything is drawn, the plan's bytes of the positions that share a device
are held against its memory (``MemoryError`` with the plan's numbers: a
``train_4k`` step on a 16 x 16 mesh of one card does not fit). The CLI
trains on the reference's meshes, every position on ``--device``: the
production mesh (``--multipod`` for 2 x 16 x 16), and with ``--smoke``
``make_debug_mesh(1, 1)``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from ..checkpoint import checkpoint as ckpt
from ..configs import SHAPES, get_config, get_smoke_config
from ..configs.common import ShapeConfig
from ..data.pipeline import CorpusMeta, PimDataSelector, TokenBatcher
from ..distributed.sharded_steps import admit, plan_parts
from ..models import convert
from ..models.lm import LM, require_cuda
from ..optim import optimizers as opt
from . import steps as steps_mod
from .mesh import make_debug_mesh, make_production_mesh


def train(cfg, shape: ShapeConfig, steps: int = 20,
          ckpt_dir: str | None = None, ckpt_every: int = 10,
          resume: bool = True, log_every: int = 5,
          use_pim_selector: bool = True, device="cuda", generator=None,
          history: list | None = None, mesh=None):
    """Train to ``steps`` steps. Returns (model, opt_state, losses of the
    steps run); on a mesh (params as pieces, opt_state, losses).
    ``history``, where given, gets one dict a step: ``step``, ``loss``,
    ``grad_norm`` and ``seconds`` (host wall, to the loss on the host);
    on a mesh also ``moved_bytes``, the bytes the step moved between
    positions."""
    if mesh is not None:
        device = mesh.devices[0]
    require_cuda(device)
    init_fn, _ = opt.make_optimizer(cfg.optimizer)
    if mesh is None:
        model = LM(cfg, device=device, generator=generator)
        train_step = steps_mod.build_train_step(cfg, shape, model)
        leaves = convert.reference_leaves(model)
        opt_state = init_fn(convert.reference_params(model))

        def run_step(batch):
            nonlocal opt_state
            opt_state, metrics = train_step(opt_state, batch)
            return metrics

        def state():
            return {"params": convert.reference_params(model),
                    "opt": opt_state}
    else:
        step_fn = steps_mod.build_train_step(cfg, shape, mesh=mesh).fn
        mm = step_fn.mm
        n_slices = len(mm.batch_slices(shape.global_batch))
        admit(mesh, plan_parts(mm, "train", shape.global_batch // n_slices,
                               shape.seq_len, step_fn.o_struct,
                               step_fn.o_shard))
        model = mm.shard_model(LM(cfg, device=device, generator=generator))
        opt_state = step_fn.init_opt()

        def run_step(batch):
            nonlocal model, opt_state
            before = sum(mm.store.moved.values())
            model, opt_state, metrics = step_fn(model, opt_state, batch)
            metrics["moved_bytes"] = sum(mm.store.moved.values()) - before
            return metrics

        def state():
            return {"params": model, "opt": opt_state}

    # --- init or resume ---
    start_step = 0
    if ckpt_dir and resume and ckpt.latest_step(ckpt_dir) is not None:
        if mesh is None:
            start_step, tree = ckpt.restore(ckpt_dir, state(), device=device)
            convert.load_tree(leaves, tree["params"])
            opt_state = tree["opt"]
        else:
            start_step, tree = ckpt.restore(
                ckpt_dir, {"params": mm.p_struct, "opt": step_fn.o_struct},
                shardings={"params": mm.p_shard, "opt": step_fn.o_shard})
            model, opt_state = tree["params"], tree["opt"]
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
        metrics = run_step(batch)
        losses.append(float(metrics["loss"]))
        if history is not None:
            history.append({"step": step + 1, "loss": losses[-1],
                            "grad_norm": float(metrics["grad_norm"]),
                            "seconds": time.perf_counter() - ts,
                            **({} if mesh is None else
                               {"moved_bytes": metrics["moved_bytes"]})})
        if log_every and (step + 1) % log_every == 0:
            print(f"step {step+1} loss={losses[-1]:.4f} "
                  f"({(time.time()-t0)/(step-start_step+1):.2f}s/step)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = ckpt.save(ckpt_dir, step + 1, state(), blocking=False)
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
    ap.add_argument("--multipod", action="store_true",
                    help="the 2 x 16 x 16 production mesh")
    args = ap.parse_args(argv)

    if args.smoke:
        cfg = get_smoke_config(args.arch)
        cfg = dataclasses.replace(cfg, remat=False)
        shape = ShapeConfig("smoke", 64, 4, "train")
        mesh = make_debug_mesh(1, 1, device=args.device)
    else:
        cfg = get_config(args.arch)
        shape = SHAPES[args.shape]
        mesh = make_production_mesh(multi_pod=args.multipod,
                                    device=args.device)
    _, _, losses = train(cfg, shape, steps=args.steps,
                         ckpt_dir=args.ckpt_dir, device=args.device,
                         mesh=mesh)
    return losses


if __name__ == "__main__":
    main()
