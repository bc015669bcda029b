"""End-to-end LM training: the data pipeline (with example selection by a
bulk-bitwise filter) -> the train step -> checkpoints -> resume.

The default is a ~11M-parameter dense stand-in that runs on a CPU;
``--big`` trains the ~100M config, sized for one accelerator::

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200 \
        [--ckpt-dir DIR] [--device cpu]

``--ckpt-dir`` checkpoints every 50 steps and resumes from the newest
complete checkpoint there. ``main(argv)`` returns the losses.
"""
import argparse

from repro_torch.configs.common import ModelConfig, ShapeConfig
from repro_torch.launch.train import train

SMALL = ModelConfig(                     # ~11M params: CPU-runnable
    name="lm-12m", family="dense", n_layers=4, d_model=256, n_heads=8,
    n_kv_heads=4, d_ff=1024, vocab=8192, block_pattern="dense", remat=False)

BIG = ModelConfig(                       # ~100M class
    name="lm-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=12, d_ff=3072, vocab=32768, block_pattern="dense")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default cuda)")
    args = ap.parse_args(argv)

    cfg = BIG if args.big else SMALL
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    _, _, losses = train(cfg, shape, steps=args.steps,
                         ckpt_dir=args.ckpt_dir, ckpt_every=50,
                         log_every=10, device=args.device)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} "
          f"steps")
    if not losses[-1] < losses[0]:
        raise SystemExit("loss must decrease")
    return {"losses": losses}


if __name__ == "__main__":
    main()
