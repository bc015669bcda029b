"""Sequential driver: every (arch x shape x mesh) cell as a subprocess of
``repro_torch.launch.dryrun`` (a fresh process a cell), cached in
``results/dryrun_torch/``::

    PYTHONPATH=src python -m repro_torch.launch.run_all_dryruns
"""
import os
import pathlib
import subprocess
import sys
import time

from ..configs import SHAPES
from .dryrun import cell_path

ROOT = pathlib.Path(__file__).resolve().parents[3]

# cells whose sequence loops (a Python step a token) are too slow to run
# whole on fake tensors; their costs use the S-fit method
HEAVY = {("xlstm-1.3b", "prefill_32k"), ("zamba2-7b", "prefill_32k"),
         ("zamba2-7b", "train_4k"), ("xlstm-1.3b", "train_4k")}

# cheap archs first so the table fills early
ORDER = ["qwen2-0.5b", "qwen1.5-0.5b", "whisper-small", "olmoe-1b-7b",
         "xlstm-1.3b", "stablelm-3b", "paligemma-3b", "gemma2-9b",
         "zamba2-7b", "llama4-maverick-400b-a17b"]


def main():
    cells = [(arch, shape, multi) for arch in ORDER for shape in SHAPES
             for multi in (False, True)]
    t0 = time.time()
    for i, (arch, shape, multi) in enumerate(cells):
        out = cell_path(arch, shape, multi)
        if out.exists():
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape]
        if multi:
            cmd.append("--multipod")
        if (arch, shape) in HEAVY:
            cmd.append("--seq-extrapolate")
        print(f"[{i + 1}/{len(cells)} t={time.time() - t0:.0f}s] {arch} "
              f"{shape} {'multi' if multi else 'single'}", flush=True)
        try:
            subprocess.run(cmd, cwd=ROOT, timeout=5400,
                           env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        except subprocess.TimeoutExpired:
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(
                '{"arch": "%s", "shape": "%s", "status": "error", '
                '"error": "timeout (>5400 s on fake tensors)"}'
                % (arch, shape))
            print("TIMEOUT", arch, shape, flush=True)
    print("ALL CELLS DONE", flush=True)


if __name__ == "__main__":
    main()
