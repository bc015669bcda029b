"""GPipe-style pipeline parallelism over a mesh axis, in one process.

The counterpart of ``repro.distributed.pipeline_parallel``. The layer
stack is split into ``n_stages`` contiguous groups laid out along a mesh
axis; stage s's parameters sit on the device of position s along that
axis (the other axes at 0), microbatches stream through a fill-drain
schedule, and activations move to the next stage's device with ``.to``
(the reference's ``collective_permute``). Bubble fraction =
(n_stages - 1) / (n_micro + n_stages - 1); 1F1B is left, as there, as
future work.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..core.distributed import Mesh
from .sharding import position_of, tree_map


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_apply(mesh: Mesh, stage_fn: Callable[[Any, torch.Tensor],
                                                  torch.Tensor],
                   stage_params: Any, x_micro: torch.Tensor,
                   axis: str = "model") -> torch.Tensor:
    """Run microbatched inputs ``x_micro`` (n_micro, mb, ...) through the
    stages on ``axis``. ``stage_params``: a tree whose leaves have a
    leading n_stages dim. For n_micro + n_stages - 1 ticks, stage s runs
    microbatch t - s where it exists; the last stage's outputs come back
    in microbatch order on the first stage's device."""
    n_stages = mesh.axis_size(axis)
    devs = [mesh.devices[position_of(mesh, {axis: s})]
            for s in range(n_stages)]
    params = [tree_map(lambda t: t[s].to(devs[s]), stage_params)
              for s in range(n_stages)]
    n_micro = x_micro.shape[0]
    bufs = [None] * n_stages          # the input each stage runs next
    outs = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        nxt = [None] * n_stages
        for s in range(n_stages):
            mb = t - s
            if not 0 <= mb < n_micro:
                continue
            cur = x_micro[mb].to(devs[0]) if s == 0 else bufs[s]
            y = stage_fn(params[s], cur)
            if s == n_stages - 1:
                outs[mb] = y.to(devs[0])
            else:
                nxt[s + 1] = y.to(devs[s + 1])
        bufs = nxt
    return torch.stack(outs)
