"""Gradient compression for cross-pod all-reduce (int8 + error feedback).

The counterpart of ``repro.distributed.compression``: each leaf is
quantised to int8 with one float32 scale, ``max|g| / 127``, and
dequantised again (the round trip the compressed all-reduce payload
would take). Error feedback carries the quantisation error to the next
step. Trees as in ``optim.optimizers``; a model's gradients come in the
reference's layout, so a stacked group shares one scale, as there.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..optim.optimizers import tree_leaves, tree_map, tree_unflatten


def quantize_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    gf = g.float()
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: Any) -> Any:
    """Round-trip int8 quantisation of every leaf, in its dtype."""
    return tree_map(lambda g: dequantize_leaf(*quantize_leaf(g)).to(g.dtype),
                    grads)


def compress_with_feedback(grads: Any, residual: Any) -> Tuple[Any, Any]:
    """Error-feedback variant: grads' = Q(grads + residual); residual' =
    (grads + residual) - grads'."""
    new_g, new_r = [], []
    for g, r in zip(tree_leaves(grads), tree_leaves(residual)):
        acc = g.float() + r
        deq = dequantize_leaf(*quantize_leaf(acc))
        new_g.append(deq.to(g.dtype))
        new_r.append(acc - deq)
    return tree_unflatten(grads, new_g), tree_unflatten(grads, new_r)


def init_residual(grads_struct: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_struct)
