"""Train, prefill and serve steps on one device.

The counterpart of ``repro.launch.steps`` without its sharding (the
mesh, ``make_sharder`` and the optimizer-state shardings come with the
mesh tooling): each ``build_*`` returns a closure over a port ``LM``.

The train step runs the loss, the backward pass, the optional int8
gradient round trip, the global-norm clip and the optimizer update, all
on the reference's leaves (``models.convert.reference_leaves``: a
stacked group's layers are one leaf, as in the reference's pytree), and
writes the new parameters into the model in place.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..configs.common import ModelConfig, ShapeConfig
from ..distributed.compression import compress_tree
from ..models import convert
from ..models.lm import LM
from ..optim import optimizers as opt


def to_device(batch: Dict, device) -> Dict:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: None if v is None else torch.as_tensor(v, device=device)
            for k, v in batch.items()}


def build_train_step(cfg: ModelConfig, shape: ShapeConfig, model: LM,
                     grad_compression: bool = False) -> Callable:
    """``train_step(opt_state, batch) -> (opt_state, {"loss",
    "grad_norm"})`` for ``cfg.optimizer``; ``batch`` holds tensors on the
    model's device. Turns the model's gradients on."""
    _, update_fn = opt.make_optimizer(cfg.optimizer)
    leaves = convert.reference_leaves(model)
    model.requires_grad_(True)

    def train_step(opt_state, batch):
        loss = model.loss(batch)
        loss.backward()
        grads = convert.reference_tree(leaves, lambda n, p: p.grad)
        model.zero_grad(set_to_none=True)
        if grad_compression:
            grads = compress_tree(grads)
        grads, gnorm = opt.clip_by_global_norm(grads)
        params = convert.reference_tree(leaves, lambda n, p: p.detach())
        new_params, opt_state = update_fn(params, grads, opt_state)
        convert.load_tree(leaves, new_params)
        return opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def build_serve_step(cfg: ModelConfig, shape: ShapeConfig,
                     model: LM) -> Callable:
    """``serve_step(cache, tokens, pos) -> (logits, cache)``: one decode
    step, the cache written in place."""
    def serve_step(cache, tokens, pos):
        return model.decode_step(cache, tokens, pos)
    return serve_step


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig,
                       model: LM) -> Callable:
    """``prefill_step(tokens, extra) -> logits`` (no graph)."""
    @torch.inference_mode()
    def prefill_step(tokens, extra=None):
        return model.forward(tokens, extra)
    return prefill_step


def build_step(cfg: ModelConfig, shape: ShapeConfig, model: LM) -> Callable:
    if shape.kind == "train":
        return build_train_step(cfg, shape, model)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, model)
    return build_serve_step(cfg, shape, model)
