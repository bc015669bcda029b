"""Train, prefill and serve steps, on one device or on a mesh.

The counterpart of ``repro.launch.steps``. With no mesh each ``build_*``
returns a closure over a port ``LM`` (one device). The train step runs
the loss, the backward pass, the optional int8 gradient round trip, the
global-norm clip and the optimizer update, all on the reference's leaves
(``models.convert.reference_leaves``: a stacked group's layers are one
leaf, as in the reference's pytree), and writes the new parameters into
the model in place.

With ``mesh=`` each returns a ``StepBundle(fn, args)`` as the reference's
do: ``fn`` runs on the parameters (and the optimizer state, the cache) as
pieces of the reference's plan (``distributed.sharded_steps``), ``args``
are stand-ins for its inputs in the reference's layout, on the ``meta``
device (``launch.input_specs``), that ``fn.place(*args)`` turns into
zero pieces. ``_fsdp_augment``, ``opt_state_shardings`` and
``make_sharder`` compute the reference's specs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.common import ModelConfig, ShapeConfig
from ..core.distributed import Mesh
from ..distributed import sharded_steps as ss
from ..distributed.compression import compress_tree
from ..distributed.sharding import ShardingRules
from ..models import convert
from ..models.lm import LM
from ..optim import optimizers as opt
from . import input_specs as ispec

_fsdp_augment = ss.fsdp_augment
opt_state_shardings = ss.opt_state_shardings


@dataclasses.dataclass
class StepBundle:
    """Everything needed to run one (arch x shape x mesh) cell."""
    fn: Any                  # the step (a Mesh*Step)
    args: Tuple[Any, ...]    # meta stand-ins of its inputs


def make_sharder(rules: ShardingRules, cfg) -> ss.Sharder:
    """The activation-sharding hook for ``LM``: records the spec the
    reference would constrain each activation to (``last_specs[kind]``)
    and returns it unchanged."""
    return ss.Sharder(rules, cfg)


def to_device(batch: Dict, device) -> Dict:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: None if v is None else torch.as_tensor(v, device=device)
            for k, v in batch.items()}


def build_train_step(cfg: ModelConfig, shape: ShapeConfig,
                     model: Optional[LM] = None,
                     grad_compression: bool = False, *,
                     mesh: Optional[Mesh] = None):
    """No mesh: ``train_step(opt_state, batch) -> (opt_state, {"loss",
    "grad_norm"})`` for ``cfg.optimizer``; ``batch`` holds tensors on the
    model's device; the model's gradients are turned on. With ``mesh``: a
    ``StepBundle`` whose ``fn(params, opt_state, batch) -> (params,
    opt_state, metrics)`` takes them as pieces."""
    if mesh is not None:
        step = ss.MeshTrainStep(ss.MeshModel(cfg, mesh), grad_compression)
        return StepBundle(step, (step.mm.p_struct, step.o_struct,
                                 ispec.train_input_specs(cfg, shape)))
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
                     model: Optional[LM] = None, *,
                     mesh: Optional[Mesh] = None):
    """No mesh: ``serve_step(cache, tokens, pos) -> (logits, cache)``, one
    decode step, the cache written in place. With ``mesh``: a
    ``StepBundle`` whose ``fn(params, cache, tokens, pos)`` takes the
    parameters and the cache as pieces."""
    if mesh is not None:
        step = ss.MeshServeStep(ss.MeshModel(cfg, mesh))
        cache, tokens, pos = ispec.decode_input_specs(cfg, shape)
        return StepBundle(step, (step.mm.p_struct, cache, tokens, pos))

    def serve_step(cache, tokens, pos):
        return model.decode_step(cache, tokens, pos)
    return serve_step


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig,
                       model: Optional[LM] = None, *,
                       mesh: Optional[Mesh] = None):
    """No mesh: ``prefill_step(tokens, extra) -> logits`` (no graph). With
    ``mesh``: a ``StepBundle`` whose ``fn(params, tokens, extra)`` takes
    the parameters as pieces."""
    if mesh is not None:
        step = ss.MeshPrefillStep(ss.MeshModel(cfg, mesh))
        batch = ispec.train_input_specs(cfg, shape)
        return StepBundle(step, (step.mm.p_struct, batch["tokens"],
                                 batch["extra"]))

    @torch.inference_mode()
    def prefill_step(tokens, extra=None):
        return model.forward(tokens, extra)
    return prefill_step


def build_step(cfg: ModelConfig, shape: ShapeConfig,
               model: Optional[LM] = None, *, mesh: Optional[Mesh] = None):
    if shape.kind == "train":
        return build_train_step(cfg, shape, model, mesh=mesh)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, model, mesh=mesh)
    return build_serve_step(cfg, shape, model, mesh=mesh)
