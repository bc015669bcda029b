"""Optimizers on trees of tensors: AdamW and Adafactor, the WSD schedule
and the global-norm clip.

The counterpart of ``repro.optim.optimizers``, with its math, defaults
and dtypes: plain functions of (params, grads, state) that return new
trees, every update in float32 and cast back to the parameter's dtype (no
master weights). A tree is nested dicts, tuples and NamedTuples of
tensors, ``None`` holding no leaf; leaves are visited in ``jax.tree``
order (dict keys sorted). Each rule that depends on a leaf's shape
(AdamW's decay of matrices, Adafactor's factoring and its RMS clip) sees
the leaf it is given, so a model's parameters go in in the reference's
layout (``models.convert.reference_tree``): a stacked group's layers are
one leaf. ``torch.optim.AdamW`` is another function (its bias
correction, ``eps`` and decay differ).
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, List, NamedTuple

import torch


# --------------------------------------------------------------------------
# trees
# --------------------------------------------------------------------------
def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same places of ``rest``,
    in ``tree_leaves`` order; the result has ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """``tree``'s structure holding ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _device(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


class OptState(NamedTuple):
    step: torch.Tensor          # () int32, the updates taken
    inner: Any


# --------------------------------------------------------------------------
# schedule
# --------------------------------------------------------------------------
def wsd_schedule(peak_lr: float, warmup: int = 100, total: int = 10000,
                 min_frac: float = 0.1):
    """Warmup, stable, decay: a function of the step (a tensor) giving the
    float32 learning rate."""
    def lr(step):
        s = torch.as_tensor(step).float()
        warm = s / max(1, warmup)
        decay = 1.0 - (1.0 - min_frac) * torch.clamp(
            (s - warmup) / max(1, total - warmup), min=0.0)
        return peak_lr * torch.minimum(warm, torch.clamp(decay, max=1.0))
    return lr


def clip_by_global_norm(grads, max_norm: float = 1.0):
    """Scale every leaf by min(1, max_norm / (norm + 1e-6)), the norm's
    squares summed in float32 over all leaves. Returns (grads, norm)."""
    g2 = sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads))
    norm = torch.sqrt(g2)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------
class AdamState(NamedTuple):
    m: Any
    v: Any


def adamw_init(params) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(torch.zeros((), dtype=torch.int32, device=_device(params)),
                    AdamState(tree_map(zeros, params),
                              tree_map(zeros, params)))


def adamw_update(params, grads, state: OptState, lr_fn,
                 b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    step = state.step + 1
    lr = lr_fn(step)
    b1t = 1 - torch.pow(b1, step.float())
    b2t = 1 - torch.pow(b2, step.float())

    def upd(p, g, m, v):
        gf = g.float()
        m_new = b1 * m + (1 - b1) * gf
        v_new = b2 * v + (1 - b2) * torch.square(gf)
        update = (m_new / b1t) / (torch.sqrt(v_new / b2t) + eps)
        if p.ndim >= 2:   # decoupled weight decay on matrices only
            update = update + weight_decay * p.float()
        return (p.float() - lr * update).to(p.dtype), m_new, v_new

    out = [upd(*leaves) for leaves in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state.inner.m),
        tree_leaves(state.inner.v))]
    new = [tree_unflatten(params, [o[i] for o in out]) for i in range(3)]
    return new[0], OptState(step, AdamState(new[1], new[2]))


# --------------------------------------------------------------------------
# Adafactor (factored second moment; bf16 accumulators)
# --------------------------------------------------------------------------
class FactorState(NamedTuple):
    vr: Any     # row accumulators (or full v for <2D leaves)
    vc: Any     # col accumulators (or (1,) zeros for <2D leaves)


def _factored(p) -> bool:
    return p.ndim >= 2


def adafactor_init(params, state_dtype=torch.bfloat16) -> OptState:
    def vr(p):
        if _factored(p):
            return torch.zeros(p.shape[:-1], dtype=state_dtype,
                               device=p.device)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def vc(p):
        if _factored(p):
            return torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=state_dtype,
                               device=p.device)
        return torch.zeros((1,), dtype=state_dtype, device=p.device)
    return OptState(torch.zeros((), dtype=torch.int32, device=_device(params)),
                    FactorState(tree_map(vr, params), tree_map(vc, params)))


def adafactor_update(params, grads, state: OptState, lr_fn,
                     decay=0.99, eps=1e-30, clip_thresh=1.0):
    step = state.step + 1
    lr = lr_fn(step)

    def upd(p, g, vr, vc):
        gf = g.float()
        g2 = torch.square(gf) + eps
        if _factored(p):
            vr_new = decay * vr.float() + (1 - decay) * g2.mean(-1)
            vc_new = decay * vc.float() + (1 - decay) * g2.mean(-2)
            denom = (vr_new[..., None] * vc_new[..., None, :]
                     / torch.clamp(vr_new.mean(-1, keepdim=True)[..., None],
                                   min=eps))
            update = gf * torch.rsqrt(torch.clamp(denom, min=eps))
        else:
            vr_new = decay * vr + (1 - decay) * g2
            vc_new = vc
            update = gf * torch.rsqrt(torch.clamp(vr_new, min=eps))
        # update clipping (Adafactor RMS rule), over the whole leaf
        rms = torch.sqrt(torch.mean(torch.square(update)) + 1e-12)
        update = update / torch.clamp(rms / clip_thresh, min=1.0)
        new_p = (p.float() - lr * update).to(p.dtype)
        return new_p, vr_new.to(vr.dtype), vc_new.to(vc.dtype)

    out = [upd(*leaves) for leaves in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state.inner.vr),
        tree_leaves(state.inner.vc))]
    new = [tree_unflatten(params, [o[i] for o in out]) for i in range(3)]
    return new[0], OptState(step, FactorState(new[1], new[2]))


def make_optimizer(kind: str, peak_lr: float = 3e-4,
                   warmup: int = 100, total: int = 10000):
    """(init, update) of ``kind`` ("adamw" or "adafactor") on the WSD
    schedule; ``update(params, grads, state) -> (params, state)``."""
    lr_fn = wsd_schedule(peak_lr, warmup, total)
    if kind == "adamw":
        return adamw_init, partial(adamw_update, lr_fn=lr_fn)
    if kind == "adafactor":
        return adafactor_init, partial(adafactor_update, lr_fn=lr_fn)
    raise ValueError(kind)
