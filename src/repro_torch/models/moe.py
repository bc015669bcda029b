"""Mixture-of-Experts FFN: top-k routing, sort-based capacity dispatch.

The counterpart of ``repro.models.moe``. Token->expert assignments are
sorted by expert id (a stable sort), each gets its rank in its expert's
queue (dropped beyond the capacity), and tokens are gathered into a
dense (E, C, d) buffer per routing group that feeds a grouped einsum.
Dispatch and combine are gathers; scatters touch only integer index
vectors. The routing integers equal the reference's exactly.

With the experts over the mesh's ``model`` axis (expert parallelism), the
sharded steps set ``MoE.expert_pieces``: one ``(first expert, w_gate,
w_up, w_down)`` block a ``model`` coordinate, each on its position's
device. Each block then runs its own experts on the slots routed to them
and its outputs land in those experts' slots; the combine sums them. No
expert stack is gathered whole.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import layers as L
from ..configs.common import MoEConfig


class MoE(nn.Module):
    """The reference's ``moe_init``: ``router`` (d, E) float32, expert
    stacks ``w_gate``/``w_up`` (E, d, f) and ``w_down`` (E, f, d), and with
    ``n_shared`` a ``shared`` SwiGLU of width ``f * n_shared``."""

    def __init__(self, d_model: int, cfg: MoEConfig, init: L.Init, dtype):
        super().__init__()
        E, f = cfg.n_experts, cfg.d_ff_expert
        scale = 1.0 / np.sqrt(d_model)
        self.router = init.normal((d_model, E))
        self.w_gate = init.normal((E, d_model, f), scale, dtype)
        self.w_up = init.normal((E, d_model, f), scale, dtype)
        self.w_down = init.normal((E, f, d_model),
                                  scale / np.sqrt(f / d_model), dtype)
        self.shared = (L.MLP(d_model, f * cfg.n_shared, "swiglu", init, dtype)
                       if cfg.n_shared else None)
        self.expert_pieces = None


def _experts(bufs, w_gate, w_up, w_down, dtype):
    g = torch.einsum("becd,edf->becf", bufs, w_gate)
    u = torch.einsum("becd,edf->becf", bufs, w_up)
    h = F.silu(g.float()).to(dtype) * u
    return torch.einsum("becf,efd->becd", h, w_down)


def top_k(logits, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties toward
    the lower index."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route_indices(logits, cfg: MoEConfig, capacity: int):
    """One routing group's bookkeeping, integer tensors only.

    Returns (src, slots_tk, weights, keep_tk):
      src      (E*C,)  source-token index of every dispatch slot (S = empty)
      slots_tk (S, k)  dispatch slot of each (token, choice) (E*C = dropped)
      weights  (S, k)  softmaxed router weights
      keep_tk  (S, k)  survived the capacity
    """
    S = logits.shape[0]
    k, E = cfg.top_k, cfg.n_experts
    dev = logits.device
    weights, sel = top_k(logits, k)
    weights = torch.softmax(weights, dim=-1)

    flat_e = sel.reshape(-1)
    flat_t = torch.arange(S, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    t_sorted = flat_t[order]
    group_start = torch.searchsorted(e_sorted, e_sorted, side="left")
    rank = torch.arange(S * k, device=dev) - group_start
    keep = rank < capacity
    slot = torch.where(keep, e_sorted * capacity + rank,
                       torch.full_like(rank, E * capacity))
    # slot -> source token; the dropped choices all land on the sentinel
    # slot E*C, which is sliced off.
    src = torch.full((E * capacity + 1,), S, dtype=torch.int64, device=dev)
    src[slot] = t_sorted
    src = src[:-1]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(S * k, device=dev)
    return src, slot[inv].reshape(S, k), weights, keep[inv].reshape(S, k)


def default_capacity(S: int, cfg: MoEConfig) -> int:
    """``max(4, min(ceil(S*k/E * cf), S*k))`` per routing group."""
    k, E = cfg.top_k, cfg.n_experts
    return max(4, min(int(math.ceil(S * k / E * cfg.capacity_factor)), S * k))


def moe_apply(p: MoE, x, cfg: MoEConfig, capacity: int | None = None,
              seq_groups: int = 1, shard_fn=None):
    """x (B, S, d) -> (B, S, d). Routing groups are batch rows (times
    ``seq_groups`` slices of each row); the k-way combine accumulates in
    the input dtype, one choice at a time. ``shard_fn(x, kind)``: the
    reference's activation-sharding hook, at its three call sites."""
    shard = shard_fn or (lambda t, kind: t)
    B0, S0, d = x.shape
    if seq_groups > 1 and S0 % seq_groups == 0:
        x = x.reshape(B0 * seq_groups, S0 // seq_groups, d)
        x = shard(x, "moe_group")
    B, S, _ = x.shape
    k, E = cfg.top_k, cfg.n_experts
    if capacity is None:
        capacity = default_capacity(S, cfg)

    logits = torch.einsum("bsd,de->bse", x.float(),
                          p.router.to(x.dtype).float())
    routes = [_route_indices(logits[b], cfg, capacity) for b in range(B)]
    src = torch.stack([r[0] for r in routes])
    slots_tk = torch.stack([r[1] for r in routes])
    weights = torch.stack([r[2] for r in routes])
    keep_tk = torch.stack([r[3] for r in routes])

    x_pad = torch.cat([x, x.new_zeros((B, 1, d))], dim=1)
    bufs = torch.gather(x_pad, 1, src[..., None].expand(B, E * capacity, d))
    bufs = shard(bufs.reshape(B, E, capacity, d), "moe_buf")
    if p.expert_pieces is None:
        out_buf = _experts(bufs, p.w_gate, p.w_up, p.w_down, x.dtype)
    else:
        outs = []
        for e0, wg, wu, wd in p.expert_pieces:
            part = bufs[:, e0:e0 + wg.shape[0]].to(wg.device)
            outs.append(_experts(part, wg, wu, wd, x.dtype).to(x.device))
        out_buf = torch.cat(outs, dim=1)
    flat_out = shard(out_buf.reshape(B, E * capacity, d),
                     "moe_group" if seq_groups > 1 else "moe_buf3")
    flat_out = torch.cat([flat_out, flat_out.new_zeros((B, 1, d))], dim=1)

    out = x.new_zeros((B, S, d))
    for j in range(k):
        idx = torch.where(keep_tk[:, :, j], slots_tk[:, :, j],
                          torch.full_like(slots_tk[:, :, j], E * capacity))
        got = torch.gather(flat_out, 1, idx[..., None].expand(B, S, d))
        out = out + got * weights[:, :, j][..., None].to(x.dtype)
    if p.shared is not None:
        out = out + p.shared(x)
    if (B0, S0) != (B, S):
        out = out.reshape(B0, S0, d)
    return out


def moe_ref(p: MoE, x, cfg: MoEConfig):
    """Dense oracle: every expert on every token, the top-k combined (no
    capacity drop)."""
    B, S, d = x.shape
    tokens = x.reshape(-1, d)
    logits = tokens.float() @ p.router
    weights, sel = top_k(logits, cfg.top_k)
    weights = torch.softmax(weights, dim=-1)
    g = torch.einsum("td,edf->tef", tokens, p.w_gate)
    u = torch.einsum("td,edf->tef", tokens, p.w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    all_out = torch.einsum("tef,efd->ted", h, p.w_down)      # (T, E, d)
    sel_out = torch.gather(all_out, 1, sel[:, :, None].expand(-1, -1, d))
    out = (sel_out.float() * weights[:, :, None]).sum(1).to(x.dtype)
    if p.shared is not None:
        out = out + p.shared(tokens)
    return out.reshape(B, S, d)
