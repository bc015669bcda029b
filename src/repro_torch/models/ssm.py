"""Mamba2 (SSD) layer: the chunked state-space-duality form for a whole
sequence, the recurrence for one-token decode.

The counterpart of ``repro.models.ssm``. Per head h (P = head_dim,
N = d_state), scalar decay a_t in (0, 1):
    S_t = a_t * S_{t-1} + (dt_t x_t) B_t^T        (S in R^{P x N})
    y_t = S_t C_t + D x_t
Within a chunk a decay-weighted quadratic term, across chunks a loop over
the chunk-final states. The causal convolution is an elementwise sum in
the input dtype on the sequence path and an einsum on the decode path, as
in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from . import layers as L
from ..configs.common import SSMConfig


class SSMState(NamedTuple):
    conv: torch.Tensor     # (B, d_conv-1, d_inner) rolling conv buffer
    ssm: torch.Tensor      # (B, n_heads, head_dim, d_state) float32


class SSM(nn.Module):
    """The reference's ``ssm_init``: separate input projections
    ``w_z``/``w_x``/``w_B``/``w_C``/``w_dt``,
    the conv, ``A_log`` 0, ``dt_bias`` -2, ``D`` 1, ``norm_scale`` 1 and
    ``out_proj``."""

    def __init__(self, d_model: int, cfg: SSMConfig, init: L.Init, dtype):
        super().__init__()
        d_inner = cfg.expand * d_model
        n_heads = d_inner // cfg.head_dim
        self.w_z = init.normal((d_model, d_inner), dtype=dtype)
        self.w_x = init.normal((d_model, d_inner), dtype=dtype)
        self.w_B = init.normal((d_model, cfg.n_groups * cfg.d_state),
                               dtype=dtype)
        self.w_C = init.normal((d_model, cfg.n_groups * cfg.d_state),
                               dtype=dtype)
        self.w_dt = init.normal((d_model, n_heads), dtype=dtype)
        self.conv_w = init.normal((cfg.d_conv, d_inner), 0.2, dtype)
        self.conv_b = init.full((d_inner,), 0.0, dtype)
        self.A_log = init.full((n_heads,), 0.0)
        self.dt_bias = init.full((n_heads,), -2.0)
        self.D = init.full((n_heads,), 1.0)
        self.norm_scale = init.full((d_inner,), 1.0)
        self.out_proj = init.normal((d_inner, d_model), dtype=dtype)


def _split_proj(p: SSM, xw):
    return (xw @ p.w_z, xw @ p.w_x, xw @ p.w_B, xw @ p.w_C, xw @ p.w_dt)


def _gated_norm(p: SSM, y, z):
    yf = y.float() * F.silu(z.float())
    var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    return yf * torch.rsqrt(var + 1e-6) * p.norm_scale


def _heads(t, n_heads: int, n_groups: int):
    """Group tensors (..., G, N) broadcast or repeated to (..., H, N)."""
    if n_groups == 1:
        return t.expand(*t.shape[:-2], n_heads, t.shape[-1])
    return torch.repeat_interleave(t, n_heads // n_groups, dim=-2)


def ssm_apply(p: SSM, x, cfg: SSMConfig, chunk: int = 256):
    """Training/prefill path. x (B, S, d_model) -> (B, S, d_model)."""
    B_, S, d_model = x.shape
    d_inner = cfg.expand * d_model
    n_heads = d_inner // cfg.head_dim
    P, N = cfg.head_dim, cfg.d_state
    z, xs, Bc, Cc, dt = _split_proj(p, x)

    pad = xs.new_zeros((B_, cfg.d_conv - 1, d_inner))
    xpad = torch.cat([pad, xs], dim=1)
    xs = sum(xpad[:, i:i + S] * p.conv_w[i] for i in range(cfg.d_conv))
    xs = F.silu((xs + p.conv_b).float())

    dt = L.softplus(dt.float() + p.dt_bias)                   # (B,S,H)
    A = -torch.exp(p.A_log)
    log_a = dt * A[None, None, :]                              # <= 0
    xh = xs.reshape(B_, S, n_heads, P) * dt[..., None]
    Bh = _heads(Bc.reshape(B_, S, cfg.n_groups, N).float(), n_heads,
                cfg.n_groups)
    Ch = _heads(Cc.reshape(B_, S, cfg.n_groups, N).float(), n_heads,
                cfg.n_groups)

    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"ssm_apply: S={S} is not a multiple of chunk "
                         f"{chunk}")
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    S_prev = torch.zeros((B_, n_heads, P, N), dtype=torch.float32,
                         device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        la_c, x_c = log_a[:, c0:c0 + chunk], xh[:, c0:c0 + chunk]
        B_c, C_c = Bh[:, c0:c0 + chunk], Ch[:, c0:c0 + chunk]
        cums = torch.cumsum(la_c, dim=1)                        # (B,C,H)
        seg = cums[:, :, None, :] - cums[:, None, :, :]         # (B,s,t,H)
        M = torch.where(tri[None, :, :, None], torch.exp(seg), 0.0)
        scores = torch.einsum("bshv,bthv->bsth", C_c, B_c)
        y_diag = torch.einsum("bsth,bthp->bshp", scores * M, x_c)
        y_cross = torch.einsum("bshv,bsh,bhpv->bshp", C_c, torch.exp(cums),
                               S_prev)
        decay_to_end = torch.exp(cums[:, -1:, :] - cums)
        S_chunk = torch.einsum("bthv,bth,bthp->bhpv", B_c, decay_to_end, x_c)
        a_c = torch.exp(cums[:, -1, :])
        S_prev = S_prev * a_c[..., None, None] + S_chunk
        ys.append(y_diag + y_cross)
    y = torch.cat(ys, dim=1)
    y = y + p.D[None, None, :, None] * xs.reshape(B_, S, n_heads, P)
    y = _gated_norm(p, y.reshape(B_, S, d_inner), z)
    return y.to(x.dtype) @ p.out_proj


def ssm_decode(p: SSM, x, state: SSMState, cfg: SSMConfig):
    """Single-token decode. x (B, 1, d_model) -> (y, new SSMState)."""
    B_, _, d_model = x.shape
    d_inner = cfg.expand * d_model
    n_heads = d_inner // cfg.head_dim
    P, N = cfg.head_dim, cfg.d_state
    z, xs, Bc, Cc, dt = _split_proj(p, x[:, 0])

    conv_buf = torch.cat([state.conv, xs[:, None]], dim=1)      # (B,dc,d)
    xs = torch.einsum("bcd,cd->bd", conv_buf, p.conv_w) + p.conv_b
    xs = F.silu(xs.float())
    new_conv = conv_buf[:, 1:]

    dt = L.softplus(dt.float() + p.dt_bias)                      # (B,H)
    a = torch.exp(dt * -torch.exp(p.A_log))
    xh = xs.reshape(B_, n_heads, P) * dt[..., None]
    Bh = _heads(Bc.reshape(B_, cfg.n_groups, N).float(), n_heads,
                cfg.n_groups)
    Ch = _heads(Cc.reshape(B_, cfg.n_groups, N).float(), n_heads,
                cfg.n_groups)
    S_new = state.ssm * a[..., None, None] + torch.einsum(
        "bhp,bhv->bhpv", xh, Bh)
    y = torch.einsum("bhpv,bhv->bhp", S_new, Ch)
    y = y + p.D[None, :, None] * xs.reshape(B_, n_heads, P)
    y = _gated_norm(p, y.reshape(B_, d_inner), z)
    out = y.to(x.dtype) @ p.out_proj
    return out[:, None], SSMState(new_conv, S_new)


def ssm_init_state(batch: int, d_model: int, cfg: SSMConfig,
                   dtype=torch.bfloat16, device="cuda") -> SSMState:
    d_inner = cfg.expand * d_model
    n_heads = d_inner // cfg.head_dim
    return SSMState(
        torch.zeros((batch, cfg.d_conv - 1, d_inner), dtype=dtype,
                    device=device),
        torch.zeros((batch, n_heads, cfg.head_dim, cfg.d_state),
                    dtype=torch.float32, device=device))


def ssm_ref(p: SSM, x, cfg: SSMConfig):
    """Naive per-step recurrence oracle (tests)."""
    state = ssm_init_state(x.shape[0], x.shape[2], cfg, x.dtype, x.device)
    outs = []
    for t in range(x.shape[1]):
        y, state = ssm_decode(p, x[:, t:t + 1], state, cfg)
        outs.append(y)
    return torch.cat(outs, dim=1)
