"""Shared neural layers: the norms, the MLPs, RoPE, embeddings and the loss.

The counterpart of ``repro.models.layers``. Parameters live in
``nn.Module``s whose attribute names are the reference's pytree keys, so
``models.convert.load_reference_params`` can place a reference leaf by its
path. Each function mirrors the reference's dtype choices: where a step
runs in float32 and where it stays in the input dtype (bf16 models keep
their hidden stream in bf16). Parameters are made with
``requires_grad=False`` (serving builds no graph); training turns them on
with ``model.requires_grad_(True)``.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` as a torch dtype."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32


# A draw of more elements than this goes in blocks along dim 0, so its
# float32 transient stays at most this size (one of llama4-maverick's
# expert stacks is 5.4 G elements: 21.5 GB in float32 at once).
DRAW_BLOCK = 1 << 26


class Init:
    """Draws a model's weights with the reference's distributions from one
    ``torch.Generator``, on the generator's device, then moves them to
    ``device``. The draws need not equal JAX's: tests carry the
    reference's weights across. On the ``meta`` device nothing is drawn
    or allocated (``generator`` may be ``None``): the model then only
    names its parameters' shapes and dtypes."""

    def __init__(self, device, generator: Optional[torch.Generator]):
        self.device = torch.device(device)
        self.generator = generator

    def _param(self, t: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(t.to(self.device), requires_grad=False)

    def normal(self, shape, scale: Optional[float] = None,
               dtype=torch.float32) -> nn.Parameter:
        """``normal(shape) * scale`` drawn in float32, then cast; the
        reference's ``_init`` (scale defaults to ``1 / sqrt(shape[0])``).
        Past ``DRAW_BLOCK`` elements it is drawn and cast a block of rows
        at a time, into the output dtype."""
        shape = tuple(shape)
        if self.device.type == "meta":
            return self._param(torch.empty(shape, dtype=dtype,
                                           device="meta"))
        if scale is None:
            scale = 1.0 / np.sqrt(shape[0])
        gen = self.generator
        n = math.prod(shape)
        if n <= DRAW_BLOCK:
            t = torch.randn(shape, generator=gen, device=gen.device,
                            dtype=torch.float32)
            return self._param((t * scale).to(dtype))
        out = torch.empty(shape, dtype=dtype, device=self.device)
        rows = max(1, DRAW_BLOCK // math.prod(shape[1:]))
        for r in range(0, shape[0], rows):
            t = torch.randn((min(rows, shape[0] - r),) + shape[1:],
                            generator=gen, device=gen.device,
                            dtype=torch.float32)
            out[r:r + rows] = (t * scale).to(dtype)
        return nn.Parameter(out, requires_grad=False)

    def full(self, shape, value: float, dtype=torch.float32) -> nn.Parameter:
        dev = "meta" if self.device.type == "meta" else "cpu"
        return self._param(torch.full(tuple(shape), value, dtype=dtype,
                                      device=dev))

    def cat(self, *parts: torch.Tensor) -> nn.Parameter:
        return self._param(torch.cat(parts))


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def _sumsq(x: torch.Tensor) -> torch.Tensor:
    """``einsum("...d,...d->...", x, x, preferred_element_type=f32)``."""
    xf = x.float()
    return (xf * xf).sum(-1)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    """Gemma-style RMSNorm: the mean square in float32, the scaling in the
    input dtype, the output scaled by ``(1 + scale)``."""
    ss = _sumsq(x) / x.shape[-1]
    inv = torch.rsqrt(ss + eps)[..., None]
    return (x * inv.to(x.dtype)) * (1.0 + scale).to(x.dtype)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5):
    """LayerNorm with the variance as ``max(E[x^2] - mu^2, 0)`` in float32;
    centring and scaling in the input dtype."""
    d = x.shape[-1]
    mu = (x.sum(-1, dtype=torch.float32) / d)[..., None]
    ss = _sumsq(x) / d
    var = torch.clamp(ss[..., None] - mu * mu, min=0.0)
    inv = torch.rsqrt(var + eps)
    xc = x - mu.to(x.dtype)
    return xc * inv.to(x.dtype) * scale.to(x.dtype) + bias.to(x.dtype)


class Norm(nn.Module):
    """``rmsnorm`` (``scale`` starts at 0) or ``layernorm`` (``scale`` 1,
    ``bias`` 0); float32 parameters whatever the model's dtype."""

    def __init__(self, kind: str, d: int, init: Init):
        super().__init__()
        self.kind = kind
        if kind == "rmsnorm":
            self.scale = init.full((d,), 0.0)
        else:
            self.scale = init.full((d,), 1.0)
            self.bias = init.full((d,), 0.0)

    def forward(self, x):
        if self.kind == "rmsnorm":
            return rmsnorm(self.scale, x)
        return layernorm(self.scale, self.bias, x)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class MLP(nn.Module):
    """The reference's ``_mlp_init``/``_mlp_apply`` (and with
    ``act="swiglu"`` its ``swiglu_init``/``swiglu``): ``swiglu``/``geglu``
    (``w_gate``, ``w_up``, ``w_down``) or ``gelu`` (``w_in``, ``w_down``);
    ``d_ff == 0`` holds nothing and adds zeros."""

    def __init__(self, d: int, d_ff: int, act: str, init: Init, dtype):
        super().__init__()
        self.act = act
        self.empty = d_ff == 0
        if self.empty:
            return
        if act == "gelu":
            self.w_in = init.normal((d, d_ff), dtype=dtype)
        else:
            self.w_gate = init.normal((d, d_ff), dtype=dtype)
            self.w_up = init.normal((d, d_ff), dtype=dtype)
        self.w_down = init.normal((d_ff, d), dtype=dtype)

    def forward(self, x):
        if self.empty:
            return torch.zeros_like(x)
        if self.act == "gelu":
            h = gelu((x @ self.w_in).float()).to(x.dtype)
            return h @ self.w_down
        g = x @ self.w_gate
        u = x @ self.w_up
        act = gelu if self.act == "geglu" else F.silu
        h = act(g.float()).to(x.dtype) * u
        return h @ self.w_down


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


# --------------------------------------------------------------------------
# positions
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=64)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    """``rope_freqs`` as float32 on ``device``, copied there once: a copy a
    call would wait for the device's queue at every layer of a decode
    step."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq).

    Rotates split halves (not interleaved pairs). The angles, cos and sin
    are float32, cast to the input dtype; the rotation runs in it.
    """
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, float(theta), x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., :, None, :].to(x.dtype)
    sin = torch.sin(ang)[..., :, None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def sinusoidal_pos(length: int, d: int, dtype=torch.bfloat16, offset: int = 0,
                   device="cuda"):
    """Whisper-style sinusoidal position embeddings, computed on the fly."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None] \
        + offset
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos * torch.exp(-dim * (math.log(10000.0) / max(1, d // 2 - 1)))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# --------------------------------------------------------------------------
# embeddings and the loss
# --------------------------------------------------------------------------
class Embed(nn.Module):
    """A ``(vocab, d)`` table drawn from ``normal * 1.0``."""

    def __init__(self, vocab: int, d: int, init: Init, dtype):
        super().__init__()
        self.table = init.normal((vocab, d), scale=1.0, dtype=dtype)


def embed(p: Embed, ids):
    return p.table[ids]


def unembed(x, table):
    """``einsum("...d,vd->...v", x, table)``."""
    return x @ table.T


def cross_entropy(logits, labels, z_loss: float = 1e-4):
    """Mean cross entropy over tokens in float32, plus ``z_loss * lse^2``.
    The row max carries no gradient (the reference's ``stop_gradient``)."""
    lf = logits.float()
    m = lf.max(-1, keepdim=True).values.detach()
    shifted = lf - m
    lse = torch.log(torch.exp(shifted).sum(-1)) + m[..., 0]
    ll = shifted.gather(-1, labels[..., None].long())[..., 0] + m[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss.mean()
