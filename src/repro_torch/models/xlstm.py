"""xLSTM blocks: mLSTM (matrix memory, chunk-parallel) and sLSTM (scalar
memory, recurrent) — arXiv:2405.04517.

The counterpart of ``repro.models.xlstm``. The mLSTM is a gated linear
attention recurrence
    C_t = f_t C_{t-1} + i_t k_t v_t^T          (C in R^{hdk x hdv})
    n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t^T q_t) / max(|n_t . q_t|, 1)
computed in chunks (quadratic within a chunk, a loop across chunks), with
sigmoid forget and input gates. The sLSTM keeps per-cell scalar state
with block-diagonal recurrent weights and runs one step at a time.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from . import layers as L


class MLSTMState(NamedTuple):
    C: torch.Tensor     # (B, H, hdk, hdv)
    n: torch.Tensor     # (B, H, hdk)


class SLSTMState(NamedTuple):
    c: torch.Tensor     # (B, d_inner)
    n: torch.Tensor
    h: torch.Tensor


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------
class MLSTM(nn.Module):
    """The reference's ``mlstm_init``: ``w_q``/``w_k`` (d, d_inner/2),
    ``w_v``/``w_o`` (d, d_inner),
    float32 ``w_gates`` (d, 2H) with ``b_gates`` (0 for input, 3 for
    forget) and ``w_down`` (d_inner, d)."""

    def __init__(self, d_model: int, n_heads: int, init: L.Init, dtype,
                 proj_factor: int = 2):
        super().__init__()
        d_inner = proj_factor * d_model
        qk_dim = d_inner // 2
        self.w_q = init.normal((d_model, qk_dim), dtype=dtype)
        self.w_k = init.normal((d_model, qk_dim), dtype=dtype)
        self.w_v = init.normal((d_model, d_inner), dtype=dtype)
        self.w_gates = init.normal((d_model, 2 * n_heads))
        self.b_gates = init.cat(torch.zeros(n_heads),
                                torch.full((n_heads,), 3.0))
        self.w_o = init.normal((d_model, d_inner), dtype=dtype)
        self.w_down = init.normal((d_inner, d_model), dtype=dtype)


def _mlstm_qkvgates(p: MLSTM, x, n_heads: int):
    B, S, _ = x.shape
    q, k, v = x @ p.w_q, x @ p.w_k, x @ p.w_v
    gates = x.float() @ p.w_gates + p.b_gates
    i_g = torch.sigmoid(gates[..., :n_heads])              # (B,S,H)
    f_g = torch.sigmoid(gates[..., n_heads:])
    hdk = q.shape[-1] // n_heads
    hdv = v.shape[-1] // n_heads
    q = q.reshape(B, S, n_heads, hdk).float() / np.sqrt(hdk)
    k = k.reshape(B, S, n_heads, hdk).float()
    v = v.reshape(B, S, n_heads, hdv).float()
    return q, k, v, i_g, f_g


def _mlstm_out(p: MLSTM, x, h):
    o = torch.sigmoid(x.float() @ p.w_o.float())
    return (h * o).to(x.dtype) @ p.w_down


def mlstm_apply(p: MLSTM, x, n_heads: int, chunk: int = 256):
    B, S, _ = x.shape
    q, k, v, i_g, f_g = _mlstm_qkvgates(p, x, n_heads)
    hdk, hdv = q.shape[-1], v.shape[-1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"mlstm_apply: S={S} is not a multiple of chunk "
                         f"{chunk}")
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    C_prev = torch.zeros((B, n_heads, hdk, hdv), dtype=torch.float32,
                         device=x.device)
    n_prev = torch.zeros((B, n_heads, hdk), dtype=torch.float32,
                         device=x.device)
    hs = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        q_c, k_c, v_c, i_c, f_c = q[:, sl], k[:, sl], v[:, sl], \
            i_g[:, sl], f_g[:, sl]
        cums = torch.cumsum(torch.log(f_c + 1e-12), dim=1)     # (B,C,H)
        seg = cums[:, :, None, :] - cums[:, None, :, :]        # (B,s,t,H)
        # D[s,t] = prod_{j=t+1..s} f_j * i_t   (within the chunk)
        D = torch.where(tri[None, :, :, None], torch.exp(seg), 0.0) \
            * i_c[:, None, :, :]
        w = torch.einsum("bshk,bthk->bsth", q_c, k_c) * D
        y_diag = torch.einsum("bsth,bthv->bshv", w, v_c)
        den_diag = w.sum(2)                                    # (B,C,H)
        decay_from_start = torch.exp(cums)
        y_cross = torch.einsum("bshk,bsh,bhkv->bshv", q_c, decay_from_start,
                               C_prev)
        den_cross = torch.einsum("bshk,bsh,bhk->bsh", q_c, decay_from_start,
                                 n_prev)
        decay_to_end = torch.exp(cums[:, -1:, :] - cums) * i_c
        C_chunk = torch.einsum("bthk,bth,bthv->bhkv", k_c, decay_to_end, v_c)
        n_chunk = torch.einsum("bthk,bth->bhk", k_c, decay_to_end)
        a_c = torch.exp(cums[:, -1, :])                        # (B,H)
        C_prev = C_prev * a_c[..., None, None] + C_chunk
        n_prev = n_prev * a_c[..., None] + n_chunk
        den = torch.clamp(torch.abs(den_diag + den_cross), min=1.0)
        hs.append((y_diag + y_cross) / den[..., None])
    h = torch.cat(hs, dim=1).reshape(B, S, n_heads * hdv)
    return _mlstm_out(p, x, h)


def mlstm_decode(p: MLSTM, x, state: MLSTMState, n_heads: int):
    B = x.shape[0]
    q, k, v, i_g, f_g = _mlstm_qkvgates(p, x, n_heads)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                # (B,H,hd)
    i_g, f_g = i_g[:, 0], f_g[:, 0]                    # (B,H)
    C_new = state.C * f_g[..., None, None] + \
        torch.einsum("bhk,bhv->bhkv", k * i_g[..., None], v)
    n_new = state.n * f_g[..., None] + k * i_g[..., None]
    num = torch.einsum("bhkv,bhk->bhv", C_new, q)
    den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n_new, q)),
                      min=1.0)
    h = (num / den[..., None]).reshape(B, -1)
    return _mlstm_out(p, x[:, 0], h)[:, None], MLSTMState(C_new, n_new)


def mlstm_init_state(batch, d_model, n_heads, proj_factor=2,
                     device="cuda") -> MLSTMState:
    d_inner = proj_factor * d_model
    hdk = (d_inner // 2) // n_heads
    hdv = d_inner // n_heads
    return MLSTMState(
        torch.zeros((batch, n_heads, hdk, hdv), dtype=torch.float32,
                    device=device),
        torch.zeros((batch, n_heads, hdk), dtype=torch.float32,
                    device=device))


def mlstm_ref(p: MLSTM, x, n_heads: int):
    """Step-by-step oracle."""
    st = mlstm_init_state(x.shape[0], x.shape[2], n_heads,
                          p.w_v.shape[1] // x.shape[2], x.device)
    outs = []
    for t in range(x.shape[1]):
        y, st = mlstm_decode(p, x[:, t:t + 1], st, n_heads)
        outs.append(y)
    return torch.cat(outs, dim=1)


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------
class SLSTM(nn.Module):
    """The reference's ``slstm_init``: float32 ``w_in`` (d, 4d), recurrent
    ``r`` (H, 4, hd, hd) and ``b``
    (0 for z, i, o; 2 for f), ``w_down`` (d, d)."""

    def __init__(self, d_model: int, n_heads: int, init: L.Init, dtype):
        super().__init__()
        hd = d_model // n_heads
        self.w_in = init.normal((d_model, 4 * d_model))
        self.r = init.normal((n_heads, 4, hd, hd), 1.0 / np.sqrt(hd))
        self.b = init.cat(torch.zeros(3 * d_model),
                          torch.full((d_model,), 2.0))
        self.w_down = init.normal((d_model, d_model), dtype=dtype)


def _slstm_cell(p: SLSTM, wx_t, state: SLSTMState, n_heads: int):
    B, d = state.h.shape
    h_heads = state.h.reshape(B, n_heads, d // n_heads)
    rh = torch.einsum("bnh,ngho->bngo", h_heads, p.r)    # (B,H,4,hd)
    rh = rh.transpose(1, 2).reshape(B, 4 * d)           # order z,i,o,f
    z, i, o, f = torch.chunk(wx_t + rh, 4, dim=-1)
    z, i = torch.tanh(z), torch.sigmoid(i)
    o, f = torch.sigmoid(o), torch.sigmoid(f)
    c = f * state.c + i * z
    n = f * state.n + i
    h = o * c / torch.clamp(n, min=1.0)
    return SLSTMState(c, n, h)


def slstm_init_state(batch, d_model, device="cuda") -> SLSTMState:
    return SLSTMState(*(torch.zeros((batch, d_model), dtype=torch.float32,
                                    device=device) for _ in range(3)))


def slstm_apply(p: SLSTM, x, n_heads: int):
    """The recurrence over time: gates z, i, o, f per cell."""
    B, S, d = x.shape
    wx = x.float() @ p.w_in + p.b
    st = slstm_init_state(B, d, x.device)
    hs = []
    for t in range(S):
        st = _slstm_cell(p, wx[:, t], st, n_heads)
        hs.append(st.h)
    return torch.stack(hs, dim=1).to(x.dtype) @ p.w_down


def slstm_decode(p: SLSTM, x, state: SLSTMState, n_heads: int):
    wx = x[:, 0].float() @ p.w_in + p.b
    st = _slstm_cell(p, wx, state, n_heads)
    return (st.h.to(x.dtype) @ p.w_down)[:, None], st
