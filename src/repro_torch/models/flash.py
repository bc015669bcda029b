"""Blockwise (flash-style) attention in plain PyTorch, on the reference's
block schedule.

The counterpart of ``repro.models.flash`` (pure JAX there too; no Pallas
kernel reaches it). Q blocks in an outer loop, KV blocks in an inner one
with a streaming softmax, so peak memory is O(q_block x kv_block); a
sliding window reads one static (window + q_block) KV strip per Q block.
The scores accumulate in float32 and the running output in ``v``'s dtype,
as the reference's do. ``scaled_dot_product_attention`` would compute a
different function (no softcap, another accumulation), so it is not used.
The dry-run's block overrides (``models.scan_utils.FLASH_Q_BLOCK``/
``FLASH_KV_BLOCK``) replace the block sizes asked for, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import scan_utils

NEG_INF = -1e30


def _largest_divisor_leq(n: int, k: int) -> int:
    for d in range(min(k, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def _scores(q, k, scale, softcap):
    # q (B,Cq,nkv,g,hd) k (B,Ck,nkv,hd) -> (B,nkv,g,Cq,Ck) float32
    s = torch.einsum("bqngh,bknh->bngqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    return s


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    q_offset: int = 0,
                    q_block: int = 512, kv_block: int = 1024):
    """q (B,S,nh,hd); k,v (B,T,nkv,hd) -> (B,S,nh,hd).

    ``q_offset`` is the absolute position of q[0] (chunked prefill).
    """
    B, S, nh, hd = q.shape
    T, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    scale = 1.0 / np.sqrt(hd)
    if scan_utils.FLASH_Q_BLOCK:
        q_block = scan_utils.FLASH_Q_BLOCK
    if scan_utils.FLASH_KV_BLOCK:
        kv_block = scan_utils.FLASH_KV_BLOCK
    # A non-power-of-two S (vision-prefixed sequences) takes the largest
    # dividing block at most the one asked for.
    q_block = _largest_divisor_leq(S, min(q_block, S))
    kv_block = _largest_divisor_leq(T, min(kv_block, T))
    nq = S // q_block
    qr = q.reshape(B, nq, q_block, nkv, g, hd)
    dev = q.device
    outs = []

    if window is not None:
        strip = min(window + q_block, T)
        for qi in range(nq):
            q_start = qi * q_block + q_offset
            start = min(max(q_start - window + 1, 0), T - strip)
            ks = k[:, start:start + strip]
            vs = v[:, start:start + strip]
            s = _scores(qr[:, qi], ks, scale, softcap)
            qpos = q_start + torch.arange(q_block, device=dev)
            kpos = start + torch.arange(strip, device=dev)
            m = kpos[None, :] <= qpos[:, None]
            m &= (qpos[:, None] - kpos[None, :]) < window
            s = torch.where(m[None, None, None], s, NEG_INF)
            p = torch.softmax(s, dim=-1)
            outs.append(torch.einsum("bngqk,bknh->bqngh", p.to(v.dtype), vs))
        return torch.stack(outs, 1).reshape(B, S, nh, hd)

    nk = T // kv_block
    for qi in range(nq):
        qb = qr[:, qi]
        qpos = qi * q_block + q_offset + torch.arange(q_block, device=dev)
        m_run = torch.full((B, nkv, g, q_block), NEG_INF, dtype=torch.float32,
                           device=dev)
        l_run = torch.zeros((B, nkv, g, q_block), dtype=torch.float32,
                            device=dev)
        acc = torch.zeros((B, nkv, g, q_block, hd), dtype=v.dtype, device=dev)
        for ki in range(nk):
            kb = k[:, ki * kv_block:(ki + 1) * kv_block]
            vb = v[:, ki * kv_block:(ki + 1) * kv_block]
            s = _scores(qb, kb, scale, softcap)          # (B,nkv,g,Cq,Ck)
            if causal:
                kpos = ki * kv_block + torch.arange(kv_block, device=dev)
                mask = kpos[None, :] <= qpos[:, None]
                s = torch.where(mask[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new[..., None])
            l_run = l_run * alpha + p.sum(-1)
            pv = torch.einsum("bngqk,bknh->bngqh", p.to(vb.dtype), vb)
            acc = acc * alpha[..., None].to(acc.dtype) + pv
            m_run = m_new
        o = acc / torch.clamp(l_run, min=1e-30)[..., None].to(acc.dtype)
        outs.append(o.permute(0, 3, 1, 2, 4))           # (B,Cq,nkv,g,hd)
    return torch.stack(outs, 1).reshape(B, S, nh, hd)
