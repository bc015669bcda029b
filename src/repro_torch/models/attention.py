"""GQA attention with RoPE, optional QKV bias, soft-capping, a sliding
window, and one-token decode with a KV cache.

The counterpart of ``repro.models.attention``. Shapes: x (B, S, D); a
layer's cache (B, S_max, n_kv, hd). ``attention_decode`` writes the new
K/V into the cache it is given, in place, and returns that cache.

A cache cut along the sequence on a mesh (``StackedPieces``, a layer's
``SeqPieces``) is attended piece by piece (``sdpa_pieces``), as the
reference's GSPMD partitions the softmax of a sequence-sharded cache: the
row max, the exp-sum and the probabilities' weighted sum of V are
combined across pieces; the cache is never gathered.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from . import layers as L

NEG = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_max, n_kv, hd), or stacked (L, ...)
    v: torch.Tensor


class Attention(nn.Module):
    """The reference's ``attn_init`` (also its ``cross_attention_init``):
    ``wq`` (d, nh, hd), ``wk``/``wv`` (d, nkv, hd), ``wo`` (nh, hd, d), and
    with ``qkv_bias`` zero ``bq``/``bk``/``bv``. Head counts are the padded
    ones (``attn_head_pad``)."""

    def __init__(self, cfg, init: L.Init, dtype):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        nh, nkv = cfg.eff_n_heads, cfg.eff_n_kv_heads
        self.wq = init.normal((d, nh, hd), dtype=dtype)
        self.wk = init.normal((d, nkv, hd), dtype=dtype)
        self.wv = init.normal((d, nkv, hd), dtype=dtype)
        self.wo = init.normal((nh, hd, d), dtype=dtype)
        self.has_bias = cfg.qkv_bias
        if cfg.qkv_bias:
            self.bq = init.full((nh, hd), 0.0, dtype)
            self.bk = init.full((nkv, hd), 0.0, dtype)
            self.bv = init.full((nkv, hd), 0.0, dtype)


def proj(x, w):
    """``einsum("bsd,dnh->bsnh", x, w)``."""
    return torch.einsum("bsd,dnh->bsnh", x, w)


def out_proj(o, wo):
    """``einsum("bsnh,nhd->bsd", o, wo)``."""
    return torch.einsum("bsnh,nhd->bsd", o, wo)


def _project_qkv(p: Attention, x, positions, cfg):
    q, k, v = proj(x, p.wq), proj(x, p.wk), proj(x, p.wv)
    if p.has_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, cfg):
    """q (B,S,nh,hd); k,v (B,T,nkv,hd); mask (B,S,T) -> (B,S,nh,hd).

    The scores leave the einsum in the input dtype and only then go to
    float32, as the reference's do."""
    B, S, nh, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(B, S, nkv, nh // nkv, hd)
    scale = 1.0 / np.sqrt(hd)
    scores = torch.einsum("bsngh,btnh->bnsgt", qg, k).float() * scale
    scores = L.softcap(scores, cfg.attn_softcap)
    scores = torch.where(mask[:, None, :, None, :], scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bnsgt,btnh->bsngh", probs, v)
    return out.reshape(B, S, nh, hd)


class SeqPieces:
    """One layer's K or V cut along the sequence: ``parts`` is a list of
    (first slot, (B, T_piece, n_kv, hd) tensor), each on its own device."""

    def __init__(self, parts):
        self.parts = parts

    @property
    def shape(self):
        B, _, n, h = self.parts[0][1].shape
        return (B, sum(t.shape[1] for _, t in self.parts), n, h)

    def write(self, slot: int, value) -> None:
        """``value`` (B, 1, n_kv, hd) into absolute slot ``slot``."""
        for t0, t in self.parts:
            if t0 <= slot < t0 + t.shape[1]:
                t[:, slot - t0:slot - t0 + 1] = value.to(t.device, t.dtype)
                return
        raise IndexError(f"slot {slot} beyond {self.shape[1]}")


class StackedPieces:
    """A stacked (L, B, T, n_kv, hd) cache leaf cut along T: ``[i]`` is
    layer i's ``SeqPieces`` (views, so writes land in the pieces)."""

    def __init__(self, parts):
        self.parts = parts

    @property
    def shape(self):
        L, B, _, n, h = self.parts[0][1].shape
        return (L, B, sum(t.shape[2] for _, t in self.parts), n, h)

    def __getitem__(self, i):
        return SeqPieces([(t0, t[i]) for t0, t in self.parts])


def sdpa_pieces(q, ks: SeqPieces, vs: SeqPieces, valid, cfg):
    """``_sdpa`` over a sequence-cut cache; ``valid(j)`` the (T,) mask of
    absolute slots ``j``. Each piece's scores are taken on its device;
    the global row max, then the sum of exp(s - max), then each piece's
    probabilities (in ``q``'s dtype) times its V, summed in float32, are
    combined on ``q``'s device: the same function as ``_sdpa``."""
    B, S, nh, hd = q.shape
    nkv = ks.parts[0][1].shape[2]
    qg = q.reshape(B, S, nkv, nh // nkv, hd)
    scale = 1.0 / np.sqrt(hd)
    scores = []
    for t0, k in ks.parts:
        s = torch.einsum("bsngh,btnh->bnsgt", qg.to(k.device), k).float() \
            * scale
        s = L.softcap(s, cfg.attn_softcap)
        j = torch.arange(t0, t0 + k.shape[1], device=k.device)
        scores.append(torch.where(valid(j)[None, None, None, None, :], s,
                                  NEG))
    m = None
    for s in scores:
        ms = s.amax(-1, keepdim=True).to(q.device)
        m = ms if m is None else torch.maximum(m, ms)
    den = sum(torch.exp(s - m.to(s.device)).sum(-1, keepdim=True)
              .to(q.device) for s in scores)
    acc = None
    for s, (_, v) in zip(scores, vs.parts):
        probs = (torch.exp(s - m.to(s.device)) / den.to(s.device)).to(q.dtype)
        part = torch.einsum("bnsgt,btnh->bsngh", probs.float(),
                            v.float()).to(q.device)
        acc = part if acc is None else acc + part
    return acc.to(q.dtype).reshape(B, S, nh, hd)


def causal_mask(S: int, window: Optional[int] = None, device="cuda"):
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    m = j <= i
    if window is not None:
        m &= (i - j) < window
    return m[None]                  # (1, S, T)


def attention(p: Attention, x, positions, cfg, window: Optional[int] = None):
    """Full (training/prefill) causal self-attention."""
    q, k, v = _project_qkv(p, x, positions, cfg)
    mask = causal_mask(x.shape[1], window, x.device)
    return out_proj(_sdpa(q, k, v, mask, cfg), p.wo)


def decode_valid(j, pos: int, window: Optional[int]):
    """Slots ``j <= pos`` (and within the window, if set)."""
    valid = j <= pos
    if window is not None:
        valid &= (pos - j) < window
    return valid


def decode_mask(B: int, T: int, pos: int, window: Optional[int], device):
    """(B, 1, T): ``decode_valid`` of every slot."""
    valid = decode_valid(torch.arange(T, device=device), pos, window)
    return valid[None, None, :].expand(B, 1, T)


def attention_decode(p: Attention, x, pos: int, cache: KVCache, cfg,
                     window: Optional[int] = None):
    """One-token decode: x (B, 1, D); ``pos`` an int (the same for the
    batch). Writes the new K/V at ``pos`` of ``cache`` in place and attends
    over the whole cache under a validity mask. Returns (y, cache)."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, positions, cfg)
    if isinstance(cache.k, SeqPieces):
        cache.k.write(pos, k_new)
        cache.v.write(pos, v_new)
        o = sdpa_pieces(q, cache.k, cache.v,
                        lambda j: decode_valid(j, pos, window), cfg)
        return out_proj(o, p.wo), cache
    cache.k[:, pos:pos + 1] = k_new.to(cache.k.dtype)
    cache.v[:, pos:pos + 1] = v_new.to(cache.v.dtype)
    mask = decode_mask(B, cache.k.shape[1], pos, window, x.device)
    y = out_proj(_sdpa(q, cache.k, cache.v, mask, cfg), p.wo)
    return y, cache


def cross_attention(p: Attention, x, enc_kv, cfg):
    """Decoder cross-attention to precomputed encoder K/V (no causality,
    no RoPE)."""
    B, S, _ = x.shape
    q = proj(x, p.wq)
    if p.has_bias:
        q = q + p.bq
    k, v = enc_kv
    if isinstance(k, SeqPieces):
        return out_proj(sdpa_pieces(q, k, v, lambda j: torch.ones_like(
            j, dtype=torch.bool), cfg), p.wo)
    mask = torch.ones((B, S, k.shape[1]), dtype=torch.bool, device=x.device)
    return out_proj(_sdpa(q, k, v, mask, cfg), p.wo)


def encode_kv(p: Attention, enc_out, cfg):
    k = torch.einsum("btd,dnh->btnh", enc_out, p.wk)
    v = torch.einsum("btd,dnh->btnh", enc_out, p.wv)
    if p.has_bias:
        k, v = k + p.bk, v + p.bv
    return k, v
