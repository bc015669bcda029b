"""Model assembly: builds every assigned architecture from ``ModelConfig``.

The counterpart of ``repro.models.lm``. Block patterns
  dense    — uniform [attn, mlp] x L                  (qwen, stablelm, paligemma)
  moe      — uniform [attn, moe-ffn] x L              (llama4, olmoe)
  gemma2   — (local-window block, global block) x L/2 with softcaps
  xlstm    — units of 8: 7 mLSTM + 1 sLSTM
  zamba    — mamba2 x L with one SHARED attn+mlp block applied after every
             `attn_every` layers (param sharing is the Zamba trick)
  encdec   — whisper: non-causal encoder + causal decoder with cross-attn

Where the reference stacks a pattern's layers and scans them, the port
keeps one ``nn.Module`` a layer in an ``nn.ModuleList`` and loops in
Python; the parameter names are the reference's pytree paths with the
layer index after the stack's name (``blocks.3.attn.wq``). The caches keep
the reference's stacked layouts — (L, B, T, nkv, hd) K/V, and the
``MLSTMState``/``SLSTMState``/``SSMState`` stacks — so they compare leaf by
leaf; ``decode_step`` writes them in place and returns ``(logits,
cache)``. ``init_cache`` and ``decode_step`` run under
``torch.inference_mode()``; ``forward``, ``loss`` and ``encode`` carry a
graph wherever a parameter requires a gradient (``model.requires_grad_()``:
parameters are made without one, so serving builds none). With
``cfg.remat`` each of the reference's scanned bodies (a block, gemma2's
local/global pair, an xLSTM or Zamba unit, an encoder or decoder block)
recomputes its activations in the backward pass, as the reference's
``jax.checkpoint`` does.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.common import ModelConfig
from . import attention as A
from . import layers as L
from . import moe as M
from . import ssm as SSM
from . import xlstm as X
from .flash import flash_attention


def require_cuda(device) -> None:
    """Raise where ``device`` is a CUDA device and CUDA is absent: the
    model never falls back to the CPU on its own."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but torch.cuda.is_available() "
            "is false; pass device='cpu'")


def default_generator(device) -> Optional[torch.Generator]:
    """A generator seeded with 0 on ``device`` (the reference's
    ``PRNGKey(0)`` counterpart); none on ``meta``, where nothing is
    drawn."""
    require_cuda(device)
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=torch.device(device)).manual_seed(0)


class Block(nn.Module):
    """``kind`` "dense": norm1, attn, norm2, mlp; "moe": the mlp is a
    ``moe``; "dec": the decoder block, with norm_x and xattn between."""

    def __init__(self, cfg: ModelConfig, init: L.Init, dtype, kind: str):
        super().__init__()
        self.norm1 = L.Norm(cfg.norm, cfg.d_model, init)
        self.attn = A.Attention(cfg, init, dtype)
        if kind == "dec":
            self.norm_x = L.Norm(cfg.norm, cfg.d_model, init)
            self.xattn = A.Attention(cfg, init, dtype)
        self.norm2 = L.Norm(cfg.norm, cfg.d_model, init)
        if kind == "moe":
            self.moe = M.MoE(cfg.d_model, cfg.moe, init, dtype)
        else:
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, init, dtype)


class Cell(nn.Module):
    """A pre-norm residual cell (mLSTM, sLSTM or Mamba2)."""

    def __init__(self, cfg: ModelConfig, init: L.Init, cell: nn.Module):
        super().__init__()
        self.norm = L.Norm(cfg.norm, cfg.d_model, init)
        self.cell = cell


class LM(nn.Module):
    """Decoder-only (and enc-dec) language model.

    ``LM(cfg, device=, generator=)`` draws its weights on the generator's
    device (default: one seeded with 0 on ``device``) and keeps them on
    ``device``, which defaults to ``"cuda"`` and raises where CUDA is
    absent. ``models.convert.load_reference_params`` replaces them with
    the reference's. On ``device="meta"`` nothing is drawn or allocated:
    the sharded steps run such a model with the store's tensors put in
    its parameters' places (``launch.steps``).

    ``sharder(x, kind)`` is the reference's activation-sharding hook
    (kinds "hidden", "logits" here and "moe_group", "moe_buf",
    "moe_buf3" in ``moe_apply``): ``launch.steps.make_sharder``'s records
    the spec the reference would constrain ``x`` to and returns ``x``.
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 sharder=None):
        super().__init__()
        require_cuda(device)
        if generator is None:
            generator = default_generator(device)
        init = L.Init(device, generator)
        dt = L.torch_dtype(cfg.dtype)
        self.cfg = cfg
        self.shard = sharder if sharder is not None else _no_shard
        self.embed = L.Embed(cfg.vocab, cfg.d_model, init, dt)
        self.final_norm = L.Norm(cfg.norm, cfg.d_model, init)
        self.lm_head = (None if cfg.tie_embeddings
                        else L.Embed(cfg.vocab, cfg.d_model, init, dt))

        def blocks(n, kind):
            return nn.ModuleList(Block(cfg, init, dt, kind) for _ in range(n))

        def cells(n, make):
            return nn.ModuleList(Cell(cfg, init, make()) for _ in range(n))

        bp = cfg.block_pattern
        if bp in ("dense", "moe"):
            self.blocks = blocks(cfg.n_layers, bp)
        elif bp == "gemma2":
            if cfg.n_layers % 2:
                raise ValueError(f"gemma2 needs an even n_layers, got "
                                 f"{cfg.n_layers}")
            self.blocks_local = blocks(cfg.n_layers // 2, "dense")
            self.blocks_global = blocks(cfg.n_layers // 2, "dense")
        elif bp == "xlstm":
            n_units = cfg.n_layers // 8
            self.mlstm = cells(n_units * 7, lambda: X.MLSTM(
                cfg.d_model, cfg.n_heads, init, dt))
            self.slstm = cells(n_units, lambda: X.SLSTM(
                cfg.d_model, cfg.n_heads, init, dt))
        elif bp == "zamba":
            n_mamba = (cfg.n_layers // cfg.attn_every) * cfg.attn_every
            self.mamba = cells(n_mamba, lambda: SSM.SSM(
                cfg.d_model, cfg.ssm, init, dt))
            self.tail = (cells(cfg.n_layers - n_mamba, lambda: SSM.SSM(
                cfg.d_model, cfg.ssm, init, dt))
                if cfg.n_layers > n_mamba else None)
            self.shared_attn = Block(cfg, init, dt, "dense")   # ONE block
        elif bp == "encdec":
            self.enc_blocks = blocks(cfg.n_layers, "dense")
            self.enc_norm = L.Norm(cfg.norm, cfg.d_model, init)
            self.blocks = blocks(cfg.n_layers, "dec")
        else:
            raise ValueError(bp)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @property
    def dtype(self) -> torch.dtype:
        return L.torch_dtype(self.cfg.dtype)

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())

    # ----- shared pieces ---------------------------------------------------
    def _embed_in(self, tokens, extra=None):
        cfg = self.cfg
        x = L.embed(self.embed, tokens)
        if cfg.norm == "rmsnorm":
            # a Python float keeps bf16 (the gemma-style embedding scale)
            x = x * float(np.sqrt(cfg.d_model))
        if cfg.frontend != "none" and extra is not None:
            x = torch.cat([extra.to(x.dtype), x], dim=1)
        return self.shard(x, "hidden")

    def _logits(self, x):
        cfg = self.cfg
        x = self.final_norm(x)
        table = (self.embed if cfg.tie_embeddings else self.lm_head).table
        logits = self.shard(L.unembed(x, table), "logits")
        return L.softcap(logits, cfg.logit_softcap)

    def _ffn(self, blk: Block, h):
        if hasattr(blk, "moe"):
            return M.moe_apply(blk.moe, h, self.cfg.moe,
                               shard_fn=self.shard,
                               seq_groups=self.cfg.moe_seq_groups)
        return blk.mlp(h)

    def _attn_block(self, x, blk: Block, positions, window):
        cfg = self.cfg
        q, k, v = A._project_qkv(blk.attn, blk.norm1(x), positions, cfg)
        o = flash_attention(q, k, v, causal=True, window=window,
                            softcap=cfg.attn_softcap)
        x = x + A.out_proj(o, blk.attn.wo)
        return x + self._ffn(blk, blk.norm2(x))

    def _cell_stack(self, cells, x, apply):
        for c in cells:
            x = x + apply(c.cell, c.norm(x))
        return x

    def _remat(self, body, x, *args):
        """``body(x, *args)``; with ``cfg.remat``, while a graph is being
        built, its activations are recomputed in the backward pass."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(body, x, *args, use_reentrant=False)
        return body(x, *args)

    # ----- forward (train / prefill) ---------------------------------------
    def forward(self, tokens, extra=None):
        """tokens (B, S) -> logits (B, S [+ frontend tokens], vocab)."""
        cfg = self.cfg
        bp = cfg.block_pattern
        if bp == "encdec":
            return self._forward_encdec(tokens, extra)
        x = self._embed_in(tokens, extra)
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        if bp in ("dense", "moe"):
            for blk in self.blocks:
                x = self._remat(self._attn_block, x, blk, positions,
                                cfg.sliding_window)
        elif bp == "gemma2":
            for bl, bg in zip(self.blocks_local, self.blocks_global):
                x = self._remat(self._gemma2_pair, x, bl, bg, positions)
        elif bp == "xlstm":
            for u in range(len(self.slstm)):
                x = self._remat(self._xlstm_unit, x, u)
        elif bp == "zamba":
            for u in range(len(self.mamba) // cfg.attn_every):
                x = self._remat(self._zamba_unit, x, u, positions)
            if self.tail is not None:
                x = self._cell_stack(self.tail, x, self._mamba)
        else:
            raise ValueError(bp)
        return self._logits(x)

    # The reference's scanned bodies (x first: ``_remat``'s order).
    def _gemma2_pair(self, x, bl: Block, bg: Block, positions):
        x = self._attn_block(x, bl, positions, self.cfg.sliding_window)
        return self._attn_block(x, bg, positions, None)

    def _xlstm_unit(self, x, u: int):
        n_heads = self.cfg.n_heads
        x = self._cell_stack(self.mlstm[u * 7:(u + 1) * 7], x,
                             lambda p, h: X.mlstm_apply(p, h, n_heads))
        return self._cell_stack([self.slstm[u]], x,
                                lambda p, h: X.slstm_apply(p, h, n_heads))

    def _mamba(self, p, h):
        return SSM.ssm_apply(p, h, self.cfg.ssm)

    def _zamba_unit(self, x, u: int, positions):
        ae = self.cfg.attn_every
        x = self._cell_stack(self.mamba[u * ae:(u + 1) * ae], x, self._mamba)
        return self._attn_block(x, self.shared_attn, positions, None)

    def _enc_block(self, enc, blk: Block):
        h = blk.norm1(enc)
        a = blk.attn
        o = flash_attention(A.proj(h, a.wq), A.proj(h, a.wk),
                            A.proj(h, a.wv), causal=False)
        enc = enc + A.out_proj(o, a.wo)
        return enc + blk.mlp(blk.norm2(enc))

    def _dec_block(self, x, blk: Block, enc):
        h = blk.norm1(x)
        a = blk.attn
        o = flash_attention(A.proj(h, a.wq), A.proj(h, a.wk),
                            A.proj(h, a.wv), causal=True)
        x = x + A.out_proj(o, a.wo)
        hx = blk.norm_x(x)
        xa = blk.xattn
        ox = flash_attention(A.proj(hx, xa.wq), A.proj(enc, xa.wk),
                             A.proj(enc, xa.wv), causal=False)
        x = x + A.out_proj(ox, xa.wo)
        return x + blk.mlp(blk.norm2(x))

    def _encoder(self, frames):
        cfg = self.cfg
        enc = frames.to(self.dtype)
        enc = enc + L.sinusoidal_pos(enc.shape[1], cfg.d_model, enc.dtype,
                                     device=enc.device)[None]
        for blk in self.enc_blocks:
            enc = self._remat(self._enc_block, enc, blk)
        return self.enc_norm(enc)

    def _forward_encdec(self, tokens, frames):
        cfg = self.cfg
        enc = self._encoder(frames)
        x = L.embed(self.embed, tokens)
        x = x + L.sinusoidal_pos(x.shape[1], cfg.d_model, x.dtype,
                                 device=x.device)[None]
        for blk in self.blocks:
            x = self._remat(self._dec_block, x, blk, enc)
        return self._logits(x)

    # ----- loss -------------------------------------------------------------
    def loss(self, batch) -> torch.Tensor:
        logits = self.forward(batch["tokens"], batch.get("extra"))
        labels = batch["labels"]
        if logits.shape[1] != labels.shape[1]:      # frontend-prefixed
            logits = logits[:, -labels.shape[1]:]
        return L.cross_entropy(logits, labels)

    # ----- decode -----------------------------------------------------------
    @torch.inference_mode()
    def init_cache(self, batch: int, max_len: int) -> Any:
        cfg = self.cfg
        dt, dev = self.dtype, self.device
        bp = cfg.block_pattern
        nkv, hd = cfg.eff_n_kv_heads, cfg.head_dim

        def zeros(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def kv(n, length):
            return A.KVCache(zeros(n, batch, length, nkv, hd),
                             zeros(n, batch, length, nkv, hd))
        if bp in ("dense", "moe"):
            return kv(cfg.n_layers, max_len)
        if bp == "gemma2":
            w = min(cfg.sliding_window or max_len, max_len)
            return {"local": kv(cfg.n_layers // 2, w),
                    "global": kv(cfg.n_layers // 2, max_len)}
        if bp == "xlstm":
            n_units = cfg.n_layers // 8
            d_inner = 2 * cfg.d_model
            hdk = (d_inner // 2) // cfg.n_heads
            hdv = d_inner // cfg.n_heads
            f32 = torch.float32
            return {
                "mlstm": X.MLSTMState(
                    zeros(n_units * 7, batch, cfg.n_heads, hdk, hdv,
                          dtype=f32),
                    zeros(n_units * 7, batch, cfg.n_heads, hdk, dtype=f32)),
                "slstm": X.SLSTMState(*(zeros(n_units, batch, cfg.d_model,
                                              dtype=f32) for _ in range(3))),
            }
        if bp == "zamba":
            n_units = cfg.n_layers // cfg.attn_every
            n_mamba = n_units * cfg.attn_every
            d_inner = cfg.ssm.expand * cfg.d_model
            nh = d_inner // cfg.ssm.head_dim

            def states(n):
                return SSM.SSMState(
                    zeros(n, batch, cfg.ssm.d_conv - 1, d_inner),
                    zeros(n, batch, nh, cfg.ssm.head_dim, cfg.ssm.d_state,
                          dtype=torch.float32))
            return {"mamba": states(n_mamba),
                    "tail": states(cfg.n_layers - n_mamba),
                    "attn": kv(n_units, max_len)}
        if bp == "encdec":
            return {"self": kv(cfg.n_layers, max_len),
                    "cross": None}   # filled from encode()
        raise ValueError(bp)

    def _ssm_decode_stack(self, cells, x, st: SSM.SSMState, first: int):
        for i, c in enumerate(cells):
            layer = first + i
            y, ns = SSM.ssm_decode(c.cell, c.norm(x),
                                   SSM.SSMState(st.conv[layer],
                                                st.ssm[layer]), self.cfg.ssm)
            st.conv[layer].copy_(ns.conv)
            st.ssm[layer].copy_(ns.ssm)
            x = x + y
        return x

    @torch.inference_mode()
    def decode_step(self, cache, tokens, pos):
        """tokens (B, 1); ``pos`` the position being written (an int, the
        same for the batch). Updates ``cache`` in place; returns (logits,
        cache)."""
        cfg = self.cfg
        bp = cfg.block_pattern
        pos = int(pos)
        if bp == "encdec":
            return self._decode_encdec(cache, tokens, pos)
        x = self._embed_in(tokens)

        if bp in ("dense", "moe"):
            for i, blk in enumerate(self.blocks):
                y, _ = A.attention_decode(
                    blk.attn, blk.norm1(x), pos,
                    A.KVCache(cache.k[i], cache.v[i]), cfg,
                    cfg.sliding_window)
                x = x + y
                x = x + self._ffn(blk, blk.norm2(x))
        elif bp == "gemma2":
            loc, glo = cache["local"], cache["global"]
            w = loc.k.shape[2]
            for i, (bl, bg) in enumerate(zip(self.blocks_local,
                                             self.blocks_global)):
                y, _ = _ring_attn_decode(bl.attn, bl.norm1(x), pos,
                                         loc.k[i], loc.v[i], cfg, w)
                x = x + y
                x = x + bl.mlp(bl.norm2(x))
                y, _ = A.attention_decode(bg.attn, bg.norm1(x), pos,
                                          A.KVCache(glo.k[i], glo.v[i]),
                                          cfg, None)
                x = x + y
                x = x + bg.mlp(bg.norm2(x))
        elif bp == "xlstm":
            mst, sst = cache["mlstm"], cache["slstm"]
            for u, sl in enumerate(self.slstm):
                for j in range(7):
                    layer = u * 7 + j
                    c = self.mlstm[layer]
                    y, st = X.mlstm_decode(
                        c.cell, c.norm(x),
                        X.MLSTMState(mst.C[layer], mst.n[layer]),
                        cfg.n_heads)
                    mst.C[layer].copy_(st.C)
                    mst.n[layer].copy_(st.n)
                    x = x + y
                y, st = X.slstm_decode(
                    sl.cell, sl.norm(x),
                    X.SLSTMState(sst.c[u], sst.n[u], sst.h[u]), cfg.n_heads)
                for dst, src in zip(sst, st):
                    dst[u].copy_(src)
                x = x + y
        elif bp == "zamba":
            ae = cfg.attn_every
            sh, att = self.shared_attn, cache["attn"]
            for u in range(len(self.mamba) // ae):
                x = self._ssm_decode_stack(self.mamba[u * ae:(u + 1) * ae],
                                           x, cache["mamba"], u * ae)
                y, _ = A.attention_decode(sh.attn, sh.norm1(x), pos,
                                          A.KVCache(att.k[u], att.v[u]),
                                          cfg, None)
                x = x + y
                x = x + sh.mlp(sh.norm2(x))
            if self.tail is not None:
                x = self._ssm_decode_stack(self.tail, x, cache["tail"], 0)
        else:
            raise ValueError(bp)
        return self._logits(x), cache

    def _decode_encdec(self, cache, tokens, pos: int):
        cfg = self.cfg
        x = L.embed(self.embed, tokens)
        x = x + L.sinusoidal_pos(1, cfg.d_model, x.dtype, offset=pos,
                                 device=x.device)[None]
        own, (xk, xv) = cache["self"], cache["cross"]
        for i, blk in enumerate(self.blocks):
            y, _ = A.attention_decode(blk.attn, blk.norm1(x), pos,
                                      A.KVCache(own.k[i], own.v[i]), cfg,
                                      None)
            x = x + y
            x = x + A.cross_attention(blk.xattn, blk.norm_x(x),
                                      (xk[i], xv[i]), cfg)
            x = x + blk.mlp(blk.norm2(x))
        return self._logits(x), cache

    def encode(self, frames):
        """encdec only: the encoder's output and every decoder layer's
        cross K/V, stacked (L, B, T, nkv, hd)."""
        enc = self._encoder(frames)
        ks = torch.stack([A.proj(enc, b.xattn.wk) for b in self.blocks])
        vs = torch.stack([A.proj(enc, b.xattn.wv) for b in self.blocks])
        return enc, (ks, vs)


def _no_shard(x, kind):
    return x


def _ring_attn_decode(p: A.Attention, x, pos: int, ck, cv, cfg, window: int):
    """Sliding-window decode through a ring buffer of ``window`` slots.

    Position t lives in slot t % window; slot j holds position
    pos - ((pos - j) mod window), within the window by construction
    (unwritten slots have an age above pos and are masked off). Writes
    ``ck``/``cv`` in place."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = A._project_qkv(p, x, positions, cfg)
    slot = pos % window
    if isinstance(ck, A.SeqPieces):
        ck.write(slot, k)
        cv.write(slot, v)
        o = A.sdpa_pieces(q, ck, cv, lambda j: (pos - j) % window <= pos,
                          cfg)
        return A.out_proj(o, p.wo), (ck, cv)
    ck[:, slot:slot + 1] = k.to(ck.dtype)
    cv[:, slot:slot + 1] = v.to(cv.dtype)
    age = (pos - torch.arange(window, device=x.device)) % window
    mask = (age <= pos)[None, None, :].expand(B, 1, window)
    y = A.out_proj(A._sdpa(q, ck, cv, mask, cfg), p.wo)
    return y, (ck, cv)


def decode_logits(model: LM, tokens, *, cross=None):
    """Teacher-forced decode: feed ``tokens`` (B, S) one position at a time
    through ``decode_step`` from an empty cache; the logits (B, S, vocab).
    Equal to ``forward(tokens)`` within the dtype's tolerance for the
    causal patterns (the reference's decode-vs-forward check)."""
    B, S = tokens.shape
    cache = model.init_cache(B, S)
    if cross is not None:
        cache["cross"] = cross
    outs = []
    for t in range(S):
        logits, cache = model.decode_step(cache, tokens[:, t:t + 1], t)
        outs.append(logits)
    return torch.cat(outs, dim=1)
