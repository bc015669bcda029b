"""Model/shape/mesh configuration types shared by all architectures."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # shared (always-on) experts
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64           # mamba2 P
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None          # default d_model // n_heads
    block_pattern: str = "dense"          # dense|moe|gemma2|xlstm|zamba|encdec
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    qkv_bias: bool = False
    logit_softcap: Optional[float] = None
    attn_softcap: Optional[float] = None
    sliding_window: Optional[int] = None  # local-attention window (gemma2)
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    mlp_act: str = "swiglu"               # swiglu | geglu | gelu
    frontend: str = "none"                # none | vision_stub | audio_stub
    n_frontend_tokens: int = 0            # prepended stub-embedding tokens
    # hybrid (zamba2): one shared attention block every `attn_every` layers
    attn_every: int = 6
    # Parallelism / numerics knobs (hillclimb levers)
    moe_ep: bool = True          # False: no expert sharding — tokens stay
                                 # dp x model-sharded, expert weights are
                                 # FSDP-gathered per layer (hillclimb H1c)
    moe_seq_groups: int = 1      # >1: split each row into G token groups
                                 # aligned with 'model' so MoE dispatch is
                                 # local + all-to-all (no buffer all-gather)
    attn_head_pad: int = 0       # pad q-heads to this count + repeat KV so
                                 # attention TP works when nh % tp != 0
    remat: bool = True
    scan_layers: bool = True
    fsdp: bool = False                    # shard params over data axis too
    optimizer: str = "adamw"              # adamw | adafactor
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def eff_n_heads(self) -> int:
        """Padded head count (attn_head_pad lever): zero q/wo rows are
        mathematically inert; enables head TP when n_heads % tp != 0."""
        return max(self.n_heads, self.attn_head_pad) if self.attn_head_pad             else self.n_heads

    @property
    def eff_n_kv_heads(self) -> int:
        """attn_head_pad also expands GQA K/V to full padded heads (the
        broadcast is materialised in the weights) so g=1 and every flash
        einsum carries the sharded head axis."""
        return self.eff_n_heads if self.attn_head_pad else self.n_kv_heads

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, L = self.d_model, self.n_layers
        hd = self.head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.moe:
            ff_dense = 3 * d * self.moe.d_ff_expert * self.moe.n_shared
            ff_moe = 3 * d * self.moe.d_ff_expert * self.moe.n_experts
            ff = ff_dense + ff_moe
        elif self.d_ff:
            ff = 3 * d * self.d_ff
        else:
            ff = 0
        if self.block_pattern == "xlstm":
            # mLSTM projections stand in for attention+ff
            ff = 2 * 4 * d * d
        if self.ssm is not None:
            d_inner = self.ssm.expand * d
            ssm = 2 * d * d_inner + d_inner * (2 * self.ssm.d_state + 8)
            if self.block_pattern == "zamba":
                n_attn = L // self.attn_every
                return (L * ssm + n_attn * (attn + 3 * d * self.d_ff)
                        + 2 * self.vocab * d)
            ff = ssm
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ff) + emb

    def active_param_count(self) -> int:
        """Activated params per token (MoE: routed top_k + shared only)."""
        if not self.moe:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        hd = self.head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        ff_act = 3 * d * self.moe.d_ff_expert * (self.moe.top_k + self.moe.n_shared)
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ff_act) + emb


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Cells skipped per assignment: long_500k needs sub-quadratic attention.
LONG_CONTEXT_ARCHS = ("xlstm-1.3b", "zamba2-7b", "gemma2-9b")


def cell_is_runnable(arch_name: str, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k" and arch_name not in LONG_CONTEXT_ARCHS:
        return False, ("skipped: pure full-attention arch; long_500k requires "
                       "sub-quadratic attention (DESIGN.md §Arch-applicability)")
    return True, ""
