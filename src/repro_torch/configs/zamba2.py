"""zamba2-7b [hybrid] — 81L d3584 32H (kv=32) d_ff 14336 vocab 32000,
ssm_state=64: Mamba2 backbone + ONE shared attention+MLP block applied
every 6 layers (param sharing = the Zamba trick; per-invocation LoRA
omitted, noted in DESIGN.md). [arXiv:2411.15242; unverified]"""
from .common import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000, block_pattern="zamba", attn_every=6,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64),
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=7, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=512, block_pattern="zamba", attn_every=3,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16), remat=False,
)
