"""gemma2-9b [dense] — 42L d3584 16H (GQA kv=8) d_ff 14336 vocab 256000,
alternating local(4096-window)/global attention, attn softcap 50, final
logit softcap 30. [arXiv:2408.00118]"""
from .common import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_ff=14336,
    vocab=256000, d_head=256, block_pattern="gemma2", mlp_act="geglu",
    sliding_window=4096, attn_softcap=50.0, logit_softcap=30.0,
)

SMOKE = ModelConfig(
    name="gemma2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, d_head=16, block_pattern="gemma2", mlp_act="geglu",
    sliding_window=16, attn_softcap=50.0, logit_softcap=30.0, remat=False,
)
