"""qwen2-0.5b [dense] — 24L d896 14H (GQA kv=2) d_ff 4864 vocab 151936,
QKV bias. [arXiv:2407.10671]"""
from .common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab=151936, block_pattern="dense", qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen2-smoke", family="dense",
    n_layers=2, d_model=56, n_heads=7, n_kv_heads=1, d_ff=128,
    vocab=512, d_head=8, block_pattern="dense", qkv_bias=True, remat=False,
)
