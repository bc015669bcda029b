"""stablelm-3b [dense] — 32L d2560 32H (kv=32) d_ff 6912 vocab 50304.
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from .common import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
    vocab=50304, block_pattern="dense", norm="layernorm",
)

SMOKE = ModelConfig(
    name="stablelm-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=512, block_pattern="dense", norm="layernorm", remat=False,
)
