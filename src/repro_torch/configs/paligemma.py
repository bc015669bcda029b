"""paligemma-3b [vlm] — 18L d2048 8H (MQA kv=1) d_ff 16384 vocab 257216.
SigLIP vision frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings (B, 256, d_model). [arXiv:2407.07726; hf]"""
from .common import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab=257216, d_head=256, block_pattern="dense", mlp_act="geglu",
    frontend="vision_stub", n_frontend_tokens=256,
)

SMOKE = ModelConfig(
    name="paligemma-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab=512, d_head=16, block_pattern="dense", mlp_act="geglu",
    frontend="vision_stub", n_frontend_tokens=16, remat=False,
)
