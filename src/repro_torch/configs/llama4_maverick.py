"""llama4-maverick-400b-a17b [moe] — 48L d5120 40H (GQA kv=8) expert-ff 8192
vocab 202048, MoE 128 experts top-1 + 1 shared expert (early fusion).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from .common import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202048, d_head=128, block_pattern="moe",
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192, n_shared=1),
    rope_theta=500000.0, tie_embeddings=False,
    # 400B-class params: bf16 + Adafactor(bf16 states) to fit 16 GB/chip.
    optimizer="adafactor", fsdp=True,
)

SMOKE = ModelConfig(
    name="llama4-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, d_head=16, block_pattern="moe",
    moe=MoEConfig(n_experts=4, top_k=1, d_ff_expert=128, n_shared=1),
    tie_embeddings=False, remat=False,
)
