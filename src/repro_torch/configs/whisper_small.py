"""whisper-small [audio] — enc-dec, 12L each, d768 12H d_ff 3072
vocab 51865; conv frontend STUBBED per the assignment (input_specs()
provides precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
from .common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=51865, block_pattern="encdec", norm="layernorm", mlp_act="gelu",
    frontend="audio_stub", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=512, block_pattern="encdec", norm="layernorm", mlp_act="gelu",
    frontend="audio_stub", remat=False,
)
