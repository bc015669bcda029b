"""xlstm-1.3b [ssm] — 48L d2048 4H, sLSTM + mLSTM blocks (unit of 8:
7 mLSTM + 1 sLSTM). d_ff=0 (cell projections replace the FFN).
[arXiv:2405.04517; unverified]"""
from .common import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, block_pattern="xlstm",
)

SMOKE = ModelConfig(
    name="xlstm-smoke", family="ssm",
    n_layers=8, d_model=32, n_heads=2, n_kv_heads=2, d_ff=0,
    vocab=256, block_pattern="xlstm", remat=False,
)
