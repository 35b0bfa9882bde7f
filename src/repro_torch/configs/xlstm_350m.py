"""xLSTM 350M [arXiv:2405.04517; unverified]: sLSTM + mLSTM blocks (7:1),
24L, d_model 1024, matrix-memory heads; d_ff=0 (no separate FFN)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=8,           # one sLSTM per 8 blocks (7 mLSTM + 1 sLSTM)
))
