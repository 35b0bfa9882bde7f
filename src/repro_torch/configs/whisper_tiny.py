"""Whisper tiny [arXiv:2212.04356; unverified]: enc-dec backbone; the conv
audio frontend is a stub (input_specs provides 1500 frame embeddings)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,              # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    encoder_layers=4,
    encoder_frames=1500,
    tie_embeddings=True,
))
