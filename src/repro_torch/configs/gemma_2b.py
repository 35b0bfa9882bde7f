"""Gemma 2B [arXiv:2403.08295; hf]: MQA (kv=1), GeGLU, head_dim=256,
scaled + tied embeddings."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=256000,
    head_dim=256,
    activation="gelu",
    tie_embeddings=True,
    scale_embeddings=True,
))
