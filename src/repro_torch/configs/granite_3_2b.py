"""Granite 3.0 2B [hf:ibm-granite/granite-3.0-2b-base; hf]: dense GQA kv=8."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    tie_embeddings=True,
))
