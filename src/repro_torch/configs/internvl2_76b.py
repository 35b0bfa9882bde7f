"""InternVL2 76B [arXiv:2404.16821; unverified]: Llama3-70B-class LM backbone
(80L, d=8192, GQA kv=8); InternViT frontend is a stub (input_specs provides
patch embeddings)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=5e5,
    vision_tokens=256,
))
