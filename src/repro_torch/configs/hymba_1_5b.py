"""Hymba 1.5B [arXiv:2411.13676; hf]: hybrid blocks with parallel attention
(sliding-window GQA kv=5) + selective-SSM heads (state 16). Meta tokens are
simplified away (DESIGN.md §5)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    sliding_window=1024,
))
