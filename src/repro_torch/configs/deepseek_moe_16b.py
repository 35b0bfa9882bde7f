"""DeepSeekMoE 16B [arXiv:2401.06066; hf]: 2 shared + 64 routed top-6
fine-grained experts, 28L, d_model 2048, first layer dense."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,              # dense FFN of the first layer
    vocab_size=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_ff_expert=1408,
    first_dense_layers=1,
    remat_policy="dots_plus_collectives",
))
