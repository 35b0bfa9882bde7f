"""DeepSeek-V2 236B [arXiv:2405.04434; hf]: MLA (kv_lora=512) + fine-grained
MoE (2 shared + 160 routed, top-6), 60L, d_model 5120, 128 heads."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,              # dense FFN of the first (non-MoE) layer
    vocab_size=102400,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    d_ff_expert=1536,
    first_dense_layers=1,
    remat_policy="dots_plus_collectives",
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
))
