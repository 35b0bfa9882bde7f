"""DeepSeek-V2-Lite [arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2-Lite]:
MLA (kv_lora 512) with a direct query projection (no query LoRA) under
YaRN (factor 40 from a 4096-token origin), and fine-grained MoE (2 shared +
64 routed experts, top-6, greedy softmax routing, weights not
renormalised, dropless), 27 layers, d_model 2048, 16 heads.

Not one of the JAX package's ten architectures: it is not registered, so
``all_configs()`` stays theirs; import ``CONFIG`` from here."""
from .base import DeepSeekV2Config, YarnRope

CONFIG = DeepSeekV2Config(
    name="deepseek-v2-lite",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,              # dense FFN of the first (non-MoE) layer
    vocab_size=102400,
    rope_theta=10000.0,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_ff_expert=1408,
    first_dense_layers=1,
    use_mla=True,
    q_lora_rank=0,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    yarn=YarnRope(factor=40.0, original_max_position=4096, beta_fast=32.0, beta_slow=1.0,
                  mscale=0.707, mscale_all_dim=0.707),
    norm_topk_prob=False,
    dropless=True,
)
