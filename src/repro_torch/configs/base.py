"""Architecture configs and assigned input shapes.

Ten architectures (public-literature configs, DESIGN.md §5) selectable via
``--arch <id>``; each pairs with the four assigned LM shapes. ``input_specs``
returns meta-device tensors (shape and dtype, no allocation) for the
dry-run; modality frontends (audio/vision) are stubs whose precomputed
embeddings appear directly in the specs.

The counterpart of ``repro.configs.base`` field for field; ``dtype`` is a
torch dtype and ``param_count`` counts the declared parameters as
meta-device tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    activation: str = "silu"
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    scale_embeddings: bool = False  # gemma: x *= sqrt(d_model)
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    # --- MLA (DeepSeek-V2) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- hybrid / ssm ---
    ssm_state: int = 0
    ssm_expand: int = 2
    sliding_window: int = 0  # 0 = full attention
    slstm_every: int = 0  # xLSTM: one sLSTM per this many blocks
    # --- enc-dec / frontends ---
    encoder_layers: int = 0
    encoder_frames: int = 0  # audio stub: frames provided by input_specs
    vision_tokens: int = 0  # vlm stub: patch embeddings provided
    # --- numerics / perf knobs ---
    dtype: Any = torch.bfloat16
    remat_policy: str = "dots"  # none | dots | full
    #: unroll layer/chunk scans (cost-measurement mode: XLA's cost analysis
    #: counts while bodies once, so roofline calibration compiles unrolled
    #: reduced-layer variants)
    scan_unroll: bool = False
    attn_q_chunk: int = 1024
    logit_softcap: float = 0.0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 0.5M context (bounded per-token state)?"""
        return self.family in ("hybrid", "ssm")

    def param_count(self) -> int:
        """Approximate total parameter count (for 6ND roofline accounting)."""
        import math

        from ..models.layers import abstract_tree, tree_leaves
        from ..models.model import model_defs  # lazy: avoid cycle

        leaves = tree_leaves(abstract_tree(model_defs(self)))
        return sum(math.prod(l.shape) for l in leaves)

    def active_param_count(self) -> int:
        """Parameters active per token (MoE: shared + top_k experts)."""
        total = self.param_count()
        if not self.n_experts:
            return total
        per_expert = 3 * self.d_model * self.d_ff_expert
        n_moe_layers = self.n_layers - self.first_dense_layers
        inactive = (self.n_experts - self.top_k) * per_expert * n_moe_layers
        return total - inactive


# ---------------------------------------------------------------------------
# settings beyond the JAX package's (DeepSeek-V2's published arithmetic)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class YarnRope:
    """YaRN's rope scaling (arXiv:2309.00071), as DeepSeek-V2's
    ``rope_scaling`` states it."""

    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class DeepSeekV2Config(ModelConfig):
    """A ``ModelConfig`` with DeepSeek-V2's settings that the JAX package
    lacks. ``q_lora_rank = 0`` with ``use_mla`` is a direct query
    projection. Routing keeps the top-k softmax weights as they are unless
    ``norm_topk_prob`` (then they sum to one); DeepSeek's routed scale is
    taken as 1, Lite's. ``dropless`` runs every token-slot pair through its
    expert (one device only) in place of the capacity-bounded dispatch."""

    yarn: Optional[YarnRope] = None
    norm_topk_prob: bool = True
    dropless: bool = False


class ModelSettings(NamedTuple):
    """What model code reads beyond ``ModelConfig``'s fields; the defaults
    are what every ``ModelConfig`` computes."""

    yarn: Optional[YarnRope] = None
    norm_topk_prob: bool = True
    dropless: bool = False


def model_settings(cfg: ModelConfig) -> ModelSettings:
    """``cfg``'s settings beyond the JAX package's: a ``DeepSeekV2Config``'s
    own, the neutral ones for any other config."""
    if isinstance(cfg, DeepSeekV2Config):
        return ModelSettings(cfg.yarn, cfg.norm_topk_prob, cfg.dropless)
    return ModelSettings()


# ---------------------------------------------------------------------------
# assigned shapes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) — the 40-cell applicability matrix."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 0.5M-token dense KV decode skipped by design"
    return True, ""


def _spec(shape: Tuple[int, ...], dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Meta-device stand-ins for every model input of this cell."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    specs: Dict[str, torch.Tensor] = {}
    if shape.kind == "train":
        specs["tokens"] = _spec((B, S + 1), i32)
        if cfg.family == "audio":
            specs["frames"] = _spec(
                (B, cfg.encoder_frames, cfg.d_model), cfg.dtype
            )
        if cfg.family == "vlm":
            specs["patches"] = _spec(
                (B, cfg.vision_tokens, cfg.d_model), cfg.dtype
            )
    elif shape.kind == "prefill":
        specs["tokens"] = _spec((B, S), i32)
        if cfg.family == "audio":
            specs["frames"] = _spec(
                (B, cfg.encoder_frames, cfg.d_model), cfg.dtype
            )
        if cfg.family == "vlm":
            specs["patches"] = _spec(
                (B, cfg.vision_tokens, cfg.d_model), cfg.dtype
            )
    else:  # decode: one new token against a cache of seq_len
        specs["tokens"] = _spec((B, 1), i32)
    return specs


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> Dict[str, ModelConfig]:
    _ensure_loaded()
    return dict(_REGISTRY)


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    from . import (  # noqa: F401
        deepseek_moe_16b,
        deepseek_v2_236b,
        gemma_2b,
        granite_3_2b,
        hymba_1_5b,
        internlm2_20b,
        internvl2_76b,
        qwen2_5_32b,
        whisper_tiny,
        xlstm_350m,
    )


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (small everything)."""
    replace: Dict[str, Any] = dict(
        n_layers=min(cfg.n_layers, 2 if cfg.first_dense_layers else 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=32 if cfg.head_dim else None,
        attn_q_chunk=64,
    )
    if cfg.n_experts:
        replace.update(
            n_experts=8,
            top_k=2,
            d_ff_expert=64,
            n_shared_experts=min(cfg.n_shared_experts, 1),
            first_dense_layers=min(cfg.first_dense_layers, 1),
            n_layers=3,
            # dropless at smoke scale so decode/prefill/train paths agree
            # exactly (capacity effects are length-dependent by design)
            capacity_factor=8.0,
        )
    if cfg.use_mla:
        replace.update(
            q_lora_rank=64,
            kv_lora_rank=32,
            qk_nope_head_dim=32,
            qk_rope_head_dim=16,
            v_head_dim=32,
            head_dim=None,
        )
    if cfg.ssm_state:
        replace.update(ssm_state=8)
    if cfg.sliding_window:
        replace.update(sliding_window=64)
    if cfg.slstm_every:
        replace.update(slstm_every=2, n_layers=4)
    if cfg.encoder_layers:
        replace.update(encoder_layers=2, encoder_frames=32)
    if cfg.vision_tokens:
        replace.update(vision_tokens=16)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **replace)
