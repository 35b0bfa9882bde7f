"""Whisper-style encoder-decoder parameter declarations (audio family).

The declarations of ``repro.models.encdec``, so that
``ModelConfig.param_count`` counts the ``audio`` family (whisper-tiny) as
the JAX package does. The encoder, the decoder stack and
``cross_attention_block`` are not ported yet: ROADMAP.md, queue 1, item 5
ports them, and until then ``build_model`` raises for this family.
"""

from __future__ import annotations

from typing import Any, Dict

from ..configs.base import ModelConfig
from .layers import ParamDef, gqa_defs, stack_defs

MAX_DECODER_POS = 1 << 16


def _plain_mlp_defs(d_model: int, d_ff: int) -> Dict[str, ParamDef]:
    return {
        "w1": ParamDef((d_model, d_ff), ("embed", "ffn")),
        "b1": ParamDef((d_ff,), ("ffn",), init="zeros"),
        "w2": ParamDef((d_ff, d_model), ("ffn", "embed")),
        "b2": ParamDef((d_model,), ("embed",), init="zeros"),
    }


def _ln_defs(d: int) -> Dict[str, ParamDef]:
    return {"w": ParamDef((d,), ("embed",), init="ones"), "b": ParamDef((d,), ("embed",), init="zeros")}


def _attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    return gqa_defs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, qkv_bias=True)


def encdec_defs(cfg: ModelConfig) -> Dict[str, Any]:
    D, V = cfg.d_model, cfg.vocab_size
    enc_block = {
        "ln1": _ln_defs(D),
        "attn": _attn_defs(cfg),
        "ln2": _ln_defs(D),
        "mlp": _plain_mlp_defs(D, cfg.d_ff),
    }
    dec_block = {
        "ln1": _ln_defs(D),
        "self_attn": _attn_defs(cfg),
        "ln2": _ln_defs(D),
        "cross_attn": _attn_defs(cfg),
        "ln3": _ln_defs(D),
        "mlp": _plain_mlp_defs(D, cfg.d_ff),
    }
    return {
        "embed": ParamDef((V, D), ("vocab", "embed"), scale=D ** -0.5),
        "pos_embed": ParamDef((MAX_DECODER_POS, D), (None, "embed"), scale=0.02),
        "encoder": stack_defs(enc_block, cfg.encoder_layers),
        "enc_ln": _ln_defs(D),
        "decoder": stack_defs(dec_block, cfg.n_layers),
        "dec_ln": _ln_defs(D),
    }
