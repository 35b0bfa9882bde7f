"""Whisper-style encoder-decoder backbone (audio family), on PyTorch.

The counterpart of ``repro.models.encdec``. The conv frontend is a stub:
the batch supplies precomputed frame embeddings [B, frames, d_model]. The
backbone: a pre-LN transformer encoder (sinusoidal positions, non-causal
attention, no rope), a decoder with causal self-attention and
cross-attention (learned positions), GELU MLPs and the unembedding tied to
``embed``. The stacks are walked in Python loops; prefill computes each
layer's cross K/V once and returns it in the cache, and decode reads it
from there and writes the self-attention cache in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from .layers import (
    ParamDef,
    causal_attention,
    gelu_tanh,
    gqa_attention_block,
    gqa_defs,
    init_kv_cache,
    layer_norm,
    stack_defs,
    tree_map,
)

MAX_DECODER_POS = 1 << 16


def _plain_mlp_defs(d_model: int, d_ff: int) -> Dict[str, ParamDef]:
    return {
        "w1": ParamDef((d_model, d_ff), ("embed", "ffn")),
        "b1": ParamDef((d_ff,), ("ffn",), init="zeros"),
        "w2": ParamDef((d_ff, d_model), ("ffn", "embed")),
        "b2": ParamDef((d_model,), ("embed",), init="zeros"),
    }


def _plain_mlp(p, x):
    h = gelu_tanh(torch.einsum("bsd,df->bsf", x, p["w1"]) + p["b1"])
    return torch.einsum("bsf,fd->bsd", h, p["w2"]) + p["b2"]


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


def _sinusoids(length: int, d: int) -> np.ndarray:
    half = d // 2
    scale = np.log(10000.0) / max(1, half - 1)
    inv = np.exp(-scale * np.arange(half))
    pos = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(pos), np.cos(pos)], axis=1).astype(np.float32)


def _layer_cache(caches: Optional[Dict[str, Any]], i: int):
    """Layer ``i``'s slice of stacked caches: views, so writes land in them."""
    if caches is None:
        return None
    return {k: _layer_cache(v, i) if isinstance(v, dict) else v[i] for k, v in caches.items()}


def encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames: [B, T, D] stub embeddings -> encoder states."""
    T = frames.shape[1]
    pos = torch.from_numpy(_sinusoids(T, cfg.d_model)).to(device=frames.device, dtype=frames.dtype)
    x = frames + pos
    zeros = torch.zeros(x.shape[:2], dtype=torch.int32, device=x.device)
    for p in params["encoder"]:
        h = layer_norm(x, p["ln1"]["w"], p["ln1"]["b"])
        attn, _ = gqa_attention_block(p["attn"], h, zeros, causal=False, use_rope=False)
        x_mid = x + attn
        h2 = layer_norm(x_mid, p["ln2"]["w"], p["ln2"]["b"])
        x = x_mid + _plain_mlp(p["mlp"], h2)
    return layer_norm(x, params["enc_ln"]["w"], params["enc_ln"]["b"])


def _cross(p, x, enc_k, enc_v):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"]) + p["bq"]
    out = causal_attention(q, enc_k, enc_v, causal=False)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


_cross_with_kv = _cross


def _enc_kv(p, enc):
    k = torch.einsum("btd,dhk->bthk", enc, p["wk"]) + p["bk"]
    v = torch.einsum("btd,dhk->bthk", enc, p["wv"]) + p["bv"]
    return k, v


def decoder_layer(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor,
                  enc: Optional[torch.Tensor], *, mode: str, cache=None,
                  cache_pos: Optional[int] = None):
    """One decoder layer: (its output, its cache) — prefill's self K/V and
    cross K/V, decode's ``cache`` written in place, train's None."""
    h = layer_norm(x, p["ln1"]["w"], p["ln1"]["b"])
    self_out, self_cache = gqa_attention_block(
        p["self_attn"], h, positions,
        mode=mode, cache=cache["attn"] if cache else None,
        cache_pos=cache_pos, use_rope=False,
        q_chunk=cfg.attn_q_chunk if mode != "decode" else None,
    )
    x_mid = x + self_out
    h2 = layer_norm(x_mid, p["ln2"]["w"], p["ln2"]["b"])
    if mode == "decode":
        enc_k, enc_v = cache["cross_k"], cache["cross_v"]
    else:
        enc_k, enc_v = _enc_kv(p["cross_attn"], enc)
    x_mid = x_mid + _cross_with_kv(p["cross_attn"], h2, enc_k, enc_v)
    h3 = layer_norm(x_mid, p["ln3"]["w"], p["ln3"]["b"])
    x_out = x_mid + _plain_mlp(p["mlp"], h3)
    if mode == "prefill":
        return x_out, {"attn": self_cache, "cross_k": enc_k, "cross_v": enc_v}
    return x_out, cache


def decode_stack(
    cfg: ModelConfig,
    params,
    tokens: torch.Tensor,
    enc: Optional[torch.Tensor],
    *,
    mode: str = "train",
    caches: Optional[Dict[str, Any]] = None,
    cache_pos: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Returns (logits, caches): prefill's per-layer caches stacked
    ``[L, ...]`` (self-attention K/V and the cross K/V), decode's the
    ``caches`` given, written in place at ``cache_pos``."""
    B, S = tokens.shape
    dev = tokens.device
    if mode == "decode":
        positions = torch.full((B, S), cache_pos, dtype=torch.int32, device=dev)
        pos_ids = torch.full((S,), cache_pos, dtype=torch.long, device=dev)
    else:
        positions = torch.arange(S, device=dev)[None, :].expand(B, S)
        pos_ids = torch.arange(S, device=dev)
    x = params["embed"][tokens] + params["pos_embed"][pos_ids][None]

    per_layer = []
    for i, p in enumerate(params["decoder"]):
        x, cache_out = decoder_layer(cfg, p, x, positions, enc, mode=mode,
                                     cache=_layer_cache(caches, i), cache_pos=cache_pos)
        per_layer.append(cache_out)
    x = layer_norm(x, params["dec_ln"]["w"], params["dec_ln"]["b"])
    logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
    if mode == "prefill":
        return logits, {"attn": {k: torch.stack([c["attn"][k] for c in per_layer])
                                 for k in ("k", "v")},
                        "cross_k": torch.stack([c["cross_k"] for c in per_layer]),
                        "cross_v": torch.stack([c["cross_v"] for c in per_layer])}
    return logits, caches


def init_decoder_caches(cfg: ModelConfig, batch: int, max_len: int, enc_frames: int,
                        device="cpu") -> Dict[str, Any]:
    shape = (batch, enc_frames, cfg.n_kv_heads, cfg.resolved_head_dim)
    one = {
        "attn": init_kv_cache(batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.dtype,
                              device=device),
        "cross_k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "cross_v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }
    return tree_map(lambda leaf: leaf[None].expand((cfg.n_layers,) + leaf.shape).clone(), one)
