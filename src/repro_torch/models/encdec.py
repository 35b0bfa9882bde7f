"""Whisper-style encoder-decoder backbone (audio family), on PyTorch.

The counterpart of ``repro.models.encdec``. The conv frontend is a stub:
the batch supplies precomputed frame embeddings [B, frames, d_model]. The
backbone: a pre-LN transformer encoder (sinusoidal positions, non-causal
attention, no rope), a decoder with causal self-attention and
cross-attention (learned positions), GELU MLPs and the unembedding tied to
``embed``. The stacks are walked in Python loops; prefill computes each
layer's cross K/V once and returns it in the cache, and decode reads it
from there and writes the self-attention cache in place.

Every attention (the encoder's, unmasked; the decoder's causal self
attention; cross attention, unmasked) ends in ``layers.attend``. With
``ctx`` on a mesh, attention runs on this rank's heads and the MLPs on its
FFN columns (``transformer.tp_gqa_attention``, ``copy_to`` in and ``psum``
out, the MLP's output bias added after the sum), the embedding
and the tied logits on its vocabulary rows. The cross K/V cache keeps
every head, as the JAX package's cache layout holds it: prefill gathers
the heads, and decode reads the ones this rank's query heads need.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..distributed import collectives
from ..distributed.sharding import axis_index
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


def _plain_mlp(p, x, mesh=None):
    """With ``mesh``, on this rank's FFN columns, summed over ``model``."""
    x = collectives.copy_to(x, mesh, "model")
    h = gelu_tanh(torch.einsum("bsd,df->bsf", x, p["w1"]) + p["b1"])
    return collectives.psum(torch.einsum("bsf,fd->bsd", h, p["w2"]), mesh, "model") + p["b2"]


def _tp_mesh(ctx, sharded: int, full: int):
    """The mesh when a weight's dim is this rank's block (``sharded`` of
    ``full``), else None."""
    return ctx.mesh if ctx is not None and sharded < full else None


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


def _attn(cfg: ModelConfig, ctx, p, h, positions, **kw):
    """Self-attention without rope; on a mesh over this rank's heads."""
    from .transformer import tp_gqa_attention

    return tp_gqa_attention(ctx, p, h, positions, n_heads=cfg.n_heads,
                            n_kv_heads=cfg.n_kv_heads, use_rope=False, **kw)


def encode(cfg: ModelConfig, params, frames: torch.Tensor, ctx=None) -> torch.Tensor:
    """frames: [B, T, D] stub embeddings -> encoder states."""
    T = frames.shape[1]
    pos = torch.from_numpy(_sinusoids(T, cfg.d_model)).to(device=frames.device, dtype=frames.dtype)
    x = frames + pos
    zeros = torch.zeros(x.shape[:2], dtype=torch.int32, device=x.device)
    for p in params["encoder"]:
        h = layer_norm(x, p["ln1"]["w"], p["ln1"]["b"])
        attn, _ = _attn(cfg, ctx, p["attn"], h, zeros, causal=False)
        x_mid = x + attn
        h2 = layer_norm(x_mid, p["ln2"]["w"], p["ln2"]["b"])
        x = x_mid + _plain_mlp(p["mlp"], h2, _tp_mesh(ctx, p["mlp"]["w1"].shape[1], cfg.d_ff))
    return layer_norm(x, params["enc_ln"]["w"], params["enc_ln"]["b"])


def _cross(p, x, enc_k, enc_v, kv_index=None, einsum=torch.einsum):
    q = einsum("bsd,dhk->bshk", x, p["wq"]) + p["bq"]
    if kv_index is not None:
        enc_k, enc_v = enc_k[:, :, kv_index], enc_v[:, :, kv_index]
    out = causal_attention(q, enc_k, enc_v, causal=False)
    return einsum("bshk,hkd->bsd", out, p["wo"])


_cross_with_kv = _cross


def _enc_kv(p, enc, einsum=torch.einsum):
    k = einsum("btd,dhk->bthk", enc, p["wk"]) + p["bk"]
    v = einsum("btd,dhk->bthk", enc, p["wv"]) + p["bv"]
    return k, v


def _cross_block(cfg: ModelConfig, ctx, p, h, enc, cache, mode: str):
    """Cross attention: (its output, the cross K/V of every head for the
    cache). On a mesh over this rank's query heads; their K/V heads are
    its block when the K/V heads shard, else read from the whole. Where
    the query heads stay whole, every rank runs every head and splits the
    weights' gradients (``transformer.wgrad_split``)."""
    from .transformer import wgrad_split

    mesh = _tp_mesh(ctx, p["wq"].shape[1], cfg.n_heads)
    einsum = wgrad_split(ctx and ctx.mesh) if mesh is None else torch.einsum
    n_local = p["wq"].shape[1]
    kv_split = mesh is not None and p["wk"].shape[1] < cfg.n_kv_heads
    kv_index = None
    if mesh is not None and (mode == "decode" or not kv_split):
        first = axis_index(mesh, "model") * n_local
        kv_index = (first + torch.arange(n_local, device=h.device)) // (
            cfg.n_heads // cfg.n_kv_heads)
    if mode == "decode":
        enc_k, enc_v = cache["cross_k"], cache["cross_v"]
    else:
        if mesh is not None and not kv_split:  # whole K/V weights read by some heads only
            from .transformer import _with

            p = _with(p, **{k: collectives.copy_to(p[k], mesh, "model")
                            for k in ("wk", "wv", "bk", "bv")})
        enc_k, enc_v = _enc_kv(p, collectives.copy_to(enc, mesh, "model"), einsum)
    out = _cross_with_kv(p, collectives.copy_to(h, mesh, "model"), enc_k, enc_v, kv_index,
                         einsum)
    if mode == "prefill" and kv_split:  # the cache keeps every head
        enc_k = collectives.all_gather(enc_k, mesh, "model", dim=2)
        enc_v = collectives.all_gather(enc_v, mesh, "model", dim=2)
    return collectives.psum(out, mesh, "model"), enc_k, enc_v


def decoder_layer(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor,
                  enc: Optional[torch.Tensor], *, mode: str, cache=None,
                  cache_pos: Optional[int] = None, ctx=None):
    """One decoder layer: (its output, its cache) — prefill's self K/V and
    cross K/V, decode's ``cache`` written in place, train's None."""
    h = layer_norm(x, p["ln1"]["w"], p["ln1"]["b"])
    self_out, self_cache = _attn(
        cfg, ctx, p["self_attn"], h, positions,
        mode=mode, cache=cache["attn"] if cache else None, cache_pos=cache_pos,
        q_chunk=cfg.attn_q_chunk if mode != "decode" else None,
    )
    x_mid = x + self_out
    h2 = layer_norm(x_mid, p["ln2"]["w"], p["ln2"]["b"])
    cross_out, enc_k, enc_v = _cross_block(cfg, ctx, p["cross_attn"], h2, enc, cache, mode)
    x_mid = x_mid + cross_out
    h3 = layer_norm(x_mid, p["ln3"]["w"], p["ln3"]["b"])
    x_out = x_mid + _plain_mlp(p["mlp"], h3, _tp_mesh(ctx, p["mlp"]["w1"].shape[1], cfg.d_ff))
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
    ctx=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Returns (logits, caches): prefill's per-layer caches stacked
    ``[L, ...]`` (self-attention K/V and the cross K/V), decode's the
    ``caches`` given, written in place at ``cache_pos``. With ``ctx``, the
    logits are this rank's vocabulary columns when the vocabulary shards."""
    from .transformer import sharded_embed_lookup, wgrad_split

    B, S = tokens.shape
    dev = tokens.device
    if mode == "decode":
        positions = torch.full((B, S), cache_pos, dtype=torch.int32, device=dev)
        pos_ids = torch.full((S,), cache_pos, dtype=torch.long, device=dev)
    else:
        positions = torch.arange(S, device=dev)[None, :].expand(B, S)
        pos_ids = torch.arange(S, device=dev)
    x = sharded_embed_lookup(ctx, params["embed"], tokens, cfg.vocab_size) + \
        params["pos_embed"][pos_ids][None]

    per_layer = []
    for i, p in enumerate(params["decoder"]):
        x, cache_out = decoder_layer(cfg, p, x, positions, enc, mode=mode,
                                     cache=_layer_cache(caches, i), cache_pos=cache_pos, ctx=ctx)
        per_layer.append(cache_out)
    x = layer_norm(x, params["dec_ln"]["w"], params["dec_ln"]["b"])
    vocab_mesh = _tp_mesh(ctx, params["embed"].shape[0], cfg.vocab_size)
    x = collectives.copy_to(x, vocab_mesh, "model")
    einsum = torch.einsum if vocab_mesh is not None else wgrad_split(ctx and ctx.mesh)
    logits = einsum("bsd,vd->bsv", x, params["embed"])
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
