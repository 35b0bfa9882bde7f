"""Decoder-only transformer assembly for the dense / MoE / MLA / hybrid / VLM
configs, on PyTorch.

The counterpart of ``repro.models.transformer`` on one card. Parameters are
declared stacked (``[L, ...]``, ``decoder_defs``, as in the JAX package) and
held per layer: each stack is an ``nn.ModuleList`` that ``forward`` walks
in a Python loop (no scan, no remat, no sharding constraints). Caches are
dicts of tensors stacked per layer ``[L, B, ...]``; a layer reads and, in
decode, writes its slice in place.

Three execution modes:
  * train   - no caches; chunked causal attention bounds memory.
  * prefill - emits per-layer cache tensors, stacked ``[L, B, S, ...]``.
  * decode  - one token against the caches, updated in place (linear, or a
              ring for a sliding window; MLA decodes in the absorbed
              compressed-cache form).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from .layers import (
    ParamDef,
    apply_rope,
    at_least_fp32,
    causal_attention,
    gated_mlp,
    gated_mlp_defs,
    gqa_attention_block,
    gqa_defs,
    init_kv_cache,
    rms_norm,
    stack_defs,
    tree_map,
)
from .moe import moe_defs, moe_layer
from .ssm import init_ssm_state, selective_ssm, ssm_defs

#: The stacks a decoder declares, in the order ``forward`` runs them.
STACKS = (("layers", False), ("dense_layers", False), ("moe_layers", True))


# ---------------------------------------------------------------------------
# parameter definitions
# ---------------------------------------------------------------------------

def _attn_defs(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.use_mla:
        qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        return {
            "w_dq": ParamDef((cfg.d_model, cfg.q_lora_rank), ("embed", "qk_lora")),
            "q_norm": ParamDef((cfg.q_lora_rank,), ("qk_lora",), init="zeros"),
            "w_uq": ParamDef((cfg.q_lora_rank, cfg.n_heads, qk_dim), ("qk_lora", "heads", None)),
            "w_dkv": ParamDef(
                (cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_head_dim), ("embed", "qk_lora")
            ),
            "kv_norm": ParamDef((cfg.kv_lora_rank,), ("qk_lora",), init="zeros"),
            "w_uk": ParamDef(
                (cfg.kv_lora_rank, cfg.n_heads, cfg.qk_nope_head_dim), ("qk_lora", "heads", None)
            ),
            "w_uv": ParamDef(
                (cfg.kv_lora_rank, cfg.n_heads, cfg.v_head_dim), ("qk_lora", "heads", None)
            ),
            "wo": ParamDef((cfg.n_heads, cfg.v_head_dim, cfg.d_model), ("heads", None, "embed")),
        }
    return gqa_defs(
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias
    )


def decoder_defs(cfg: ModelConfig) -> Dict[str, Any]:
    D, V = cfg.d_model, cfg.vocab_size
    defs: Dict[str, Any] = {
        "embed": ParamDef((V, D), ("vocab", "embed"), scale=D ** -0.5),
        "final_norm": ParamDef((D,), ("embed",), init="zeros"),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((D, V), ("embed", "vocab"))

    def block_defs(moe: bool) -> Dict[str, Any]:
        blk: Dict[str, Any] = {
            "norm1": ParamDef((D,), ("embed",), init="zeros"),
            "norm2": ParamDef((D,), ("embed",), init="zeros"),
            "attn": _attn_defs(cfg),
        }
        if not moe:  # moe_defs stacks itself; added below
            blk["mlp"] = gated_mlp_defs(D, cfg.d_ff)
        if cfg.family == "hybrid":
            blk["ssm"] = ssm_defs(0, D, cfg.ssm_expand * D, cfg.ssm_state)
            blk["attn_scale"] = ParamDef((D,), ("embed",), init="zeros")
            blk["ssm_scale"] = ParamDef((D,), ("embed",), init="zeros")
        return blk

    def stacked_block(n: int, moe: bool) -> Dict[str, Any]:
        blk = stack_defs(block_defs(moe), n)
        if moe:
            blk["moe"] = moe_defs(n, D, cfg.n_experts, cfg.d_ff_expert, cfg.n_shared_experts)
        return blk

    if cfg.n_experts and cfg.first_dense_layers:
        defs["dense_layers"] = stacked_block(cfg.first_dense_layers, moe=False)
        defs["moe_layers"] = stacked_block(cfg.n_layers - cfg.first_dense_layers, moe=True)
    elif cfg.n_experts:
        defs["moe_layers"] = stacked_block(cfg.n_layers, moe=True)
    else:
        defs["layers"] = stacked_block(cfg.n_layers, moe=False)
    return defs


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

def _mla_attention(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    mode: str,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos: Optional[int] = None,
    q_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Multi-head Latent Attention. Decode runs the absorbed form against
    the compressed cache [B, S, kv_lora] + [B, S, rope_d], written in
    place."""
    B, S, _ = x.shape
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    scale = float((nope + rope_d) ** -0.5)

    cq = rms_norm(torch.einsum("bsd,dr->bsr", x, p["w_dq"]), p["q_norm"])
    q = torch.einsum("bsr,rhk->bshk", cq, p["w_uq"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    ckv_full = torch.einsum("bsd,dr->bsr", x, p["w_dkv"])
    c_kv = rms_norm(ckv_full[..., : cfg.kv_lora_rank], p["kv_norm"])
    k_rope = apply_rope(ckv_full[:, :, None, cfg.kv_lora_rank :], positions, cfg.rope_theta)[:, :, 0]

    if mode != "decode":
        k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uk"])
        v = torch.einsum("bsr,rhv->bshv", c_kv, p["w_uv"])
        k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, cfg.n_heads, rope_d)], dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        out = causal_attention(qq, k, v, q_chunk=q_chunk, softmax_scale=scale)
        y = torch.einsum("bshv,hvd->bsd", out, p["wo"])
        cache_out = {"c_kv": c_kv, "k_rope": k_rope} if mode == "prefill" else None
        return y, cache_out

    assert S == 1 and cache is not None and cache_pos is not None
    ckv_cache, kr_cache = cache["c_kv"], cache["k_rope"]
    ckv_cache[:, cache_pos] = c_kv[:, 0]
    kr_cache[:, cache_pos] = k_rope[:, 0]
    q_c = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])  # absorb W_uk
    scores = (
        torch.einsum("bshr,btr->bhst", at_least_fp32(q_c), at_least_fp32(ckv_cache))
        + torch.einsum("bshk,btk->bhst", at_least_fp32(q_rope), at_least_fp32(kr_cache))
    ) * scale
    t_pos = torch.arange(ckv_cache.shape[1], device=x.device)
    scores = torch.where((t_pos <= cache_pos)[None, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    ctx_c = torch.einsum("bhst,btr->bshr", probs.to(ckv_cache.dtype), ckv_cache)
    out = torch.einsum("bshr,rhv->bshv", ctx_c, p["w_uv"])
    y = torch.einsum("bshv,hvd->bsd", out, p["wo"])
    return y, cache


# ---------------------------------------------------------------------------
# blocks & stacks
# ---------------------------------------------------------------------------

def _block(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    moe: bool,
    mode: str,
    cache: Optional[Dict[str, Any]] = None,
    cache_pos: Optional[int] = None,
    q_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], torch.Tensor]:
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["norm1"])

    attn_cache = cache.get("attn") if cache else None
    if cfg.use_mla:
        attn_out, attn_cache_out = _mla_attention(
            cfg, p["attn"], h, positions, mode=mode,
            cache=attn_cache, cache_pos=cache_pos, q_chunk=q_chunk,
        )
    else:
        attn_out, attn_cache_out = gqa_attention_block(
            p["attn"], h, positions,
            rope_theta=cfg.rope_theta, mode=mode,
            cache=attn_cache, cache_pos=cache_pos,
            sliding_window=cfg.sliding_window or None, q_chunk=q_chunk,
        )
    cache_out: Dict[str, Any] = {}
    if attn_cache_out is not None:
        cache_out["attn"] = attn_cache_out

    if cfg.family == "hybrid":
        if mode == "train":
            ssm_state = None
        elif mode == "prefill":
            ssm_state = init_ssm_state(x.shape[0], cfg.ssm_expand * cfg.d_model, cfg.ssm_state,
                                       device=x.device, dtype=cfg.dtype)
        else:
            ssm_state = cache.get("ssm") if cache else None
        ssm_out, ssm_state_out = selective_ssm(p["ssm"], h, state=ssm_state)
        if ssm_state_out is not None:
            if mode == "decode":  # into the stacked cache, in place
                for k, t in ssm_state_out.items():
                    ssm_state[k].copy_(t)
                ssm_state_out = ssm_state
            cache_out["ssm"] = ssm_state_out
        fused = 0.5 * (rms_norm(attn_out, p["attn_scale"]) + rms_norm(ssm_out, p["ssm_scale"]))
        x = x + fused
    else:
        x = x + attn_out

    h2 = rms_norm(x, p["norm2"])
    if moe:
        mlp_out, aux = moe_layer(
            p["moe"], h2, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, activation=cfg.activation,
        )
        if "shared" in p["moe"]:
            mlp_out = mlp_out + gated_mlp(p["moe"]["shared"], h2, cfg.activation)
    else:
        mlp_out = gated_mlp(p["mlp"], h2, cfg.activation)
    x = x + mlp_out
    return x, (cache_out or None), aux


def _layer_cache(caches: Optional[Dict[str, Any]], i: int):
    """Layer ``i``'s slice of stacked caches: views, so writes land in them."""
    if caches is None:
        return None
    return {k: _layer_cache(v, i) if isinstance(v, dict) else v[i] for k, v in caches.items()}


def _stack_caches(per_layer):
    """Per-layer cache dicts stacked along a new leading layer dim."""
    first = per_layer[0]
    return {k: _stack_caches([c[k] for c in per_layer]) if isinstance(first[k], dict)
            else torch.stack([c[k] for c in per_layer]) for k in first}


def _run_stack(
    cfg: ModelConfig,
    layers,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    moe: bool,
    mode: str,
    caches: Optional[Dict[str, Any]] = None,
    cache_pos: Optional[int] = None,
    q_chunk: Optional[int] = None,
):
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    per_layer = []
    for i, p in enumerate(layers):
        x, cache_out, aux = _block(
            cfg, p, x, positions,
            moe=moe, mode=mode, cache=_layer_cache(caches, i), cache_pos=cache_pos,
            q_chunk=q_chunk,
        )
        aux_total = aux_total + aux
        per_layer.append(cache_out)
    if mode == "prefill":
        return x, aux_total, _stack_caches(per_layer)
    return x, aux_total, caches


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32).to(x.dtype)
    return x


def unembed(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
    else:
        logits = torch.einsum("bsd,dv->bsv", x, params["unembed"])
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def forward(
    cfg: ModelConfig,
    params,
    tokens: torch.Tensor,  # [B, S]
    *,
    mode: str = "train",
    prefix_embeds: Optional[torch.Tensor] = None,
    caches: Optional[Dict[str, Any]] = None,
    cache_pos: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict[str, Any]]]:
    """Returns (logits, aux_loss, caches_out); decode writes ``caches`` in
    place at ``cache_pos`` and returns them."""
    x = embed_tokens(cfg, params, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    if mode == "decode":
        positions = torch.full((B, 1), cache_pos, dtype=torch.int32, device=x.device)
    else:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    q_chunk = cfg.attn_q_chunk if (mode != "decode" and S > cfg.attn_q_chunk) else None

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches_out: Dict[str, Any] = {}
    for stack_name, moe in STACKS:
        if stack_name not in params:
            continue
        x, aux, nc = _run_stack(
            cfg, params[stack_name], x, positions,
            moe=moe, mode=mode,
            caches=caches.get(stack_name) if caches else None,
            cache_pos=cache_pos, q_chunk=q_chunk,
        )
        aux_total = aux_total + aux
        if nc is not None:
            caches_out[stack_name] = nc

    x = rms_norm(x, params["final_norm"])
    logits = unembed(cfg, params, x)
    return logits, aux_total, (caches_out or None)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int, device="cpu") -> Dict[str, Any]:
    """Stacked decode caches. Sliding-window archs get ring buffers."""

    def one_layer_cache() -> Dict[str, Any]:
        c: Dict[str, Any] = {}
        if cfg.use_mla:
            c["attn"] = {
                "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=cfg.dtype,
                                    device=device),
                "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim), dtype=cfg.dtype,
                                      device=device),
            }
        else:
            ring = bool(cfg.sliding_window) and cfg.sliding_window < max_len
            kv_len = cfg.sliding_window if ring else max_len
            c["attn"] = init_kv_cache(
                batch, kv_len, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.dtype, ring=ring,
                device=device,
            )
        if cfg.family == "hybrid":
            c["ssm"] = init_ssm_state(batch, cfg.ssm_expand * cfg.d_model, cfg.ssm_state,
                                      device=device, dtype=cfg.dtype)
        return c

    def stacked(n: int):
        return tree_map(lambda leaf: leaf[None].expand((n,) + leaf.shape).clone(),
                        one_layer_cache())

    caches: Dict[str, Any] = {}
    if cfg.n_experts and cfg.first_dense_layers:
        caches["dense_layers"] = stacked(cfg.first_dense_layers)
        caches["moe_layers"] = stacked(cfg.n_layers - cfg.first_dense_layers)
    elif cfg.n_experts:
        caches["moe_layers"] = stacked(cfg.n_layers)
    else:
        caches["layers"] = stacked(cfg.n_layers)
    return caches
