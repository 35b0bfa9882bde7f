"""Decoder-only transformer assembly for the dense / MoE / MLA / hybrid / VLM
configs, on PyTorch.

The counterpart of ``repro.models.transformer``. Parameters are declared
stacked (``[L, ...]``, ``decoder_defs``, as in the JAX package) and held per
layer: each stack is an ``nn.ModuleList`` that ``forward`` walks in a
Python loop (no scan). In train mode each layer runs under
``torch.utils.checkpoint`` as ``cfg.remat_policy`` says (``_remat``, the
JAX package's ``jax.checkpoint`` policies). Caches are dicts of tensors
stacked per layer ``[L, B, ...]``; a layer reads and, in decode, writes
its slice in place.

On a mesh (``ctx = ModelContext(mesh, rules)``) every tensor is this
rank's block: the batch rows of its DP coordinates, and the heads, FFN
columns, vocabulary rows and experts its specs give it. Where the JAX
package leaves the partitioning to GSPMD, the port says where ranks meet,
Megatron-style: a replicated activation enters a model-sharded region
through ``collectives.copy_to`` and a partial result leaves it through
``collectives.psum`` (attention over heads, the MLP over its FFN columns,
MLA over heads, the vocabulary of the embedding and the logits); the MoE
layer and the embedding lookup are the JAX package's own ``shard_map``
regions; the hybrid's SSM branch splits its channels (``ssm.py``).
``constrain`` stands at the JAX package's places; on the plain blocks the
port holds it changes nothing. Off a mesh (``ctx`` None) the code is the
one-card path, operation for operation.

Three execution modes:
  * train   - no caches; chunked causal attention bounds memory.
  * prefill - emits per-layer cache tensors, stacked ``[L, B, S, ...]``.
  * decode  - one token against the caches, updated in place (linear, or a
              ring for a sliding window; MLA decodes in the absorbed
              compressed-cache form).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig, model_settings
from ..distributed import collectives
from ..distributed.sharding import ShardingRules, axis_index, axis_size, constrain, mesh_shape
from ..obs import trace as _obs_trace
from .layers import (
    ParamDef,
    apply_rope,
    at_least_fp32,
    attend,
    causal_attention,
    gated_mlp,
    gated_mlp_defs,
    gqa_attention_block,
    gqa_decode,
    gqa_defs,
    init_kv_cache,
    project_qkv,
    rms_norm,
    stack_defs,
    tree_map,
    visible,
    write_kv,
    yarn_rope,
)
from .moe import moe_defs, moe_layer
from .ssm import init_ssm_state, selective_ssm, ssm_defs

#: The stacks a decoder declares, in the order ``forward`` runs them.
STACKS = (("layers", False), ("dense_layers", False), ("moe_layers", True))


@dataclasses.dataclass(frozen=True)
class ModelContext:
    mesh: Any
    rules: ShardingRules
    #: The mesh axis the decode caches' sequence dim is split over (the
    #: serve step's flash-decode layout, ``serve_step.cache_shardings``).
    cache_seq_axis: Optional[str] = None

    @property
    def tp(self) -> int:
        return axis_size(self.mesh, "model")

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """The DP axes the batch rows are split over."""
        return tuple(a for a in ("pod", "data") if a in mesh_shape(self.mesh))


def _mesh(ctx: Optional[ModelContext]):
    return ctx.mesh if ctx is not None else None


def _rules(ctx: Optional[ModelContext]):
    return ctx.rules if ctx is not None else None


def _tp(ctx: Optional[ModelContext]) -> int:
    return ctx.tp if ctx is not None else 1


def _with(p, **replaced) -> Dict[str, Any]:
    """The entries of a parameter node as a dict, some replaced."""
    keys = p._keys if hasattr(p, "_keys") else list(p)  # noqa: SLF001
    return {k: replaced.get(k, p[k]) for k in keys}


# ---------------------------------------------------------------------------
# parameter definitions
# ---------------------------------------------------------------------------

def _attn_defs(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.use_mla:
        qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        if cfg.q_lora_rank:
            query = {
                "w_dq": ParamDef((cfg.d_model, cfg.q_lora_rank), ("embed", "qk_lora")),
                "q_norm": ParamDef((cfg.q_lora_rank,), ("qk_lora",), init="zeros"),
                "w_uq": ParamDef((cfg.q_lora_rank, cfg.n_heads, qk_dim),
                                 ("qk_lora", "heads", None)),
            }
        else:  # a direct query projection (DeepSeek-V2-Lite)
            query = {"w_q": ParamDef((cfg.d_model, cfg.n_heads, qk_dim), ("embed", "heads", None))}
        return dict(query, **{
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
        })
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
    mesh=None,
    split=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Multi-head Latent Attention. Decode runs the absorbed form against
    the compressed cache [B, S, kv_lora] + [B, S, rope_d], written in
    place. The query is projected through its LoRA (``w_dq``, ``q_norm``,
    ``w_uq``), or directly (``w_q``) where ``q_lora_rank`` is 0; under YaRN
    (``model_settings(cfg).yarn``) the rope dims take YaRN's frequencies and
    the softmax scale its temperature (``layers.yarn_rope``). The score,
    softmax and value part is the span ``mla.attend``. With ``mesh``, the
    heads are this rank's block of ``model``: the replicated latents enter
    through ``copy_to`` (their down projections' gradients split,
    ``wgrad_split``) and the output leaves through ``psum``. With ``split``
    (a mesh), the cache holds this rank's block of positions along
    ``model`` and decode is flash-decode (``layers.attend``'s ``split``)."""
    B, S, _ = x.shape
    enter = lambda t: collectives.copy_to(t, mesh, "model")  # noqa: E731
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    scale = float((nope + rope_d) ** -0.5)
    yarn = model_settings(cfg).yarn
    freqs, rotated = None, 1.0
    if yarn is not None:
        freqs, rotated, temperature = yarn_rope(yarn, rope_d, float(cfg.rope_theta), x.device)
        scale *= temperature

    def rope(t: torch.Tensor) -> torch.Tensor:
        t = apply_rope(t, positions, cfg.rope_theta, freqs)
        return t if rotated == 1.0 else t * rotated

    down = wgrad_split(mesh)
    if cfg.q_lora_rank:
        cq = rms_norm(down("bsd,dr->bsr", x, p["w_dq"]), p["q_norm"])
        q = torch.einsum("bsr,rhk->bshk", enter(cq), p["w_uq"])
    else:
        q = torch.einsum("bsd,dhk->bshk", enter(x), p["w_q"])
    n_heads = q.shape[2]
    q_nope = q[..., :nope]

    ckv_full = down("bsd,dr->bsr", x, p["w_dkv"])
    c_kv = rms_norm(ckv_full[..., : cfg.kv_lora_rank], p["kv_norm"])
    k_rope = ckv_full[:, :, None, cfg.kv_lora_rank :]
    if mode == "decode":  # one rope call for the query and the key: fewer launches a step
        q_rope, k_rope = rope(torch.cat([q[..., nope:], k_rope], dim=2)).split([n_heads, 1], 2)
    else:  # no copy of the query's rope dims at long sequences
        q_rope, k_rope = rope(q[..., nope:]), rope(k_rope)
    k_rope = k_rope[:, :, 0]

    if mode != "decode":
        with _obs_trace.span("mla.attend"):
            k_nope = torch.einsum("bsr,rhk->bshk", enter(c_kv), p["w_uk"])
            v = torch.einsum("bsr,rhv->bshv", enter(c_kv), p["w_uv"])
            k = torch.cat([k_nope, enter(k_rope)[:, :, None].expand(B, S, n_heads, rope_d)],
                          dim=-1)
            qq = torch.cat([q_nope, q_rope], dim=-1)
            out = causal_attention(qq, k, v, q_chunk=q_chunk, softmax_scale=scale)
        y = collectives.psum(torch.einsum("bshv,hvd->bsd", out, p["wo"]), mesh, "model")
        cache_out = {"c_kv": c_kv, "k_rope": k_rope} if mode == "prefill" else None
        return y, cache_out

    assert S == 1 and cache is not None and cache_pos is not None
    with _obs_trace.span("mla.attend"):
        out = _mla_decode(q_nope, q_rope, c_kv, k_rope, p, cache, cache_pos, scale,
                          mesh=mesh, split=split)
    y = collectives.psum(torch.einsum("bshv,hvd->bsd", out, p["wo"]), mesh, "model")
    return y, cache


def _mla_decode(q_nope, q_rope, c_kv, k_rope, p, cache, cache_pos: int, scale: float, *,
                mesh, split) -> torch.Tensor:
    """MLA's absorbed decode against the compressed cache: the new token's
    latents written at ``cache_pos``, ``W_uk`` absorbed into the query, the
    scores over every cached position (the latent and the rope product,
    summed), ``layers.attend`` with the latent values, and ``W_uv``;
    [B, 1, H, v_head_dim]."""
    n_heads = q_nope.shape[2]
    ckv_cache, kr_cache = cache["c_kv"], cache["k_rope"]
    first = axis_index(split, "model") * ckv_cache.shape[1]  # this rank's positions
    if first <= cache_pos < first + ckv_cache.shape[1]:
        ckv_cache[:, cache_pos - first] = c_kv[:, 0]
        kr_cache[:, cache_pos - first] = k_rope[:, 0]
    q_c = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])  # absorb W_uk
    if split is not None and mesh is not None:  # every head against this rank's positions
        q_c = collectives.all_gather(q_c, split, "model", dim=2)
        q_rope = collectives.all_gather(q_rope, split, "model", dim=2)
    t_pos = torch.arange(first, first + ckv_cache.shape[1], device=q_nope.device)
    ctx_c = attend((
        torch.einsum("bshr,btr->bhst", at_least_fp32(q_c), at_least_fp32(ckv_cache))
        + torch.einsum("bshk,btk->bhst", at_least_fp32(q_rope), at_least_fp32(kr_cache))
    ) * scale, visible(t_pos, cache_pos), ckv_cache, _latent_values, split)
    if split is not None and mesh is not None:
        ctx_c = ctx_c[:, :, axis_index(mesh, "model") * n_heads:][:, :, :n_heads]
    return torch.einsum("bshr,rhv->bshv", ctx_c, p["w_uv"])


def _latent_values(probs: torch.Tensor, ckv_cache: torch.Tensor) -> torch.Tensor:
    """MLA's value product in the latent: probs [B, H, 1, T] against the
    cache [B, T, kv_lora] -> [B, 1, H, kv_lora]."""
    return torch.einsum("bhst,btr->bshr", probs.to(ckv_cache.dtype), ckv_cache)


# ---------------------------------------------------------------------------
# blocks & stacks
# ---------------------------------------------------------------------------

def _attention(cfg: ModelConfig, ctx, p, h, positions, **kw):
    """The block's attention; on a mesh over this rank's heads (when the
    heads shard over ``model``), summed over ``model``."""
    if cfg.use_mla:
        mesh = _mesh(ctx)
        query = p["w_uq"] if cfg.q_lora_rank else p["w_q"]
        sharded = _tp(ctx) > 1 and query.shape[1] < cfg.n_heads
        return _mla_attention(cfg, p, h, positions, mesh=mesh if sharded else None,
                              split=mesh if _split_cache(ctx, kw) else None, **kw)
    return tp_gqa_attention(ctx, p, h, positions, n_heads=cfg.n_heads,
                            n_kv_heads=cfg.n_kv_heads, rope_theta=cfg.rope_theta,
                            sliding_window=cfg.sliding_window or None, **kw)


def wgrad_split(mesh):
    """The products of a whole weight whose inputs every ``model`` rank
    holds alike: ``collectives.split_weight_grad_einsum`` on a mesh (each
    rank computes its block of the weight's gradient, as GSPMD splits it),
    else ``torch.einsum``."""
    if mesh is None or axis_size(mesh, "model") == 1:
        return torch.einsum
    return functools.partial(collectives.split_weight_grad_einsum, mesh=mesh, axis="model")


def _split_cache(ctx, kw) -> bool:
    """Decode against caches whose positions split over ``model``."""
    return kw.get("mode") == "decode" and ctx is not None and bool(ctx.cache_seq_axis) \
        and _tp(ctx) > 1


def tp_gqa_attention(ctx: Optional[ModelContext], p, h, positions, *, n_heads: int,
                     n_kv_heads: int, **kw):
    """``layers.gqa_attention_block`` (its keywords in ``kw``) on this rank's
    heads when they shard over ``model``: ``h`` enters through ``copy_to``,
    the output leaves through ``psum``; where the query heads stay whole,
    every rank runs every head and splits the weights' gradients
    (``wgrad_split``). When the KV heads stay whole (their
    count does not divide ``model``) each query head reads its own, and
    the KV weights' gradient is summed over ``model``: where no cache is
    written (train) a rank projects only the KV heads its query heads read,
    a slice of the whole ``wk``/``wv`` whose gradient lands in zeros of the
    whole leaf. So does the prefill where every rank reads as many KV heads
    (``own_kv_heads``): its caches then hold this rank's KV heads, and
    ``gather_kv_heads`` makes every head of them.

    Decode against a cache whose positions (a linear cache) or slots (a
    ring) split over ``model``, its KV heads whole, is flash-decode: the
    new token's K/V land on the rank holding its slot (``layers.write_kv``),
    every query head (gathered where they shard) attends to this rank's
    positions (``layers.gqa_decode`` with ``split``), and the output
    projection runs on this rank's heads, summed over ``model``."""
    mesh = _mesh(ctx)
    if _split_cache(ctx, kw):
        cache, position = kw["cache"], kw["cache_pos"]
        q, k, v = project_qkv(p, h, positions, rope_theta=kw.get("rope_theta", 10000.0),
                              use_rope=kw.get("use_rope", True))
        rank, n_local = axis_index(mesh, "model"), q.shape[2]
        kv_pos, window = write_kv(cache, k, v, position, kw.get("sliding_window"),
                                  first=rank * cache["k"].shape[1])
        heads_split = n_local < n_heads
        if heads_split:
            q = collectives.all_gather(q, mesh, "model", dim=2)
        out = gqa_decode(q, cache["k"], cache["v"], kv_pos, position, window=window, split=mesh)
        if heads_split:
            out = out[:, :, rank * n_local:][:, :, :n_local]
        y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
        return (collectives.psum(y, mesh, "model") if heads_split else y), cache
    if _tp(ctx) == 1:
        return gqa_attention_block(p, h, positions, **kw)
    if p["wq"].shape[1] == n_heads:  # every head on every rank
        return gqa_attention_block(p, h, positions, einsum=wgrad_split(mesh), **kw)
    kv_index = None
    if p["wk"].shape[1] == n_kv_heads and n_kv_heads < n_heads:
        n_local, group = p["wq"].shape[1], n_heads // n_kv_heads
        first = axis_index(mesh, "model") * n_local
        lo, n_kv = 0, n_kv_heads
        own = own_kv_heads(mesh, n_heads, n_kv_heads)
        if kw.get("mode", "train") == "train" or (kw.get("mode") == "prefill" and own):
            lo = first // group  # this rank's KV heads only
            n_kv = (first + n_local - 1) // group + 1 - lo
        kv_index = (first + torch.arange(n_local, device=h.device)) // group - lo
        p = _with(p, **{k: collectives.copy_to(p[k], mesh, "model").narrow(-2, lo, n_kv)
                        for k in ("wk", "wv", "bk", "bv") if k in p})  # [.., K, Dh]
    y, cache = gqa_attention_block(p, collectives.copy_to(h, mesh, "model"), positions,
                                   kv_index=kv_index, **kw)
    return collectives.psum(y, mesh, "model"), cache


def own_kv_heads(mesh, n_heads: int, n_kv_heads: int) -> Optional[int]:
    """How many KV heads each rank's query heads read, where the query heads
    split over ``model`` and the KV heads stay whole, if every rank reads
    as many (else None): a prefill then projects only those."""
    tp = axis_size(mesh, "model") if mesh is not None else 1
    if tp == 1 or n_heads % tp or n_kv_heads % tp == 0 or n_kv_heads >= n_heads:
        return None
    n_local, group = n_heads // tp, n_heads // n_kv_heads
    counts = {(r * n_local + n_local - 1) // group + 1 - r * n_local // group for r in range(tp)}
    return counts.pop() if len(counts) == 1 else None


def gather_kv_heads(t: torch.Tensor, mesh, n_heads: int, n_kv_heads: int,
                    dim: int) -> torch.Tensor:
    """Every KV head, along ``dim``, from each rank's own (a prefill cache
    of ``own_kv_heads``): gathered over ``model``, each head taken from the
    first rank that holds it."""
    tp, n = axis_size(mesh, "model"), t.shape[dim]
    n_local, group = n_heads // tp, n_heads // n_kv_heads
    lo = [r * n_local // group for r in range(tp)]
    pick = [next(r * n + k - lo[r] for r in range(tp) if lo[r] <= k < lo[r] + n)
            for k in range(n_kv_heads)]
    return collectives.all_gather(t, mesh, "model", dim).index_select(
        dim, torch.tensor(pick, device=t.device))


def _mlp(ctx, p, h, activation: str, d_ff: int):
    """A gated MLP; on a mesh over this rank's FFN columns, summed over
    ``model``."""
    if _tp(ctx) == 1 or p["w_gate"].shape[-1] == d_ff:
        return gated_mlp(p, h, activation)
    mesh = _mesh(ctx)
    y = gated_mlp(p, collectives.copy_to(h, mesh, "model"), activation)
    return collectives.psum(y, mesh, "model")


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
    ctx: Optional[ModelContext] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], torch.Tensor]:
    rules = _rules(ctx)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["norm1"])

    attn_cache = cache.get("attn") if cache else None
    attn_out, attn_cache_out = _attention(cfg, ctx, p["attn"], h, positions, mode=mode,
                                          cache=attn_cache, cache_pos=cache_pos,
                                          q_chunk=q_chunk)
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
        ssm_sharded = _tp(ctx) > 1 and p["ssm"]["conv"].shape[-1] < cfg.ssm_expand * cfg.d_model
        ssm_out, ssm_state_out = selective_ssm(p["ssm"], h, state=ssm_state,
                                               mesh=_mesh(ctx) if ssm_sharded else None)
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
    x = constrain(x, rules, "batch", None, None)

    h2 = rms_norm(x, p["norm2"])
    if moe:
        settings = model_settings(cfg)
        mlp_out, aux = moe_layer(
            p["moe"], h2, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, activation=cfg.activation,
            mesh=_mesh(ctx), dp_axes=("pod", "data"),
            norm_topk_prob=settings.norm_topk_prob, dropless=settings.dropless,
        )
        if "shared" in p["moe"]:
            mlp_out = mlp_out + _mlp(ctx, p["moe"]["shared"], h2, cfg.activation,
                                     cfg.n_shared_experts * cfg.d_ff_expert)
    else:
        mlp_out = _mlp(ctx, p["mlp"], h2, cfg.activation, cfg.d_ff)
    x = x + mlp_out
    x = constrain(x, rules, "batch", None, None)
    return x, (cache_out or None), aux


#: The products whose outputs ``dots`` keeps: the JAX package's
#: ``dots_with_no_batch_dims_saveable`` (``torch.einsum`` reaches one of
#: these for every contraction).
_DOTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default))
#: A layer's weights whose products carry a batch dim (the routed experts'
#: ``ecd,edf->ecf``): ``dots`` recomputes them, as the JAX policy does.
_BATCHED_WEIGHTS = frozenset(("moe.w_gate", "moe.w_up", "moe.w_down"))


def _remat(fn, policy: str, layer):
    """``fn`` (one layer) under ``torch.utils.checkpoint``, as
    ``repro.models.transformer._remat`` wraps the scan body:

      * ``none``: every activation kept;
      * ``full``: only the layer's input kept, the rest recomputed in the
        backward;
      * ``dots``: also the outputs of the products of an activation with a
        weight of ``layer`` (the projections, the MLP, the router; not the
        routed experts' batched products), so the backward recomputes the
        norms, RoPE, attention and the collectives;
      * ``dots_plus_collectives``: also the outputs of the MoE all-to-alls
        (``collectives.all_to_all``), so the backward does not send the
        expert dispatch and combine again; the JAX package keeps the
        routed-expert output to the same end.

    A product is recognised by its operand: a view of one of the layer's
    weights shares its storage, whatever reshape ``einsum`` made of it. The
    recompute runs the layer's code again, so every rank issues the same
    collectives in the same order."""
    if policy == "none":
        return fn
    from torch.utils.checkpoint import checkpoint

    if policy == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if policy not in ("dots", "dots_plus_collectives"):
        raise ValueError("unknown remat policy %r" % policy)
    from torch.multiprocessing.reductions import StorageWeakRef
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    weights = {StorageWeakRef(w.untyped_storage()) for name, w in layer.named_parameters()
               if name not in _BATCHED_WEIGHTS}
    saved = {torch.ops.repro_torch.all_to_all.default} \
        if policy == "dots_plus_collectives" else set()

    def save(ctx, op, *args, **kwargs):
        if op in saved or (op in _DOTS and any(
                isinstance(a, torch.Tensor) and StorageWeakRef(a.untyped_storage()) in weights
                for a in args)):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    contexts = functools.partial(create_selective_checkpoint_contexts, save)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, context_fn=contexts)


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
    ctx: Optional[ModelContext] = None,
):
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    per_layer = []
    policy = cfg.remat_policy if mode == "train" else "none"
    for i, p in enumerate(layers):
        block = functools.partial(_block, cfg, p, moe=moe, mode=mode,
                                  cache=_layer_cache(caches, i), cache_pos=cache_pos,
                                  q_chunk=q_chunk, ctx=ctx)
        x, cache_out, aux = _remat(block, policy, p)(x, positions)
        aux_total = aux_total + aux
        per_layer.append(cache_out)
    if mode == "prefill":
        return x, aux_total, _stack_caches(per_layer)
    return x, aux_total, caches


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor,
                 ctx: Optional[ModelContext] = None) -> torch.Tensor:
    x = sharded_embed_lookup(ctx, params["embed"], tokens, cfg.vocab_size)
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32).to(x.dtype)
    return x


def sharded_embed_lookup(ctx: Optional[ModelContext], table: torch.Tensor,
                         tokens: torch.Tensor, vocab: Optional[int] = None) -> torch.Tensor:
    """Vocab-sharded embedding lookup without gathering the table.

    Each rank looks its ids up in its block of vocabulary rows (ids outside
    it masked to zero) and the [B, S, D] partials are summed over
    ``model``: wire B*S*D instead of V*D, and the backward a local
    scatter-add. A plain lookup off a mesh, at ``model`` 1, or when the
    vocabulary (``vocab``, the table's global rows) does not divide.
    """
    tp = _tp(ctx)
    if tp <= 1 or (vocab or table.shape[0]) % tp != 0:
        return table[tokens]
    mesh = ctx.mesh

    def inner(tab_l, tok_l):
        v_l = tab_l.shape[0]
        rel = tok_l - axis_index(mesh, "model") * v_l
        ok = (rel >= 0) & (rel < v_l)
        x = tab_l[torch.clamp(rel, 0, v_l - 1)]
        x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
        return collectives.psum(x, mesh, "model")

    from ..distributed.sharding import P, shard_map_compat

    rows = ctx.batch_axes
    tok = P(rows if len(rows) > 1 else (rows[0] if rows else None), *[None] * (tokens.dim() - 1))
    return shard_map_compat(inner, mesh=mesh, in_specs=(P("model", None), tok),
                            out_specs=P(*tok, None), check_vma=False)(table, tokens)


def unembed(cfg: ModelConfig, params, x: torch.Tensor,
            ctx: Optional[ModelContext] = None) -> torch.Tensor:
    """Logits; on a mesh, this rank's vocabulary columns when the
    vocabulary shards over ``model``, else every column on every rank, the
    table's gradient split (``wgrad_split``)."""
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    v_local = table.shape[0] if cfg.tie_embeddings else table.shape[1]
    einsum = wgrad_split(_mesh(ctx))
    if _tp(ctx) > 1 and v_local < cfg.vocab_size:
        x, einsum = collectives.copy_to(x, ctx.mesh, "model"), torch.einsum
    if cfg.tie_embeddings:
        logits = einsum("bsd,vd->bsv", x, table)
    else:
        logits = einsum("bsd,dv->bsv", x, table)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return constrain(logits, _rules(ctx), "batch", None, "vocab")


def forward(
    cfg: ModelConfig,
    params,
    tokens: torch.Tensor,  # [B, S]
    *,
    mode: str = "train",
    prefix_embeds: Optional[torch.Tensor] = None,
    caches: Optional[Dict[str, Any]] = None,
    cache_pos: Optional[int] = None,
    ctx: Optional[ModelContext] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict[str, Any]]]:
    """Returns (logits, aux_loss, caches_out); decode writes ``caches`` in
    place at ``cache_pos`` and returns them. With ``ctx``, every tensor is
    this rank's block (the logits its vocabulary columns)."""
    x = embed_tokens(cfg, params, tokens, ctx)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    if mode == "decode":
        positions = torch.full((B, 1), cache_pos, dtype=torch.int32, device=x.device)
    else:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    x = constrain(x, _rules(ctx), "batch", None, None)
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
            cache_pos=cache_pos, q_chunk=q_chunk, ctx=ctx,
        )
        aux_total = aux_total + aux
        if nc is not None:
            caches_out[stack_name] = nc

    x = rms_norm(x, params["final_norm"])
    logits = unembed(cfg, params, x, ctx)
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
