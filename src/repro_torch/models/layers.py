"""Foundational layers for the decoder families, on PyTorch.

The counterpart of ``repro.models.layers``. Parameters are declared by
trees of ``ParamDef`` (nested dicts, the same shapes, logical axes and
initializers as the JAX package) and held by ``ParamTree`` modules, one
``nn.Parameter`` per declaration, read as ``params["attn"]["wq"]`` like the
JAX package's dicts. The layer functions are plain tensor arithmetic that
mirrors the JAX math: bf16 products, fp32 norm statistics, RoPE and
softmax, attention scores accumulated in fp32 (``preferred_element_type``)
and probabilities cast to the value dtype before P.V. Every attention of
the models ends in one core, ``attend`` (the mask, the softmax, the value
product), its mask from one position rule, ``visible``; decode against a
GQA cache of any layout is ``write_kv`` then ``gqa_decode``.

Decode updates caches in place (the counterpart of the JAX serve step's
donated caches): a cache passed in is the per-layer view of the stacked
cache, and the returned dict holds the same tensors.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import collectives

Params = Any  # a ParamTree, or a nested dict of tensors


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones
    scale: Optional[float] = None
    dtype: Any = torch.bfloat16

    def initialize(self, generator: torch.Generator, device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        scale = self.scale if self.scale is not None else 1.0 / math.sqrt(max(1, fan_in))
        draw = torch.randn(self.shape, generator=generator, dtype=torch.float32, device=device)
        return (draw * scale).to(self.dtype)

    def abstract(self) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of a nested dict (dict keys in sorted order,
    as ``jax.tree`` flattens them)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in leaf_paths(tree)]


def abstract_tree(defs) -> Params:
    return tree_map(lambda d: d.abstract(), defs)


def logical_tree(defs):
    return tree_map(lambda d: d.logical, defs)


def stack_defs(defs, n: int):
    """The declarations of ``n`` stacked layers: a leading ``[n]`` dim."""
    return tree_map(
        lambda d: ParamDef((n,) + d.shape, (None,) + d.logical, d.init, d.scale, d.dtype), defs
    )


def unstack_defs(defs, n: int):
    """The one-layer declarations of a stack declared ``[n, ...]``."""
    def one(d: ParamDef) -> ParamDef:
        assert d.shape[0] == n, (d.shape, n)
        return ParamDef(d.shape[1:], d.logical[1:], d.init, d.scale, d.dtype)

    return tree_map(one, defs)


def _stack_modules(defs, device, depth: int) -> nn.ModuleList:
    """``[n, ...]`` declarations as ``n`` one-layer trees; with ``depth`` 2
    (``[n, m, ...]``) each of them is a stack of ``m`` again."""
    n = tree_leaves(defs)[0].shape[0]
    one = unstack_defs(defs, n)
    if depth == 1:
        return nn.ModuleList(ParamTree(one, device) for _ in range(n))
    return nn.ModuleList(_stack_modules(one, device, depth - 1) for _ in range(n))


class ParamTree(nn.Module):
    """The parameters a tree of ``ParamDef`` declares, allocated (not yet
    initialized) on ``device``: a leaf becomes an ``nn.Parameter``, a nested
    dict a child ``ParamTree``, and each key in ``stacked`` (declared
    ``[L, ...]``, as the JAX package stacks its layers) an ``nn.ModuleList``
    of ``L`` one-layer trees. ``stacked`` maps a key to its number of
    stacked dims (a tuple of keys means one each): with 2, declared
    ``[G, L, ...]``, the key holds ``G`` lists of ``L`` trees (the xLSTM's
    groups of mLSTM blocks). ``tree[key]`` reads like the JAX dicts."""

    def __init__(self, defs: Dict[str, Any], device, stacked=()):
        super().__init__()
        depths = stacked if isinstance(stacked, dict) else dict.fromkeys(stacked, 1)
        self.defs = defs
        self._keys = sorted(defs)
        for k in self._keys:
            d = defs[k]
            if depths.get(k):
                self.add_module(k, _stack_modules(d, device, depths[k]))
            elif isinstance(d, dict):
                self.add_module(k, ParamTree(d, device))
            else:
                self.register_parameter(k, nn.Parameter(
                    torch.empty(d.shape, dtype=d.dtype, device=device), requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._keys

    def get(self, path: Tuple[str, ...]):
        node = self
        for k in path:
            node = node[k]
        return node

    @torch.no_grad()
    def assign(self, defs, value: Callable[[ParamDef, Tuple[str, ...]], torch.Tensor]) -> None:
        """Fill every parameter from ``value(def, path)``, one declaration of
        ``defs`` (those this tree was built from) at a time in sorted key
        order; a stack's value is ``[L, ...]`` and layer ``i`` takes slice
        ``i``."""
        for path, d in leaf_paths(defs):
            leaf = self.param_leaf(path)
            map_members(lambda p, v: p.copy_(v), leaf, stack_members(value(d, path), leaf))

    def param_leaf(self, path: Tuple[str, ...]):
        """The parameters of one declared leaf: a tensor, or for a stacked
        key the per-layer tensors as a list (of lists for two stacked dims)."""
        head = self[path[0]]
        if isinstance(head, nn.ModuleList):
            def layers(node):
                if isinstance(node, nn.ModuleList):
                    return [layers(sub) for sub in node]
                return node.get(path[1:])

            return layers(head)
        return self.get(path)

    def param_tree(self) -> Dict[str, Any]:
        """The parameters as the JAX package's tree: its keys, each leaf the
        ``param_leaf`` of its path (the module's own tensors, so an update
        in place updates the module)."""
        out: Dict[str, Any] = {}
        for path, _ in leaf_paths(self.defs):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = self.param_leaf(path)
        return out


def leaf_paths(tree, prefix: Tuple[str, ...] = ()):
    """(key path, leaf) pairs of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# stacked leaves held per layer
# ---------------------------------------------------------------------------
# A leaf of a port tree (``ParamTree.param_tree``, and the optimizer state
# built from it) is a tensor, or the per-layer tensors of one stacked leaf
# of the JAX package as a list (a list of lists for two stacked dims).

def stack_depth(leaf) -> int:
    """The stacked dims a leaf stands for (0 for a tensor)."""
    return 1 + stack_depth(leaf[0]) if isinstance(leaf, list) else 0


def members(leaf) -> list:
    """The tensors of a leaf, layer by layer."""
    if isinstance(leaf, list):
        return [t for sub in leaf for t in members(sub)]
    return [leaf]


def map_members(fn: Callable, leaf, *others):
    """``fn`` over the tensors of ``leaf`` and the same-placed tensors of
    ``others`` (leaves of the same layout), keeping the layout."""
    if isinstance(leaf, list):
        return [map_members(fn, *subs) for subs in zip(leaf, *others)]
    return fn(leaf, *others)


def tree_tensors(tree) -> list:
    """Every tensor of a port tree: leaves in sorted key order, a stacked
    leaf's layer by layer."""
    return [t for leaf in tree_leaves(tree) for t in members(leaf)]


def stacked(leaf) -> torch.Tensor:
    """A leaf as the one tensor the JAX package holds (a copy for a list)."""
    if isinstance(leaf, list):
        return torch.stack([stacked(sub) for sub in leaf])
    return leaf


def stack_members(t: torch.Tensor, like):
    """A stacked tensor cut into the layout of ``like`` (views)."""
    if isinstance(like, list):
        assert t.shape[0] == len(like), (tuple(t.shape), len(like))
        return [stack_members(t[i], sub) for i, sub in enumerate(like)]
    return t


def tree_map_leaves(fn: Callable, tree, *others):
    """``fn`` over the leaves of nested dicts of the same keys (a list is a
    leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map_leaves(fn, tree[k], *(o[k] for o in others)) for k in sorted(tree)}
    return fn(tree, *others)


# ---------------------------------------------------------------------------
# norms / embeddings / rope
# ---------------------------------------------------------------------------

def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the precision statistics and attention scores take: fp32,
    or fp64 for a model cast to fp64 (where decode and the forward must
    agree to fp64 rounding)."""
    return x if x.dtype == torch.float64 else x.float()


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = at_least_fp32(x)
    var = xf.square().mean(-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + at_least_fp32(weight))).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Mean and population variance in fp32 (fp64 for an fp64 model),
    weight and bias applied in that precision, cast back."""
    xf = at_least_fp32(x)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    normed = (xf - mu) * torch.rsqrt(var + eps)
    return (normed * at_least_fp32(weight) + at_least_fp32(bias)).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float = 10000.0) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(rope_frequencies(head_dim, theta), np.float32)).to(device)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature factor, ``0.1 * mscale * ln(factor) + 1``
    (1 at no scaling)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_frequencies(yarn, head_dim: int, theta: float = 10000.0) -> np.ndarray:
    """YaRN's inverse frequencies (``configs.base.YarnRope``): RoPE's
    ``theta^(-2i/dim)`` kept below the correction range, divided by the
    factor above it, and blended on a linear ramp between, the range's ends
    ``floor(corr(beta_fast))`` and ``ceil(corr(beta_slow))`` with
    ``corr(n) = dim ln(L0 / (2 pi n)) / (2 ln theta)`` (DeepSeek-V2's
    ``DeepseekV2YarnRotaryEmbedding``). Float64, rounded to float32."""
    def corr(n: float) -> float:
        return head_dim * math.log(yarn.original_max_position / (2 * math.pi * n)) / (
            2 * math.log(theta))

    low = max(math.floor(corr(yarn.beta_fast)), 0)
    high = min(math.ceil(corr(yarn.beta_slow)), head_dim - 1)
    i = np.arange(head_dim // 2, dtype=np.float64)
    ramp = np.clip((i - low) / ((high - low) or 0.001), 0.0, 1.0)
    base = theta ** (-2.0 * i / head_dim)
    return (base * (1.0 - ramp) + base / yarn.factor * ramp).astype(np.float32)


@functools.lru_cache(maxsize=None)
def yarn_rope(yarn, head_dim: int, theta: float, device: torch.device
              ) -> Tuple[torch.Tensor, float, float]:
    """(YaRN's inverse frequencies on ``device``, the factor on the rotated
    values, the factor on the softmax scale): the rotation's is
    ``m(s, mscale) / m(s, mscale_all_dim)``, the softmax's
    ``m(s, mscale_all_dim)^2`` (``yarn_mscale``; DeepSeek-V2 applies the
    latter only where ``mscale_all_dim`` is set)."""
    freqs = torch.from_numpy(yarn_frequencies(yarn, head_dim, theta)).to(device)
    rotated = yarn_mscale(yarn.factor, yarn.mscale) / yarn_mscale(yarn.factor, yarn.mscale_all_dim)
    softmax = yarn_mscale(yarn.factor, yarn.mscale_all_dim) ** 2 if yarn.mscale_all_dim else 1.0
    return freqs, rotated, softmax


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
               freqs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Half-rotation RoPE in fp32 (fp64 for an fp64 model). x: [..., S, H,
    Dh]; positions: [..., S]; ``freqs`` ([Dh/2]) in place of ``theta``'s
    (YaRN's, ``yarn_rope``)."""
    xf = at_least_fp32(x)
    if freqs is None:
        freqs = _rope_freqs(x.shape[-1], float(theta), x.device)
    freqs = freqs.to(xf.dtype)
    angles = positions[..., :, None].to(xf.dtype) * freqs  # [..., S, Dh/2]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = xf.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations / MLP
# ---------------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x), sigmoid as 1 / (1 + exp(-x)), each
    operation rounded to x's dtype as the JAX package computes it."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` in x's dtype, operation by
    operation, its constants rounded to that dtype first."""
    c = torch.tensor(0.044715, dtype=x.dtype)
    k = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
    cdf = 0.5 * (1 + torch.tanh(k * (x + c * (x * x * x))))
    return x * cdf


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return silu
    if name == "gelu":
        return gelu_tanh
    if name == "relu":
        return F.relu
    raise ValueError(name)


def gated_mlp_defs(d_model: int, d_ff: int) -> Dict[str, ParamDef]:
    return {
        "w_gate": ParamDef((d_model, d_ff), ("embed", "ffn")),
        "w_up": ParamDef((d_model, d_ff), ("embed", "ffn")),
        "w_down": ParamDef((d_ff, d_model), ("ffn", "embed")),
    }


def gated_mlp(params: Params, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    a = act_fn(activation)
    gate = torch.einsum("...sd,df->...sf", x, params["w_gate"])
    up = torch.einsum("...sd,df->...sf", x, params["w_up"])
    return torch.einsum("...sf,fd->...sd", a(gate) * up, params["w_down"])


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def gqa_defs(
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    *,
    qkv_bias: bool = False,
) -> Dict[str, ParamDef]:
    defs: Dict[str, ParamDef] = {
        "wq": ParamDef((d_model, n_heads, head_dim), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d_model, n_kv_heads, head_dim), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d_model, n_kv_heads, head_dim), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((n_heads, head_dim, d_model), ("heads", "head_dim", "embed")),
    }
    if qkv_bias:
        defs["bq"] = ParamDef((n_heads, head_dim), ("heads", "head_dim"), init="zeros")
        defs["bk"] = ParamDef((n_kv_heads, head_dim), ("kv_heads", "head_dim"), init="zeros")
        defs["bv"] = ParamDef((n_kv_heads, head_dim), ("kv_heads", "head_dim"), init="zeros")
    return defs


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [B,Sq,K,G,Dh], k: [B,Skv,K,Dh] -> [B,K,G,Sq,Skv], bf16 products
    accumulated in fp32."""
    return torch.einsum("bqkgd,bskd->bkgqs", at_least_fp32(q), at_least_fp32(k))


def _grouped_values(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: [B,K,G,Sq,Skv], v: [B,Skv,K,Dh] -> [B,Sq,K,G,Dh]."""
    return torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)


#: The score a masked key takes before the softmax.
MASKED = -1e30


def visible(kv_pos: torch.Tensor, q_pos, window: Optional[int] = None) -> torch.Tensor:
    """The position rule: the keys a query at ``q_pos`` (an int, or [Sq, 1])
    sees among keys at ``kv_pos`` ([Skv]: a linear cache's ``arange``, a
    ring's ``pos``, or this rank's slice of either) -- those at or before
    it, and with ``window`` those fewer than ``window`` positions before
    it, an empty ring slot (position -1) never. Only a ring has empty
    slots and every ring has a window, so the slot test goes with the
    window's."""
    valid = kv_pos <= q_pos
    if window is not None:
        valid = valid & (kv_pos > q_pos - window) & (kv_pos >= 0)
    return valid


def attend(scores: torch.Tensor, valid: Optional[torch.Tensor], v: torch.Tensor,
           values: Callable = _grouped_values, split=None) -> torch.Tensor:
    """The attention core, which every attention of the models ends in:
    ``scores`` (in ``at_least_fp32``'s precision, scaled, the keys on the
    last dim) set to ``MASKED`` where ``valid`` (``visible``'s mask,
    broadcasting over them; None masks nothing) is false, the softmax over
    the keys, and ``values(probs, v)``, which casts the probabilities to
    ``v``'s dtype (``_grouped_values``, or MLA's latent product). With
    ``split`` (a mesh), the keys are this rank's block of those split over
    ``model`` and the softmax is flash-decode's: the max and the sum of the
    exponentials over every rank's keys, the partial products with this
    rank's values summed over ``model``. Callers pass ``scores`` as a
    temporary, so that the unmasked scores are freed once masked: one
    score tensor at the peak, not two."""
    if valid is not None:
        scores = torch.where(valid, scores, MASKED)
    if split is None:
        return values(torch.softmax(scores, dim=-1), v)
    from torch.distributed import ReduceOp

    m = collectives.all_reduce_(scores.amax(-1, keepdim=True), split, "model", op=ReduceOp.MAX)
    e = torch.exp(scores - m)
    total = collectives.all_reduce_(e.sum(-1, keepdim=True), split, "model")
    return collectives.all_reduce_(values(e / total, v), split, "model")


def causal_attention(
    q: torch.Tensor,  # [B, Sq, H, Dh]
    k: torch.Tensor,  # [B, Skv, Kv, Dh]
    v: torch.Tensor,  # [B, Skv, Kv, Dv]
    *,
    q_offset: int = 0,
    kv_len: Optional[torch.Tensor] = None,  # valid cache length per batch [B]
    sliding_window: Optional[int] = None,
    q_chunk: Optional[int] = None,
    softmax_scale: Optional[float] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Grouped-query attention with optional q-chunking: each q-block
    attends only to the kv prefix it can see (``kv_hi``), so no work is
    spent on fully masked blocks. ``causal=False`` (the encoder, cross
    attention) masks nothing: no window, no ``kv_len``."""
    b, sq, h, dh = q.shape
    kv_heads = k.shape[2]
    dv = v.shape[-1]  # may differ from dh (MLA: qk_dim != v_head_dim)
    assert h % kv_heads == 0, (h, kv_heads)
    assert causal or (kv_len is None and sliding_window is None)
    g = h // kv_heads
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(b, sq, kv_heads, g, dh)
    dev = q.device

    def block(q_blk, blk_offset, kv_hi):
        """q_blk: [B, C, K, G, Dh] attending to k[:, :kv_hi]."""
        valid = None
        if causal:
            first = q_offset + blk_offset
            kv_pos = torch.arange(kv_hi, device=dev)
            valid = visible(kv_pos, torch.arange(first, first + q_blk.shape[1], device=dev)[:, None],
                            sliding_window)
            if kv_len is not None:  # per batch row: [B, 1, 1, C, kv_hi]
                valid = (valid & (kv_pos < kv_len[:, None, None]))[:, None, None]
        return attend(_grouped_scores(q_blk, k[:, :kv_hi]) * scale, valid, v[:, :kv_hi])

    if q_chunk is None or q_chunk >= sq or not causal:
        out = block(qg, 0, k.shape[1])
        return out.reshape(b, sq, h, dv)

    n_blocks = -(-sq // q_chunk)
    outs = []
    for i in range(n_blocks):
        lo = i * q_chunk
        hi = min(sq, lo + q_chunk)
        kv_hi = min(k.shape[1], q_offset + hi)
        outs.append(block(qg[:, lo:hi], lo, kv_hi))
    return torch.cat(outs, dim=1).reshape(b, sq, h, dv)


def write_kv(
    cache: Dict[str, torch.Tensor],
    k_new: torch.Tensor,  # [B, 1, Kv, Dh]
    v_new: torch.Tensor,
    position: int,
    window: Optional[int] = None,
    first: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[int]]:
    """Write one token's K/V into its slot of ``cache``, in place: slot
    ``position`` of a linear cache, ``position % W`` of a ring of W slots,
    whose ``pos`` [W] records the position. A cache whose slots split over
    ``model`` holds the whole cache's from ``first`` on: only the rank
    holding the slot writes K/V, and every rank writes the ring's whole
    ``pos``. Returns ``gqa_decode``'s ``kv_pos`` and ``window``: the
    positions this cache's slots hold (-1 an empty ring slot), and the
    model's ``window`` (a ring's size where it has none); over a linear
    cache none until ``position`` reaches it, as it masks nothing before."""
    k_cache, v_cache = cache["k"], cache["v"]
    n, lo = k_cache.shape[1], first or 0
    ring = "pos" in cache
    slot = position % cache["pos"].shape[0] if ring else position
    if first is None or lo <= slot < lo + n:  # a whole cache holds every slot
        k_cache[:, slot - lo] = k_new[:, 0]
        v_cache[:, slot - lo] = v_new[:, 0]
    if not ring:
        kv_pos = torch.arange(lo, lo + n, device=k_cache.device)
        return kv_pos, window if window is not None and position >= window else None
    pos = cache["pos"]
    pos[slot] = position
    return (pos if first is None else pos[lo:lo + n]), window or pos.shape[0]


def gqa_decode(
    q: torch.Tensor,  # [B, 1, H, Dh]
    k_cache: torch.Tensor,  # [B, n, Kv, Dh]
    v_cache: torch.Tensor,
    kv_pos: torch.Tensor,  # [n]
    position: int,
    *,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
    kv_index: Optional[torch.Tensor] = None,
    split=None,
) -> torch.Tensor:
    """One token's grouped-query attention against a cache written by
    ``write_kv`` (its ``kv_pos`` and ``window``): a linear cache, a ring,
    or this rank's block of either split over ``model`` (``split``, as
    ``attend`` takes it). ``kv_index`` names the KV head each query head
    reads. [B, 1, H, Dv]."""
    if kv_index is not None:
        k_cache, v_cache = k_cache[:, :, kv_index], v_cache[:, :, kv_index]
    b, _, h, dh = q.shape
    kv_heads = k_cache.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(dh)
    out = attend(_grouped_scores(q.reshape(b, 1, kv_heads, h // kv_heads, dh), k_cache) * scale,
                 visible(kv_pos, position, window), v_cache, split=split)
    return out.reshape(b, 1, h, v_cache.shape[-1])


def ring_attention_decode(
    q: torch.Tensor,  # [B, 1, H, Dh]
    cache: Dict[str, torch.Tensor],  # k/v [B, W, Kv, Dh] + pos [W] int32 (-1 empty)
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    position: int,  # absolute position of the new token
    *,
    sliding_window: int,
    softmax_scale: Optional[float] = None,
    kv_index: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sliding-window decode against a ring buffer of size W, updated in
    place: slot ``p % W`` holds position ``p``, and the per-slot position
    array masks empty and out-of-window entries (keys were rotated before
    insertion, so absolute RoPE stays right): ``write_kv``, then
    ``gqa_decode``."""
    kv_pos, window = write_kv(cache, k_new, v_new, position, sliding_window)
    out = gqa_decode(q, cache["k"], cache["v"], kv_pos, position, window=window,
                     softmax_scale=softmax_scale, kv_index=kv_index)
    return out, cache


def project_qkv(params: Params, x: torch.Tensor, positions: torch.Tensor, *,
                rope_theta: float = 10000.0, use_rope: bool = True,
                einsum: Callable = torch.einsum
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The query, key and value heads of ``x`` ([B, S, H or Kv, Dh]): the
    projections, their biases where declared, RoPE where used."""
    q = einsum("bsd,dhk->bshk", x, params["wq"])
    k = einsum("bsd,dhk->bshk", x, params["wk"])
    v = einsum("bsd,dhk->bshk", x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def gqa_attention_block(
    params: Params,
    x: torch.Tensor,  # [B, S, D]
    positions: torch.Tensor,  # [B, S]
    *,
    rope_theta: float = 10000.0,
    mode: str = "train",  # train | prefill | decode
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos: Optional[int] = None,
    sliding_window: Optional[int] = None,
    q_chunk: Optional[int] = None,
    softmax_scale: Optional[float] = None,
    causal: bool = True,
    use_rope: bool = True,
    kv_index: Optional[torch.Tensor] = None,
    einsum: Callable = torch.einsum,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """GQA attention with rope; returns (y, cache_out).

    ``kv_index`` (a rank's block of query heads under tensor parallelism,
    its KV heads whole) names the KV head each query head reads; the
    caches keep every KV head. ``einsum`` computes the four projections
    (``collectives.split_weight_grad_einsum`` where every rank holds every
    head).

    * train:   cache_out is None.
    * prefill: cache_out = {"k","v"} post-rope full-sequence tensors.
    * decode:  cache is required and S must be 1; the cache is written in
               place (linear caches at ``cache_pos``, sliding-window ring
               buffers at ``cache_pos % W``) and returned.
    """
    q, k, v = project_qkv(params, x, positions, rope_theta=rope_theta, use_rope=use_rope,
                          einsum=einsum)
    if mode == "decode":
        assert cache is not None and cache_pos is not None and x.shape[1] == 1
        kv_pos, window = write_kv(cache, k, v, cache_pos, sliding_window)
        out = gqa_decode(q, cache["k"], cache["v"], kv_pos, cache_pos, window=window,
                         softmax_scale=softmax_scale, kv_index=kv_index)
        new_cache = cache
    else:
        k_att, v_att = (k, v) if kv_index is None else (k[:, :, kv_index], v[:, :, kv_index])
        out = causal_attention(
            q, k_att, v_att,
            sliding_window=sliding_window, q_chunk=q_chunk,
            softmax_scale=softmax_scale, causal=causal,
        )
        new_cache = {"k": k, "v": v} if mode == "prefill" else None

    y = einsum("bshk,hkd->bsd", out, params["wo"])
    return y, new_cache


def init_kv_cache(
    batch: int,
    max_len: int,
    n_kv_heads: int,
    head_dim: int,
    dtype=torch.bfloat16,
    *,
    ring: bool = False,
    device="cpu",
):
    cache = {
        "k": torch.zeros((batch, max_len, n_kv_heads, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, n_kv_heads, head_dim), dtype=dtype, device=device),
    }
    if ring:
        cache["pos"] = torch.full((max_len,), -1, dtype=torch.int32, device=device)
    return cache


# ---------------------------------------------------------------------------
# cross attention (enc-dec)
# ---------------------------------------------------------------------------

def cross_attention_block(
    params: Params,
    x: torch.Tensor,  # decoder states [B, S, D]
    enc: torch.Tensor,  # encoder states [B, T, D]
) -> torch.Tensor:
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("btd,dhk->bthk", enc, params["wk"])
    v = torch.einsum("btd,dhk->bthk", enc, params["wv"])
    out = causal_attention(q, k, v, causal=False)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])
