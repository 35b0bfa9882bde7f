"""Serving steps: prefill + single-token decode against stacked caches.

The counterpart of ``repro.serve.serve_step``. The JAX steps are jitted
with sharded caches donated to the decode step; here the model holds its
parameters, the steps run eagerly under ``torch.inference_mode``, and the
decode step writes the caches in place (the counterpart of
``donate_argnums``).

``make_serve_steps(model, batch=, max_len=)`` serves on one device;
``make_serve_steps(model, mesh, rules, batch=, max_len=)`` on a mesh, with
the parameters placed by ``param_shardings`` and the caches by
``cache_shardings`` (KV heads over ``model`` when their count divides it;
batch rows over the DP axes). Each rank runs its rows and heads; the
logits and next tokens are gathered to the global batch on every rank.
Where the KV heads cannot shard over ``model`` (MQA, GQA with fewer heads
than ``model``) and for MLA's compressed cache, the cache splits its
sequence (a sliding-window ring its slots, ``pos`` whole) over ``model``
instead and decode is flash-decode: each rank attends to its positions,
and the softmax's max and sum and the weighted values are combined over
``model`` (``models.layers.attend``'s ``split``), so the cache never
moves. The xLSTM's matrix memories split their ``Dk`` rows over
``model``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from ..configs.base import ModelConfig
from ..distributed import collectives
from ..distributed.sharding import NamedSharding, P, axis_size, batch_partition, fit_spec, mesh_shape
from ..models.transformer import ModelContext, gather_kv_heads, own_kv_heads
from ..obs import trace as _obs_trace


def _dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))


def _map_tree(fn, tree, *others):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map_tree(fn, v, *(o[i] for o in others)) for i, v in enumerate(tree))
    return fn(tree, *others)


def cache_spec(name: str, shape: Tuple[int, ...], mesh) -> P:
    """The spec of one decode-cache leaf, by its name and stacked shape."""
    dp = _dp_axes(mesh)
    dp_part = dp if len(dp) > 1 else (dp[0] if dp else None)
    model_size = mesh_shape(mesh).get("model", 1)
    rank = len(shape)
    parts = [None] * rank
    if name in ("k", "v"):  # [L, B, S, K, Dh]
        parts = [None, dp_part, None, None, None]
        if shape[3] % model_size == 0:
            parts[3] = "model"
        elif shape[2] % model_size == 0:
            # kv heads can't shard (MQA/GQA < tp): shard the *sequence* dim
            # over the otherwise-idle model axis (flash-decode).
            parts[2] = "model"
    elif name in ("c_kv", "k_rope"):  # [L, B, S, R]: MLA compressed cache
        parts = [None, dp_part, None, None]
        if shape[2] % model_size == 0:
            parts[2] = "model"
    elif name == "pos":  # [L, W]
        parts = [None, None]
    elif name == "h":  # ssm [L, B, D_in, N]
        parts = [None, dp_part, "model" if shape[2] % model_size == 0 else None, None]
    elif name == "conv":  # [L, B, K-1, D_in]
        parts = [None, dp_part, None, None]
    elif name in ("cross_k", "cross_v"):  # [L, B, T, K, Dh]
        parts = [None, dp_part, None, None, None]
    elif name == "c":  # xlstm matrix memory [G(, n_m), B, H, Dk, Dv]
        parts = [None] * (rank - 4) + [dp_part, None,
                                       "model" if shape[-2] % model_size == 0 else None, None]
    elif name == "n":
        parts = [None] * (rank - 3) + [dp_part, None,
                                       "model" if shape[-1] % model_size == 0 else None]
    elif name == "m":
        parts = [None] * (rank - 2) + [dp_part, None]
    elif rank >= 2:  # xlstm slstm tuple leaves etc: [G, B, H, Dh]
        parts[1] = dp_part
    return fit_spec(P(*parts), shape, mesh)


def cache_shardings(cfg: ModelConfig, mesh, caches_abstract) -> Any:
    """NamedShardings of the decode caches, by leaf name (the tree of
    ``caches_abstract``)."""
    del cfg

    def walk(tree, name: str):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(walk(v, "") for v in tree)
        return NamedSharding(mesh, cache_spec(name, tuple(tree.shape), mesh))

    return walk(caches_abstract, "")


def make_serve_steps(model, *args, batch: int, max_len: int, mesh=None, rules=None):
    """Returns (prefill_fn, decode_fn, caches_abstract) on one device, and
    (prefill_fn, decode_fn, caches_abstract, shardings) on a mesh
    (``make_serve_steps(model, mesh, rules, ...)`` or ``mesh=``).

    ``prefill_fn(batch_inputs)`` -> (last-position logits, prefill caches);
    ``decode_fn(tokens, caches, cache_pos)`` -> (next_token [B, 1] int32,
    logits, caches), the greedy argmax; ``caches`` are written in place.
    ``caches_abstract``: the decode caches as meta-device tensors.

    On a mesh both functions take the parameters first, as the JAX
    package's do (``model.param_tree()``, the blocks the model holds), and
    the global batch (every rank passes the same): ``prefill_fn(params,
    batch_inputs)`` returns the global last-position logits and the global
    prefill caches; ``decode_fn(params, tokens, caches, cache_pos)`` takes
    the global decode caches the first time (``prefill_to_decode_caches``)
    and places them by ``shardings["caches"]``, and returns the global
    next tokens and logits and this rank's cache blocks, written in place,
    to pass to the next call.
    """
    if len(args) == 2:
        mesh, rules = args
    if mesh is not None:
        return _mesh_serve_steps(model, mesh, rules, batch=batch, max_len=max_len)
    caches_abstract = model.init_decode_caches(batch, max_len, device="meta")

    @torch.inference_mode()
    def prefill_fn(batch_inputs):
        return model.prefill(batch_inputs)

    @torch.inference_mode()
    def decode_fn(tokens, caches, cache_pos: int):
        with _obs_trace.span("serve.decode_step"):
            logits, new_caches = model.decode_step(tokens, caches, cache_pos)
            next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_token[:, None], logits, new_caches

    return prefill_fn, decode_fn, caches_abstract


def _mesh_serve_steps(model, mesh, rules, *, batch: int, max_len: int):
    from ..distributed.sharding import default_rules
    from ..train.train_step import local_rows, param_shardings, place_model

    rules = rules or default_rules(mesh)
    ctx = ModelContext(mesh, rules)
    cfg = model.cfg
    caches_abstract = model.init_decode_caches(batch, max_len, device="meta")
    c_shard = cache_shardings(cfg, mesh, caches_abstract)
    # The prefill caches never split the sequence: each model rank computes
    # every position.
    p_cache = _map_tree(lambda sh, a: NamedSharding(mesh, P(*(
        None if d == 2 and e == "model" and _is_kv(a) else e for d, e in enumerate(sh.spec)))),
        c_shard, _names(caches_abstract))
    if axis_size(mesh, "model") > 1 and p_cache != c_shard:
        ctx = dataclasses.replace(ctx, cache_seq_axis="model")
    p_shard = param_shardings(model, mesh, rules)
    tok_spec = batch_partition(mesh, batch)
    tok_shard = NamedSharding(mesh, P(*(list(tok_spec) + [None])))
    rows = tuple(a for e in tok_spec for a in (e if isinstance(e, tuple) else (e,)))
    place_model(model, p_shard)

    def gathered_logits(logits):
        """This rank's rows and vocabulary columns as the global logits."""
        if logits.shape[-1] < cfg.vocab_size:
            logits = collectives.all_gather(logits, mesh, "model", dim=-1)
        for a in reversed(rows):  # minor axis first
            logits = collectives.all_gather(logits, mesh, a, dim=0)
        return logits

    own = own_kv_heads(mesh, cfg.n_heads, cfg.n_kv_heads)

    def gather_cache(t, sh, name):
        """A prefill cache leaf whole: every KV head where the leaf holds
        this rank's own (``transformer.own_kv_heads``), every block."""
        if own and name in ("k", "v"):
            t = gather_kv_heads(t, mesh, cfg.n_heads, cfg.n_kv_heads, dim=3)
        return sh.gather(t)

    @torch.inference_mode()
    def prefill_fn(params, batch_inputs):
        del params  # the model holds its blocks
        logits, caches = model.prefill(local_rows(mesh, rows, batch_inputs), ctx)
        caches = _map_tree(gather_cache, caches, _prefix_tree(p_cache, caches),
                           _prefix_tree(_names(caches_abstract), caches))
        return gathered_logits(logits), caches

    @torch.inference_mode()
    def decode_fn(params, tokens, caches, cache_pos: int):
        del params
        with _obs_trace.span("serve.decode_step"):
            caches = _map_tree(
                lambda t, sh, a: sh.shard(t).clone() if tuple(t.shape) == tuple(a.shape) and
                sh.local_shape(a.shape) != tuple(a.shape) else t, caches, c_shard,
                caches_abstract)
            logits, caches = model.decode_step(local_rows(mesh, rows, {"t": tokens})["t"],
                                               caches, cache_pos, ctx)
            logits = gathered_logits(logits)
            next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_token[:, None], logits, caches

    return prefill_fn, decode_fn, caches_abstract, {"params": p_shard, "caches": c_shard,
                                                    "tokens": tok_shard}


def _names(tree, name: str = ""):
    """Each leaf of a cache tree replaced by its name."""
    if isinstance(tree, dict):
        return {k: _names(v, k) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_names(v, "") for v in tree)
    return name


def _is_kv(name: str) -> bool:
    return name in ("k", "v", "c_kv", "k_rope")


def _prefix_tree(tree, like):
    """``tree`` cut to the keys of ``like`` (the prefill caches lack the
    ring buffers' ``pos``)."""
    if isinstance(like, dict):
        return {k: _prefix_tree(tree[k], v) for k, v in like.items()}
    return tree


def prefill_to_decode_caches(
    cfg: ModelConfig, model, prefill_caches: Any, batch: int, max_len: int, prefill_len: int
) -> Any:
    """Lay prefill cache tensors ([L,B,S,...]) into decode cache buffers."""
    decode_caches = model.init_decode_caches(batch, max_len)
    out = {}
    for k in decode_caches:
        if prefill_caches is not None and k in prefill_caches:
            # attn prefill caches lack the ring "pos" etc.; merge per sub-key.
            out[k] = _merge_cache_group(decode_caches[k], prefill_caches[k], prefill_len)
        else:
            out[k] = decode_caches[k]
    return out


def _merge_cache_group(dst, src, prefill_len: int):
    def merge(d, s):
        """``s`` written into the fresh decode buffer ``d`` (never aliased:
        decode writes ``d`` in place)."""
        if d.shape == s.shape:
            return d.copy_(s)
        # sequence axis is 2 for [L, B, S, ...] cache layouts
        s_src, s_dst = s.shape[2], d.shape[2]
        if s_dst >= s_src:
            d[:, :, :s_src] = s
            return d
        # ring buffer: keep the last W tokens, slot p % W holds position p
        tail = s[:, :, s_src - s_dst:]
        return d.copy_(torch.roll(tail, s_src % s_dst, dims=2))

    def walk(d, s):
        """Dicts by key, tuples (the sLSTM state) by position, tensors merged."""
        if s is None:
            return d
        if isinstance(d, tuple):
            return tuple(walk(dv, sv) for dv, sv in zip(d, s))
        if not isinstance(d, dict):
            return merge(d, s)
        out = {}
        for k, dv in d.items():
            if k == "pos":
                # ring positions for the prefix: slot p % W holds position p
                W = dv.shape[-1]
                pos = torch.arange(W, device=dv.device)
                base = (prefill_len - 1) // W * W if prefill_len else 0
                cand = torch.where(base + pos < prefill_len, base + pos, base + pos - W)
                out[k] = torch.where(cand >= 0, cand, -1).to(torch.int32).expand(dv.shape).clone()
            else:
                out[k] = walk(dv, s.get(k) if isinstance(s, dict) else None)
        return out

    return walk(dst, src)
