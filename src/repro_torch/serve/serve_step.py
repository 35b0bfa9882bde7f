"""Serving steps: prefill + single-token decode against stacked caches.

The counterpart of ``repro.serve.serve_step`` on one card. The JAX steps
are jitted with sharded caches donated to the decode step; here the model
holds its parameters on its device, the steps run eagerly under
``torch.inference_mode``, and the decode step writes the caches in place
(the counterpart of ``donate_argnums``). Cache shardings need a mesh and
wait for the distributed slice.
"""

from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ModelConfig


def make_serve_steps(model, *, batch: int, max_len: int):
    """Returns (prefill_fn, decode_fn, caches_abstract).

    ``prefill_fn(batch_inputs)`` -> (last-position logits, prefill caches);
    ``decode_fn(tokens, caches, cache_pos)`` -> (next_token [B, 1] int32,
    logits, caches), the greedy argmax; ``caches`` are written in place.
    ``caches_abstract``: the decode caches as meta-device tensors.
    """
    caches_abstract = model.init_decode_caches(batch, max_len, device="meta")

    @torch.inference_mode()
    def prefill_fn(batch_inputs):
        return model.prefill(batch_inputs)

    @torch.inference_mode()
    def decode_fn(tokens, caches, cache_pos: int):
        logits, new_caches = model.decode_step(tokens, caches, cache_pos)
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_token[:, None], logits, new_caches

    return prefill_fn, decode_fn, caches_abstract


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
