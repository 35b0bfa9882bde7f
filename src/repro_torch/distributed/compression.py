"""Gradient compression: int8 quantization with error feedback.

The counterpart of ``repro.distributed.compression`` on one card:
``compress``/``decompress`` and the error-feedback state, wired into the
train step as quantize -> dequantize around the gradient, which keeps the
optimizer's semantics and models the volume an int8 all-reduce would move.
``compressed_psum``, the collective with the int8 wire format, needs a mesh
and waits for the distributed slice.

The scale is per leaf of the JAX package's tree: a stacked leaf, held here
as per-layer tensors (``models.layers.members``), shares one scale, the max
over all its layers, as the stacked array does in the JAX package.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..models.layers import map_members, members, tree_map_leaves


def compress(x) -> Tuple[Any, torch.Tensor]:
    """Symmetric int8 quantization of a tensor, or of the per-layer tensors
    of one stacked leaf with one scale. Returns (q, scale)."""
    parts = [t.float() for t in members(x)]
    amax = torch.stack([p.abs().max() for p in parts]).max()
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = map_members(lambda t: torch.clamp(torch.round(t.float() / scale), -127, 127)
                    .to(torch.int8), x)
    return q, scale


def decompress(q, scale: torch.Tensor, dtype=torch.float32):
    return map_members(lambda t: (t.float() * scale).to(dtype), q)


def quantize_with_feedback(grads: Any, error_state: Any) -> Tuple[Any, Any]:
    """Quantize a gradient tree, carrying the quantization error forward.

    error feedback: e_t = g_t + e_{t-1} - deq(q(g_t + e_{t-1})), which keeps
    the long-run update unbiased (1-bit Adam / EF-SGD literature).
    """

    def one(g, e):
        target = map_members(lambda gt, et: gt.float() + et, g, e)
        q, scale = compress(target)
        deq = decompress(q, scale)
        return (map_members(lambda d, gt: d.to(gt.dtype), deq, g),
                map_members(torch.sub, target, deq))

    pairs = tree_map_leaves(one, grads, error_state)
    return (tree_map_leaves(lambda p: p[0], pairs),
            tree_map_leaves(lambda p: p[1], pairs))


def init_error_state(params: Any) -> Any:
    return tree_map_leaves(
        lambda leaf: map_members(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                       device=p.device), leaf), params)
