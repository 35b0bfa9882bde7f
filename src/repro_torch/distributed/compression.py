"""Gradient compression: int8 quantization with error feedback.

The counterpart of ``repro.distributed.compression``:
``compress``/``decompress`` and the error-feedback state, wired into the
train step as quantize -> dequantize around the reduced gradient, which
keeps the optimizer's semantics and models the volume an int8 all-reduce
would move; and ``compressed_psum``, the collective whose int8 wire format
is real, over one axis of a mesh (the manual-DP paths: pipeline stages).

The scale is per leaf of the JAX package's tree: a stacked leaf, held here
as per-layer tensors (``models.layers.members``), shares one scale, the max
over all its layers, as the stacked array does in the JAX package.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..models.layers import map_members, members, tree_map_leaves


def compress(x, reduce_amax=None) -> Tuple[Any, torch.Tensor]:
    """Symmetric int8 quantization of a tensor, or of the per-layer tensors
    of one stacked leaf with one scale. Returns (q, scale). For a block of
    a sharded leaf, ``reduce_amax`` takes the block's max to the leaf's
    (a max over the ranks holding its blocks)."""
    parts = [t.float() for t in members(x)]
    amax = torch.stack([p.abs().max() for p in parts]).max()
    if reduce_amax is not None:
        amax = reduce_amax(amax)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = map_members(lambda t: torch.clamp(torch.round(t.float() / scale), -127, 127)
                    .to(torch.int8), x)
    return q, scale


def decompress(q, scale: torch.Tensor, dtype=torch.float32):
    return map_members(lambda t: (t.float() * scale).to(dtype), q)


def quantize_with_feedback(grads: Any, error_state: Any, reduce_amax=None) -> Tuple[Any, Any]:
    """Quantize a gradient tree, carrying the quantization error forward.

    error feedback: e_t = g_t + e_{t-1} - deq(q(g_t + e_{t-1})), which keeps
    the long-run update unbiased (1-bit Adam / EF-SGD literature).
    ``reduce_amax`` as for ``compress``.
    """

    def one(g, e):
        target = map_members(lambda gt, et: gt.float() + et, g, e)
        q, scale = compress(target, reduce_amax)
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


def compressed_psum(x: torch.Tensor, axis_name: str, *, mesh) -> torch.Tensor:
    """int8 all-reduce over ``axis_name`` of ``mesh``: quantize, sum the
    integers, dequantize to ``x.dtype``.

    Scales are made uniform with a max-reduce first, so the sum stays exact
    in the quantized domain (each rank contributes at most 127 * scale);
    the integers travel as int32, as the JAX package sums them.
    """
    from torch.distributed import ReduceOp

    from .collectives import all_reduce_

    xf = x.float()
    amax = all_reduce_(xf.abs().max().reshape(1), mesh, axis_name, op=ReduceOp.MAX)[0]
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int32)
    total = all_reduce_(q, mesh, axis_name)
    return (total.float() * scale).to(x.dtype)
