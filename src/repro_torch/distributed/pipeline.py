"""GPipe-style pipeline parallelism over a mesh axis (default: "pod").

The counterpart of ``repro.distributed.pipeline``. ``pipeline_apply`` runs
S stages over M microbatches on the (M + S - 1)-tick schedule: stage ``s``
lives on rank ``s`` of the axis and holds only its own slice of the stage
parameters; at each tick stage 0 takes the next microbatch and every other
stage what its predecessor sent, and the boundary activations move one
rank ahead by point-to-point sends (the counterpart of ``ppermute``). So
per-rank parameter memory drops by S at the cost of a bubble fraction of
(S - 1) / (M + S - 1). Ticks where a rank has no live microbatch are
masked as the JAX package masks them, and the last stage's outputs are
masked and summed to every rank, as its ``psum`` does. The transfers carry
gradients (``collectives.shift``, ``collectives.psum``).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from . import collectives
from .sharding import axis_index, axis_size


def stage_slice(stage_params: Any, mesh, axis: str = "pod") -> Any:
    """This rank's stage of parameters whose leaves lead with the stage
    dim: the whole ``[n_stages, ...]``, or this rank's block ``[1, ...]``
    of it (``NamedSharding(mesh, P(axis)).shard``), nested dicts."""
    if isinstance(stage_params, dict):
        return {k: stage_slice(v, mesh, axis) for k, v in stage_params.items()}
    return stage_params[0 if stage_params.shape[0] == 1 else axis_index(mesh, axis)]


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,  # leaves with leading [n_stages, ...] or this rank's [1, ...]
    x: torch.Tensor,  # [n_micro, B_micro, ...] microbatched activations
    *,
    mesh,
    axis: str = "pod",
) -> torch.Tensor:
    """Run ``x`` through the pipeline stages; returns the transformed
    microbatches on every rank.

    ``stage_fn(params, x_micro) -> x_micro``. ``stage_params`` leads with
    the stage dim, as the JAX package's does; a rank may hold only its own
    block of it (``stage_slice``). ``x`` holds every microbatch on every
    rank, as the JAX package's replicated input does, and streams through
    the ranks here.
    """
    stage_params = stage_slice(stage_params, mesh, axis)
    n_stages = axis_size(mesh, axis)
    n_micro = x.shape[0]
    assert n_micro >= 1
    rank = axis_index(mesh, axis)
    ticks = n_micro + n_stages - 1
    buf = torch.zeros_like(x[0])
    outputs = []
    for t in range(ticks):
        # Stage 0 ingests microbatch t (if any); the others use the received buffer.
        x_in = x[min(max(t, 0), n_micro - 1)] if rank == 0 else buf
        y = stage_fn(stage_params, x_in)
        # Mask ticks where this rank has no live microbatch.
        live = 0 <= t - rank < n_micro
        if not live:
            y = torch.zeros_like(y)
        # The last stage finishes microbatch t - (S - 1).
        if rank == n_stages - 1 and live:
            outputs.append(y)
        buf = collectives.shift(y, mesh, axis)
    if rank != n_stages - 1:
        outputs = [torch.zeros_like(x[0])] * n_micro
    # Outputs are only valid on the last rank: mask + psum broadcasts.
    return collectives.psum(torch.stack(outputs), mesh, axis)
