"""AdamW with fp32 moments, global-norm clipping, and LR schedules.

The counterpart of ``repro.train.optimizer`` on one card, written as the
JAX package's arithmetic (not ``torch.optim.AdamW``, whose clipping,
schedule and decay rule differ): fp32 moments, an int32 step, the schedule
and bias corrections in fp32, each update in fp32 cast to the parameter's
dtype. ``adamw_update`` writes parameters and moments in place (the
counterpart of the JAX step's donated buffers).

Trees are the port's (``Model.param_tree``): a leaf is a tensor, or the
per-layer tensors of a stacked leaf of the JAX package as a list. Weight
decay follows the declared, stacked shape: a leaf decays when its stacked
ndim is at least 2, so a per-layer norm ``[D]`` of a stack ``[L, D]``
decays, as the JAX package's does, and the top-level ``final_norm`` does
not. On a mesh (``train_step.ShardedTrainStep``) the same update runs on
each rank's ZeRO-1 blocks, with the global norm of the whole gradient
passed in (``grad_norm``, from ``sharded_global_norm``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from ..models.layers import (map_members, members, stack_depth, tree_leaves, tree_map_leaves,
                             tree_tensors)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    end_lr_fraction: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to end_lr_fraction * peak (fp32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(1, cfg.warmup_steps)
    decay_steps = max(1, cfg.total_steps - cfg.warmup_steps)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.end_lr_fraction + (1 - cfg.end_lr_fraction) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def _zeros32(leaf):
    return map_members(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), leaf)


def init_opt_state(params: Any) -> Dict[str, Any]:
    device = tree_tensors(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map_leaves(_zeros32, params),
        "v": tree_map_leaves(_zeros32, params),
    }


def global_norm(tree: Any) -> torch.Tensor:
    sums = [t.float().square().sum() for t in tree_tensors(tree)]
    return torch.sqrt(torch.stack(sums).sum())


def sharded_global_norm(blocks, mesh) -> torch.Tensor:
    """The global norm of a gradient held in blocks on a mesh: ``blocks``
    is ``(leaf, mesh axes it is sharded over)`` per leaf, in tree order, a
    leaf a tensor or its per-layer tensors. Each layer's sum of squares is
    summed over the leaf's axes (the ranks holding its other blocks;
    replicas are counted once), then all of them as ``global_norm`` sums
    them, so at world size 1 the norm equals ``global_norm`` bit for bit."""
    from ..distributed.collectives import all_reduce_

    sums = []
    for leaf, axes in blocks:
        part = torch.stack([t.float().square().sum() for t in members(leaf)])
        sums += all_reduce_(part, mesh, *axes).unbind(0)
    return torch.sqrt(torch.stack(sums).sum())


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig,
    params: Any,
    grads: Any,
    state: Dict[str, Any],
    *,
    grad_norm: torch.Tensor = None,
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step over the tree, in place. Returns (params, state,
    {"lr", "grad_norm"}) with ``params`` and the moments the same tensors,
    updated, and ``state["step"]`` a new tensor. ``grad_norm``: the norm to
    clip by, when ``grads`` are blocks of a larger gradient."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)

    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)

    def upd(p, g, m, v, decay: bool):
        gf = g.float() * scale
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * gf.square())
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if decay:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
                          tree_leaves(state["v"])):
        # no decay on norms/biases: the stacked (declared) ndim decides
        decay = bool(cfg.weight_decay) and members(p)[0].ndim + stack_depth(p) >= 2
        map_members(lambda *t: upd(*t, decay), p, g, m, v)
    return params, {"step": step, "m": state["m"], "v": state["v"]}, {"lr": lr, "grad_norm": gnorm}
