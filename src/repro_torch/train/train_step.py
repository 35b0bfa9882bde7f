"""Train step: loss + gradients + AdamW, with microbatch gradient
accumulation and optional int8 gradient compression (error feedback).

The counterpart of ``repro.train.train_step`` on one card. Gradients come
from ``torch.autograd``; the step updates the model's parameters and the
optimizer state in place (the counterpart of the JAX step's
``donate_argnums``) and returns them with the JAX package's metrics.
``param_shardings``, ``opt_state_shardings``, ``batch_shardings`` and the
ZeRO-1 gradient constraint need a mesh and wait for the distributed slice;
so does remat (``cfg.remat_policy``): the forward keeps every activation.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..distributed.compression import init_error_state, quantize_with_feedback
from ..models.layers import map_members, tree_map_leaves, tree_tensors
from .optimizer import AdamWConfig, adamw_update, init_opt_state


def _like(tree, flat: list):
    """``flat`` (tensors in ``tree_tensors`` order) laid out as ``tree``."""
    it = iter(flat)
    return tree_map_leaves(lambda leaf: map_members(lambda _: next(it), leaf), tree)


def _on(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's arrays (numpy, as the pipeline yields them, or tensors)
    as tensors on the model's device."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray)
                else torch.as_tensor(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


class TrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    ``params`` is ``model.param_tree()``, updated in place with the
    moments; ``opt_state`` comes back with its new step (and error state).
    ``grad_devices`` holds the device types of the last step's gradients."""

    def __init__(self, model, opt_cfg: AdamWConfig, *, grad_accum: int = 1,
                 compress_grads: bool = False):
        self.model = model
        self.opt_cfg = opt_cfg
        self.grad_accum = grad_accum
        self.compress_grads = compress_grads
        self.grad_devices: set = set()
        model.requires_grad_(True)

    def _grads(self, flat_params, batch):
        loss, metrics = self.model.loss(batch)
        grads = torch.autograd.grad(loss, flat_params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat_params, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def compute_grads(self, params, batch):
        flat_params = tree_tensors(params)
        n = self.grad_accum
        if n == 1:
            loss, metrics, grads = self._grads(flat_params, batch)
            return loss, metrics, _like(params, grads)
        # Microbatch accumulation: leading splits, fp32 accumulators, the
        # mean cast to bf16 (whatever the parameters' dtype), the mean loss
        # and the last microbatch's metrics.
        rows = next(iter(batch.values())).shape[0] // n
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in flat_params]
        loss_sum = 0.0
        for i in range(n):
            mb = {k: v[i * rows : (i + 1) * rows] for k, v in batch.items()}
            loss, metrics, grads = self._grads(flat_params, mb)
            for a, g in zip(acc, grads):
                a.add_(g.float())
            loss_sum = loss_sum + loss
            del grads
        grads = [(a / n).to(torch.bfloat16) for a in acc]
        return loss_sum / n, metrics, _like(params, grads)

    def __call__(self, params, opt_state, batch) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
        batch = _on(batch, self.model.device)
        loss, metrics, grads = self.compute_grads(params, batch)
        self.grad_devices = {g.device.type for g in tree_tensors(grads)}
        if self.compress_grads:
            grads, err = quantize_with_feedback(grads, opt_state["grad_error"])
        params, new_opt, opt_metrics = adamw_update(
            self.opt_cfg, params, grads, {k: opt_state[k] for k in ("step", "m", "v")}
        )
        if self.compress_grads:
            new_opt["grad_error"] = err
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, new_opt, metrics


def make_train_step(model, opt_cfg: AdamWConfig, *, grad_accum: int = 1,
                    compress_grads: bool = False) -> TrainStep:
    """The step function of ``model`` (its parameters take gradients from
    here on)."""
    return TrainStep(model, opt_cfg, grad_accum=grad_accum, compress_grads=compress_grads)


def init_train_state(model, generator: torch.Generator, *, compress_grads: bool = False):
    """Draw the model's parameters from ``generator`` and zero the
    optimizer state. Returns (params, opt_state), ``params`` the model's
    ``param_tree()``."""
    model.init(generator)
    params = model.param_tree()
    opt = init_opt_state(params)
    if compress_grads:
        opt["grad_error"] = init_error_state(params)
    return params, opt
