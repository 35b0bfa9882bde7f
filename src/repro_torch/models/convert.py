"""Move parameters between the JAX package's trees and the port's modules.

``params_from_jax(cfg, tree)`` takes a parameter tree of the JAX package
(``repro.models.build_model(cfg).init(key)``) with every leaf as a numpy
array (``np.asarray`` of each leaf; stacked ``[L, ...]`` or ``[G, L, ...]``
leaves as the JAX package stacks its layers) and returns the port's model
holding the same values, so both packages compute the same function.
``params_to_jax(model)`` is its inverse. Nothing here imports jax: bf16
leaves arrive as numpy's ``bfloat16`` extension dtype and are
reinterpreted bit for bit.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from .layers import leaf_paths, stacked, tree_map_leaves
from .model import build_model


def to_tensor(array: Any) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same dtype (bf16 bit for bit)."""
    a = np.asarray(array)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array of the same dtype; bf16 bit for bit as
    numpy's ``bfloat16`` (the ``ml_dtypes`` type JAX arrays convert to)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.contiguous().view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(cfg: ModelConfig, tree: Any, device="cuda"):
    """The port's model of ``cfg`` on ``device`` with the parameters of
    ``tree``; every declared leaf must be there with its declared shape
    and dtype, and nothing else."""
    model = build_model(cfg, device=device)
    want = {path for path, _ in leaf_paths(model.defs)}
    got = {path for path, _ in leaf_paths(tree)}
    if want != got:
        raise ValueError("parameter tree differs from %s's declarations: missing %s, extra %s"
                         % (cfg.name, sorted(want - got), sorted(got - want)))

    def value(d, path):
        leaf = tree
        for k in path:
            leaf = leaf[k]
        t = to_tensor(leaf)
        if tuple(t.shape) != d.shape or t.dtype != d.dtype:
            raise ValueError("%s: %s %s, declared %s %s"
                             % ("/".join(path), tuple(t.shape), t.dtype, d.shape, d.dtype))
        return t.to(model.device)

    model.assign(model.defs, value)
    return model


def params_to_jax(model) -> Any:
    """The model's parameters as the JAX package's tree: its keys, stacked
    leaves, numpy arrays of the declared dtypes (bf16 as numpy's
    ``bfloat16``)."""
    return tree_map_leaves(lambda leaf: to_numpy(stacked(leaf)), model.param_tree())
