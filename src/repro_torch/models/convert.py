"""Load the JAX package's parameters into the port's modules.

``params_from_jax(cfg, tree)`` takes a parameter tree of the JAX package
(``repro.models.build_model(cfg).init(key)``) with every leaf as a numpy
array (``np.asarray`` of each leaf; stacked ``[L, ...]`` leaves as the JAX
package stacks its layers) and returns the port's ``Model`` holding the
same values, so both packages compute the same function. Nothing here
imports jax: bf16 leaves arrive as numpy's ``bfloat16`` extension dtype and
are reinterpreted bit for bit.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from .layers import leaf_paths
from .model import Model, build_model


def to_tensor(array: Any) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same dtype (bf16 bit for bit)."""
    a = np.asarray(array)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(cfg: ModelConfig, tree: Any, device="cuda") -> Model:
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
