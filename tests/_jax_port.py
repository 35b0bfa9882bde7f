"""Helpers for tests that hold repro_torch against the JAX package.

The JAX side is compiled by XLA with ``xla_allow_excess_precision`` off
(``strict``): by default XLA may keep a fused chain of bf16 elementwise
operations in fp32 and round once at its end, which moves bf16 logits of a
smoke-width model by up to about 0.2 from the program as written (one
rounding per operation, which is what the JAX package's operations say and
what the port computes). With it off, both sides round after every
operation, and what is left between them is the order of fp32 sums inside
reductions and matmuls.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.distributed import default_rules
from repro.launch.mesh import make_mesh
from repro.models import ModelContext
from repro_torch.models.convert import to_tensor


#: The eight decoder configs the port runs, and the tolerance (rtol = atol)
#: on their bf16 logits against the JAX package (test_torch_models.py says
#: why two need more than 3e-2).
DECODERS = ["granite-3-2b", "gemma-2b", "qwen2.5-32b", "internlm2-20b", "deepseek-moe-16b",
            "deepseek-v2-236b", "hymba-1.5b", "internvl2-76b"]
LOGIT_TOL = dict.fromkeys(DECODERS, 3e-2) | {"deepseek-v2-236b": 5e-2, "hymba-1.5b": 5e-2}

#: How much further from an fp64 run of the same weights and inputs the
#: port's bf16 (or a mesh's fp32) leaves may lie than the reference's own,
#: in mean and in max error (``no_worse``).
NO_WORSE = 1.25


def strict(fn, *args):
    """``fn(*args)``, jitted with every bf16 operation rounded."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled(*args)


def jax_ctx() -> ModelContext:
    mesh = make_mesh((1, 1), ("data", "model"))
    return ModelContext(mesh, default_rules(mesh))


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def to_torch(tree):
    """A JAX tree (dicts of arrays) as the same tree of CPU tensors."""
    return jax.tree.map(lambda a: to_tensor(np.asarray(a)), tree)


def close(ref, got, tol: float, msg: str = "") -> None:
    np.testing.assert_allclose(f32(got), f32(ref), rtol=tol, atol=tol, err_msg=msg)


class _Wide(types.ModuleType):
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@contextlib.contextmanager
def jax_fp64():
    """The JAX package's models in fp64 while traced inside: ``jax_enable_x64``
    on, and the fp32 that ``repro.models`` takes for statistics, attention
    scores and the loss (``jnp.float32``) read as fp64, as the port's
    ``at_least_fp32`` keeps an fp64 model in fp64. Only the module globals
    are swapped, and put back on exit."""
    from repro.models import encdec, layers, model

    mods = (encdec, layers, model)
    saved = [m.jnp for m in mods]
    with jax.enable_x64(True):
        try:
            for m in mods:
                m.jnp = _Wide("jax.numpy")
            yield
        finally:
            for m, s in zip(mods, saved):
                m.jnp = s


def f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().cpu().numpy()
    return np.asarray(x).astype(np.float64)


def close64(ref, got, tol: float, msg: str = "") -> None:
    """``close`` without the fp32 cast, for fp64 leaves."""
    np.testing.assert_allclose(f64(got), f64(ref), rtol=tol, atol=tol, err_msg=msg)


def no_worse(exact, ref, got, msg: str = "", factor: float = NO_WORSE) -> None:
    """``got``'s mean and max error against ``exact`` (an fp64 run of the
    same weights and inputs) at most ``factor`` times ``ref``'s."""
    exact = f64(exact)
    err_ref, err_got = np.abs(f64(ref) - exact), np.abs(f64(got) - exact)
    assert err_got.shape == err_ref.shape, msg
    assert err_got.mean() <= factor * err_ref.mean(), (msg, err_got.mean(), err_ref.mean())
    assert err_got.max() <= factor * err_ref.max(), (msg, err_got.max(), err_ref.max())
