"""Train step: loss + gradients + AdamW, with microbatch gradient
accumulation and optional int8 gradient compression (error feedback).

The counterpart of ``repro.train.train_step``. Gradients come from
``torch.autograd``; the step updates the model's parameters and the
optimizer state in place (the counterpart of the JAX step's
``donate_argnums``) and returns them with the JAX package's metrics.

``make_train_step(model, opt_cfg)`` is the one-device step.
``make_train_step(model, mesh, rules, opt_cfg)`` (or ``mesh=``/``rules=``)
is the step on a device mesh, DP/ZeRO-1 over ``data`` (and ``pod``), TP
over ``model``, EP over ``data``, returning ``(step_fn, shardings)`` as the
JAX package does:
  1. the model's parameters become this rank's blocks, as
     ``param_shardings`` places them (``fit_spec`` of each leaf's logical
     spec; a stacked leaf's per-layer tensors take the spec without its
     layer dims);
  2. each rank runs the model on its rows of the global batch, its
     collectives inside the forward and backward (``models.transformer``);
  3. each leaf's gradient, stacked as the JAX package holds it, is
     reduce-scattered over ``data`` onto the moments' ZeRO-1 layout
     (``zero1_spec``) and summed over the other DP axes it is not sharded
     over: the counterpart of the JAX step's sharding constraint, which
     makes GSPMD lower the sync as a reduce-scatter;
  4. AdamW runs on each rank's blocks, clipping by the norm of the whole
     gradient (``sharded_global_norm``); int8 compression takes one scale
     per stacked leaf, the max over every rank's block;
  5. the updated blocks are gathered over ``data`` back into the
     parameters' own placement.
The optimizer state on a mesh holds each moment as this rank's block of
the stacked leaf (``place_opt_state`` converts the one-device state). The
forward runs each layer under the config's remat policy
(``cfg.remat_policy``, ``models.transformer._remat``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..distributed import collectives
from ..distributed.compression import init_error_state, quantize_with_feedback
from ..distributed.sharding import (NamedSharding, P, ShardingRules, axis_index, axis_size,
                                    default_rules, fit_spec, mesh_shape, spec_axes, zero1_spec)
from ..models.layers import (leaf_paths, map_members, members, stack_depth, stack_members,
                             stacked, tree_map_leaves, tree_tensors)
from ..models.transformer import ModelContext
from ..obs import trace as _obs_trace
from .optimizer import AdamWConfig, adamw_update, init_opt_state, sharded_global_norm


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

    ctx = None  # a ModelContext on a mesh

    def __init__(self, model, opt_cfg: AdamWConfig, *, grad_accum: int = 1,
                 compress_grads: bool = False):
        self.model = model
        self.opt_cfg = opt_cfg
        self.grad_accum = grad_accum
        self.compress_grads = compress_grads
        self.grad_devices: set = set()
        model.requires_grad_(True)

    def _grads(self, flat_params, batch):
        with _obs_trace.span("train.forward"):
            loss, metrics = (self.model.loss(batch) if self.ctx is None
                             else self.model.loss(batch, self.ctx))
        with _obs_trace.span("train.backward"):
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
        with _obs_trace.span("train.optimizer"):
            if self.compress_grads:
                grads, err = quantize_with_feedback(grads, opt_state["grad_error"])
            params, new_opt, opt_metrics = adamw_update(
                self.opt_cfg, params, grads, {k: opt_state[k] for k in ("step", "m", "v")}
            )
            if self.compress_grads:
                new_opt["grad_error"] = err
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, new_opt, metrics


def make_train_step(model, *args, grad_accum: int = 1, compress_grads: bool = False,
                    zero1: bool = True, mesh=None, rules=None):
    """The step function of ``model`` (its parameters take gradients from
    here on): ``make_train_step(model, opt_cfg)`` on one device, a
    ``TrainStep``; ``make_train_step(model, mesh, rules, opt_cfg)`` or with
    ``mesh=`` (``rules`` default to ``default_rules(mesh)``) on a mesh,
    ``(step_fn, {"params", "opt"} shardings)`` with the model placed."""
    if len(args) == 3:
        mesh, rules, opt_cfg = args
    else:
        (opt_cfg,) = args
    if mesh is None:
        return TrainStep(model, opt_cfg, grad_accum=grad_accum, compress_grads=compress_grads)
    step = ShardedTrainStep(model, mesh, rules or default_rules(mesh), opt_cfg,
                            grad_accum=grad_accum, compress_grads=compress_grads, zero1=zero1)
    return step, step.shardings


# ---------------------------------------------------------------------------
# on a mesh
# ---------------------------------------------------------------------------

def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _tree(model, fn) -> Dict[str, Any]:
    """``fn(declaration)`` for each declared leaf of ``model``, as a tree."""
    out: Dict[str, Any] = {}
    for path, d in leaf_paths(model.defs):
        _set(out, path, fn(d))
    return out


def param_shardings(model, mesh, rules: ShardingRules):
    """Logical-axis shardings of the declared (stacked) leaves, clipped to
    divisible dims (``fit_spec``)."""
    return _tree(model, lambda d: NamedSharding(mesh, fit_spec(rules.spec(d.logical), d.shape,
                                                               mesh)))


def opt_state_shardings(model, mesh, rules: ShardingRules, *, zero1: bool = True):
    """Moments: param sharding + extra 'data' factor (ZeRO-1)."""
    p_shard = param_shardings(model, mesh, rules)
    m_shard = {}
    for path, d in leaf_paths(model.defs):
        spec = _get(p_shard, path).spec
        _set(m_shard, path, NamedSharding(mesh, zero1_spec(spec, d.shape, mesh) if zero1
                                          else spec))
    return {"step": NamedSharding(mesh, P()), "m": m_shard, "v": m_shard}


def batch_shardings(mesh, rules: ShardingRules, batch_specs: Dict[str, Any]):
    return {k: rules.sharding(mesh, ("batch",) + (None,) * (len(v.shape) - 1))
            for k, v in batch_specs.items()}


def place_model(model, shardings) -> None:
    """Make each of the model's parameters this rank's block of it, as
    ``shardings`` (``param_shardings``) places the leaf; a parameter
    already placed stays."""
    with torch.no_grad():
        for path, d in leaf_paths(model.defs):
            leaf = model.param_leaf(path)
            depth = stack_depth(leaf)
            sh = _get(shardings, path).layer(depth)
            full = tuple(d.shape[depth:])
            local = sh.local_shape(full)
            for p in members(leaf):
                if tuple(p.shape) == full and local != full:
                    p.data = sh.shard(p.data).clone()
                if tuple(p.shape) != local:
                    raise ValueError("%s: a parameter of shape %s is neither %s nor its block %s"
                                     % ("/".join(path), tuple(p.shape), full, local))


def local_rows(mesh, axes, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of a global batch: the batch split over the DP
    ``axes``, major first (as ``batch_partition`` shards it)."""
    sizes = mesh_shape(mesh)
    index, count = 0, 1
    for a in axes:
        index = index * sizes[a] + axis_index(mesh, a)
        count *= sizes[a]
    out = {}
    for k, v in batch.items():
        if v.shape[0] % count:
            raise ValueError("a batch of %d rows does not split over the %d ranks of %s"
                             % (v.shape[0], count, axes))
        n = v.shape[0] // count
        out[k] = v[index * n : (index + 1) * n]
    return out


class _Leaf(NamedTuple):
    """A declared leaf on the mesh: its path and stacked shape, its stacked
    dims, its moments' sharding, the DP axes its gradient is summed over,
    and the dim ZeRO-1 scatters (None if the moments are not split over
    ``data``)."""

    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    depth: int
    m_sh: NamedSharding
    reduce: Tuple[str, ...]
    zero_dim: Optional[int]


class ShardedTrainStep(TrainStep):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    on a mesh; ``batch`` is the global batch (every rank passes the same
    one), ``params`` the model's ``param_tree()`` of blocks, and the
    metrics are the global batch's."""

    def __init__(self, model, mesh, rules: ShardingRules, opt_cfg: AdamWConfig, *,
                 grad_accum: int = 1, compress_grads: bool = False, zero1: bool = True):
        super().__init__(model, opt_cfg, grad_accum=grad_accum, compress_grads=compress_grads)
        self.mesh, self.rules = mesh, rules
        self.ctx = ModelContext(mesh, rules)
        self.p_shard = param_shardings(model, mesh, rules)
        self.o_shard = opt_state_shardings(model, mesh, rules, zero1=zero1)
        if compress_grads:
            self.o_shard = dict(self.o_shard, grad_error=self.o_shard["m"])
        place_model(model, self.p_shard)
        self.leaves = []
        for path, d in leaf_paths(model.defs):
            p_axes = spec_axes(_get(self.p_shard, path).spec)
            m_sh = _get(self.o_shard["m"], path)
            zero_dim = next((i for i, e in enumerate(m_sh.spec)
                             if "data" in spec_axes((e,)) and "data" not in p_axes), None)
            self.leaves.append(_Leaf(
                path, tuple(d.shape), stack_depth(model.param_leaf(path)), m_sh,
                tuple(a for a in self.ctx.batch_axes if a not in p_axes), zero_dim))

    @property
    def shardings(self) -> Dict[str, Any]:
        return {"params": self.p_shard, "opt": self.o_shard}

    def place_opt_state(self, opt: Dict[str, Any]) -> Dict[str, Any]:
        """The optimizer state with each moment (and error state) this
        rank's block of its stacked leaf, converted in place from the
        one-device layout (per-layer lists, full shapes) leaf by leaf."""
        with torch.no_grad():
            for key in ("m", "v", "grad_error"):
                if key not in opt:
                    continue
                for leaf in self.leaves:
                    t = _get(opt[key], leaf.path)
                    if isinstance(t, list) or tuple(t.shape) != leaf.m_sh.local_shape(leaf.shape):
                        full = stacked(t)
                        if tuple(full.shape) != leaf.shape:
                            raise ValueError(
                                "%s/%s: %s is neither the declared %s nor its block; make the "
                                "optimizer state before the step places the model"
                                % (key, "/".join(leaf.path), tuple(full.shape), leaf.shape))
                        _set(opt[key], leaf.path, leaf.m_sh.shard(full).clone())
        return opt

    def _block(self, leaf: _Leaf, held):
        """This rank's ZeRO-1 block of a parameter leaf, as views of its
        per-layer tensors (the tensors themselves where the block is whole
        layers)."""
        if leaf.zero_dim is None:
            return held
        n = leaf.m_sh.local_shape(leaf.shape)[leaf.zero_dim]
        start = axis_index(self.mesh, "data") * n
        if leaf.zero_dim < leaf.depth:  # a block of layers
            return _narrow_layers(held, leaf.zero_dim, start, n)
        return map_members(lambda t: t.narrow(leaf.zero_dim - leaf.depth, start, n), held)

    def _gather_block(self, leaf: _Leaf, held, block) -> None:
        """Every rank's block back into the whole parameter leaf."""
        if leaf.zero_dim is None or axis_size(self.mesh, "data") == 1:
            return
        mesh = self.mesh
        if leaf.zero_dim < leaf.depth:
            full = collectives.all_gather(stacked(block), mesh, "data", dim=leaf.zero_dim)
            map_members(lambda dst, src: dst.copy_(src), held, stack_members(full, held))
        else:
            dim = leaf.zero_dim - leaf.depth
            map_members(lambda dst, b: dst.copy_(collectives.all_gather(b, mesh, "data", dim)),
                        held, block)

    def __call__(self, params, opt_state, batch) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
        mesh = self.mesh
        opt_state = self.place_opt_state(opt_state)
        batch = _on(local_rows(mesh, self.ctx.batch_axes, batch), self.model.device)
        loss, metrics, grads = self.compute_grads(params, batch)
        self.grad_devices = {g.device.type for g in tree_tensors(grads)}
        # 3. each leaf's gradient, stacked, onto the moments' layout (the
        # per-layer gradients dropped as each leaf is done)
        g_m: Dict[str, Any] = {}
        for leaf in self.leaves:
            g = stacked(_get(grads, leaf.path))
            _set(grads, leaf.path, None)
            reduce = leaf.reduce
            if leaf.zero_dim is not None:
                g = collectives.reduce_scatter(g, mesh, "data", dim=leaf.zero_dim)
                reduce = tuple(a for a in reduce if a != "data")
            _set(g_m, leaf.path, collectives.all_reduce_(g, mesh, *reduce))
        del grads
        # 4. AdamW on this rank's blocks, a layer at a time: views of the
        # stacked gradient, moments and error state, and of the parameters
        views = lambda tree: {leaf.path: _layers(_get(tree, leaf.path), leaf.depth)  # noqa: E731
                              for leaf in self.leaves}
        with _obs_trace.span("train.optimizer"):
            grads_l = _tree_of(views(g_m))
            if self.compress_grads:
                every = tuple(mesh_shape(mesh))
                err_l = views(opt_state["grad_error"])
                grads_l, err = quantize_with_feedback(
                    grads_l, _tree_of(err_l),
                    reduce_amax=lambda a: collectives.all_reduce_(
                        a.reshape(1), mesh, *every, op=torch.distributed.ReduceOp.MAX)[0])
                with torch.no_grad():
                    for path, held in err_l.items():
                        map_members(lambda dst, src: dst.copy_(src), held, _get(err, path))
            gnorm = sharded_global_norm([(_get(grads_l, leaf.path), spec_axes(leaf.m_sh.spec))
                                         for leaf in self.leaves], mesh)
            blocks = {leaf.path: self._block(leaf, _get(params, leaf.path)) for leaf in self.leaves}
            state = {"step": opt_state["step"], "m": _tree_of(views(opt_state["m"])),
                     "v": _tree_of(views(opt_state["v"]))}
            _, state, opt_metrics = adamw_update(self.opt_cfg, _tree_of(blocks), grads_l, state,
                                                 grad_norm=gnorm)
        # 5. the blocks gathered back into the parameters
        with torch.no_grad():
            for leaf in self.leaves:
                self._gather_block(leaf, _get(params, leaf.path), blocks[leaf.path])
        new_opt = dict(opt_state, step=state["step"])
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, new_opt, metrics


def _layers(t: torch.Tensor, depth: int):
    """A stacked tensor as per-layer views, nested ``depth`` deep."""
    return t if depth == 0 else [_layers(x, depth - 1) for x in t.unbind(0)]


def _narrow_layers(held, dim: int, start: int, n: int):
    """Layers ``start .. start + n`` along stacked dim ``dim`` of a leaf held
    per layer."""
    if dim == 0:
        return held[start : start + n]
    return [_narrow_layers(sub, dim - 1, start, n) for sub in held]


def _tree_of(by_path: Dict[Tuple[str, ...], Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, value in by_path.items():
        _set(out, path, value)
    return out


def init_train_state(model, generator: torch.Generator, *, compress_grads: bool = False):
    """Draw the model's parameters from ``generator`` and zero the
    optimizer state. Returns (params, opt_state), ``params`` the model's
    ``param_tree()``. On a mesh this comes first: the step then places the
    model and the state."""
    model.init(generator)
    params = model.param_tree()
    opt = init_opt_state(params)
    if compress_grads:
        opt["grad_error"] = init_error_state(params)
    return params, opt
