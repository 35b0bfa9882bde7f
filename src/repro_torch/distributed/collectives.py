"""Collectives over one mesh axis, with the gradients the sharded model
needs.

The port's sharded code holds each rank's block as a plain tensor and says
where the ranks meet, as the JAX package does inside ``shard_map``. The
pairs of tensor parallelism follow Megatron: ``psum`` (sum forward,
identity backward) where a partial result leaves a model-sharded region,
``copy_to`` (identity forward, sum backward) where a replicated input
enters one; ``gather_to`` gathers blocks whose every rank then reads its
own part (its backward a reduce-scatter), ``gather_from`` blocks whose
every rank then reads the whole, as every other rank does (its backward
this rank's block of the gradient). ``pmean`` is the adjoint pair
of a mean (its backward divides by the axis size), ``all_to_all`` its own
adjoint and ``shift`` the adjoint pair of a ring ``ppermute``;
``split_weight_grad_einsum`` is a product with a weight every rank holds
whole, whose gradient each rank computes a block of. The ``*_`` forms and
the gathers and scatters carry no gradient. Each is the identity on an axis of size 1 or
off the mesh, so a world-size-1 run computes what the one-device code
computes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .sharding import axis_size


def group(mesh, axis: str):
    return mesh.get_group(axis)


def _live(mesh, axis: str) -> bool:
    return mesh is not None and axis_size(mesh, axis) > 1


def _all_reduce(x: torch.Tensor, mesh, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group(mesh, axis))
    return out


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh, ctx.axis), None, None


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.n = axis_size(mesh, axis)
        return _all_reduce(x, mesh, axis) / ctx.n

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, x.shape[dim]
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.mesh.get_local_rank(ctx.axis) * ctx.n
        return grad.narrow(ctx.dim, start, ctx.n), None, None, None


@torch.library.custom_op("repro_torch::all_to_all", mutates_args=())
def _a2a_op(x: torch.Tensor, group_name: str) -> torch.Tensor:
    """``dist.all_to_all_single`` as a functional operator: a new tensor
    out, nothing mutated, so a selective checkpoint can keep its output
    and the recompute then issues no collective
    (``models.transformer._remat``)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=_resolve_process_group(group_name))
    return out


@_a2a_op.register_fake
def _(x: torch.Tensor, group_name: str) -> torch.Tensor:
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _a2a(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _a2a_op(x, group(mesh, axis).group_name)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _a2a(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return _a2a(grad, ctx.mesh, ctx.axis), None, None


def _ring(x: torch.Tensor, mesh, axis: str, step: int) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` ahead along ``axis`` and receive from
    the one ``step`` behind (point to point)."""
    g = group(mesh, axis)
    n, me = axis_size(mesh, axis), mesh.get_local_rank(axis)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(g, (me + step) % n), g),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(g, (me - step) % n), g)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _ring(x, mesh, axis, 1)

    @staticmethod
    def backward(ctx, grad):
        return _ring(grad, ctx.mesh, ctx.axis, -1), None, None


class _SplitWeightGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, eq, x, w, mesh, axis, dim):
        ctx.eq, ctx.mesh, ctx.axis, ctx.dim = eq, mesh, axis, dim
        ctx.save_for_backward(x, w)
        return torch.einsum(eq, x, w)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        ins, out = ctx.eq.replace(" ", "").split("->")
        a, b = ins.split(",")
        dx = torch.einsum("%s,%s->%s" % (out, b, a), grad, w) if ctx.needs_input_grad[1] \
            else None
        dw = None
        if ctx.needs_input_grad[2]:
            letter, n = b[ctx.dim], w.shape[ctx.dim] // axis_size(ctx.mesh, ctx.axis)
            start = ctx.mesh.get_local_rank(ctx.axis) * n
            # this rank's block of the weight's dim: the operand that carries it narrowed
            xs = x.narrow(_at(a, letter, x.dim()), start, n) if letter in a else x
            gs = grad.narrow(_at(out, letter, grad.dim()), start, n) if letter in out else grad
            dw = all_gather(torch.einsum("%s,%s->%s" % (a, out, b), xs, gs), ctx.mesh,
                            ctx.axis, ctx.dim)
        return None, dx, dw, None, None, None


def _at(subscripts: str, letter: str, ndim: int) -> int:
    """The dim of ``letter`` in an operand of ``ndim`` dims written
    ``subscripts`` (which may open with ``...``)."""
    named = subscripts.replace("...", "")
    return ndim - len(named) + named.index(letter)


def split_weight_grad_einsum(eq: str, x: torch.Tensor, w: torch.Tensor, mesh,
                             axis: str = "model") -> torch.Tensor:
    """``torch.einsum(eq, x, w)`` where ``x``, the whole weight ``w`` and the
    result's gradient are the same on every rank of ``axis``: each rank
    computes the weight's gradient only for its block of the first dim of
    ``w`` that ``axis`` divides, and the blocks are gathered, as GSPMD
    splits a replicated weight's gradient over the ranks that hold the same
    data. ``x``'s gradient is whole on each rank. Plain ``torch.einsum`` off
    the mesh or where no dim of ``w`` divides (``w``'s subscripts name every
    dim)."""
    n = axis_size(mesh, axis) if mesh is not None else 1
    dim = next((d for d, s in enumerate(w.shape) if s % n == 0), None) if n > 1 else None
    if dim is None:
        return torch.einsum(eq, x, w)
    return _SplitWeightGrad.apply(eq, x, w, mesh, axis, dim)


def psum(x: torch.Tensor, mesh, *axes: str) -> torch.Tensor:
    """Sum over ``axes``; the gradient passes through unchanged."""
    for a in axes:
        if _live(mesh, a):
            x = _Sum.apply(x, mesh, a)
    return x


def copy_to(x: torch.Tensor, mesh, *axes: str) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``axes``."""
    for a in axes:
        if _live(mesh, a):
            x = _Copy.apply(x, mesh, a)
    return x


def gather_to(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's block of ``x`` along ``axis``, concatenated on ``dim``;
    the gradient of each block summed over the ranks (each reads its own
    part of the whole)."""
    if not _live(mesh, axis):
        return x
    return _Gather.apply(x, mesh, axis, dim % x.dim())


def gather_from(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's block of ``x`` along ``axis``, concatenated on ``dim``,
    for a replicated consumer: every rank computes the same function of
    the whole, so each block's gradient is this rank's part of the
    gradient, taken once."""
    if not _live(mesh, axis):
        return x
    return _GatherFrom.apply(x, mesh, axis, dim % x.dim())


def pmean(x: torch.Tensor, mesh, *axes: str) -> torch.Tensor:
    """Mean over ``axes``; the gradient divided by the axes' size."""
    for a in axes:
        if _live(mesh, a):
            x = _Mean.apply(x, mesh, a)
    return x


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Block ``j`` of dim 0 to rank ``j`` of ``axis``; block ``j`` of the
    result came from rank ``j`` (``jax.lax.all_to_all(x, axis, 0, 0)``)."""
    if not _live(mesh, axis):
        return x
    return _AllToAll.apply(x, mesh, axis)


def shift(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Rank ``i`` receives rank ``i - 1``'s ``x`` (a ring ``ppermute``)."""
    if not _live(mesh, axis):
        return x
    return _Shift.apply(x, mesh, axis)


@torch.no_grad()
def all_reduce_(x: torch.Tensor, mesh, *axes: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place reduction over ``axes``, no gradient."""
    for a in axes:
        if _live(mesh, a):
            dist.all_reduce(x, op=op, group=group(mesh, a))
    return x


@torch.no_grad()
def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated on ``dim`` in rank
    order."""
    if not _live(mesh, axis):
        return x
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, x.contiguous(), group=group(mesh, axis))
    return torch.cat(parts, dim=dim)


@torch.no_grad()
def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The sum over ``axis`` of ``x``, of which each rank keeps its block of
    ``dim`` (the ZeRO-1 gradient sync)."""
    if not _live(mesh, axis):
        return x
    n = axis_size(mesh, axis)
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((moved.shape[0] // n,) + tuple(moved.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, moved, group=group(mesh, axis))
    return out.movedim(0, dim)
