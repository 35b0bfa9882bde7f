"""Mixture-of-Experts layer (DeepSeek-style) with explicit expert
parallelism, on PyTorch.

The counterpart of ``repro.models.moe``: the JAX layer's ``shard_map``
region, written out per rank. Off a mesh it runs at ``ep = tp = 1``
(experts and token-slot pairs on one device, no collective).

Sharding (as in the JAX package):
  * experts sharded over the ``data`` axis (EP): the dispatch is an
    all-to-all over ``data``;
  * token-slot pairs additionally split over the ``model`` axis, so the
    dispatch volume per rank is T * k * D / (ep * tp);
  * expert weights are replicated over ``model`` within a data row (their
    gradient is summed over ``model``: each model rank runs its own pairs);
  * shared experts run as a plain TP MLP (``transformer._mlp``).

Routing runs in fp32, per local token shard: softmax, top-k, renormalised
with a 1e-9 floor (or, with ``norm_topk_prob`` false, kept as they are:
DeepSeek-V2-Lite's greedy gate, whose routed scale is 1), and the
Switch/GShard load-balancing aux loss, whose
mean over the DP axes is the layer's (the ``pmean``s of the JAX layer; its
mean over ``model`` averages equal values and is left out). Token-slot
pairs (token-major: pair ``t * k + j`` is token ``t``'s ``j``-th expert,
padded to a multiple of ``tp``) go through the JAX layer's two
capacity-bounded dispatches exactly as written: the first, to the
expert-owning ``data`` shard, has ``cap1 = max(8, ceil(P_l / ep * cf))``
slots per shard; the second, onto the local experts, ``cap2 = max(8,
ceil(ep * cap1 / E_l * cf))`` slots per expert, assigned in pair order,
and drops the pairs past it. Capacity dropping therefore depends on the
mesh, as in the JAX package.

``dropless`` (one device, ``ep = tp = 1``; on a mesh it raises) replaces
both dispatches: the pairs, stably sorted by expert, run through the
experts as ``torch._grouped_mm`` over contiguous groups (int32 offsets
made on the device, so the layer never waits for the host), and come back
in pair order; no pair is dropped.

The router's part is the span ``moe.route``, the experts' (dispatch or
sort, products, combine) ``moe.experts``. ``count_pairs`` starts counters
kept on the device (pairs routed, pairs dropped, the most pairs one expert
took in one call), added to in place by every one-device call and read
once by ``pair_counts``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed import collectives
from ..distributed.sharding import axis_index, axis_size, mesh_shape
from ..obs import trace as _obs_trace
from .layers import ParamDef, act_fn, at_least_fp32

#: [pairs routed, pairs dropped, most pairs of one expert in one call],
#: int64 on the device while counting (``count_pairs``), else None.
_pair_totals: Optional[torch.Tensor] = None


def count_pairs(device) -> None:
    """Count every one-device ``moe_layer`` call's token-slot pairs on
    ``device``, from zero."""
    global _pair_totals
    _pair_totals = torch.zeros(3, dtype=torch.int64, device=device)


def pair_counts() -> Optional[Dict[str, int]]:
    """The counts since ``count_pairs`` (one read from the device), and
    stop counting; None where nothing was counting."""
    global _pair_totals
    if _pair_totals is None:
        return None
    routed, dropped, largest = _pair_totals.tolist()
    _pair_totals = None
    return {"routed": routed, "dropped": dropped, "largest_expert": largest}


def _count(counts: torch.Tensor, dropped: Optional[torch.Tensor] = None) -> None:
    """Add one call's pairs: ``counts`` routed to each expert, ``dropped``
    of them not computed (None: none can be)."""
    if _pair_totals is None:
        return
    _pair_totals[0] += counts.sum()
    if dropped is not None:
        _pair_totals[1] += dropped
    torch.maximum(_pair_totals[2:], counts.max()[None], out=_pair_totals[2:])


def moe_defs(
    n_layers: int,
    d_model: int,
    n_experts: int,
    d_ff_expert: int,
    n_shared: int,
) -> Dict[str, Any]:
    L = (n_layers,) if n_layers else ()
    pl = (None,) * len(L)
    defs: Dict[str, Any] = {
        "router": ParamDef(L + (d_model, n_experts), pl + ("embed", None), dtype=torch.float32),
        "w_gate": ParamDef(L + (n_experts, d_model, d_ff_expert), pl + ("experts", "embed", None)),
        "w_up": ParamDef(L + (n_experts, d_model, d_ff_expert), pl + ("experts", "embed", None)),
        "w_down": ParamDef(L + (n_experts, d_ff_expert, d_model), pl + ("experts", None, "embed")),
    }
    if n_shared:
        d_sh = n_shared * d_ff_expert
        defs["shared"] = {
            "w_gate": ParamDef(L + (d_model, d_sh), pl + ("embed", "ffn")),
            "w_up": ParamDef(L + (d_model, d_sh), pl + ("embed", "ffn")),
            "w_down": ParamDef(L + (d_sh, d_model), pl + ("ffn", "embed")),
        }
    return defs


def _dispatch(flat_idx: torch.Tensor, values: torch.Tensor, n_dest: int, capacity: int, fill=0):
    """Scatter ``values`` [P, ...] into [n_dest, capacity, ...] buffers.

    flat_idx: [P] destination ids (-1 = invalid). Returns (buffers, slot,
    kept): ``slot`` is each pair's row in its destination buffer, in pair
    order; pairs past ``capacity`` and invalid pairs land in a trash row
    that is sliced off (GShard-style dropping).
    """
    dests = torch.arange(n_dest, device=flat_idx.device)
    onehot = (flat_idx[:, None] == dests[None, :]).to(torch.int64)  # invalid -> 0s
    slot = torch.cumsum(onehot, dim=0) - onehot
    slot = (slot * onehot).sum(dim=1)  # [P]
    valid = (flat_idx >= 0) & (slot < capacity)
    dest = torch.where(valid, flat_idx, n_dest - 1)
    row = torch.where(valid, slot, capacity)  # trash row
    buffers = torch.full((n_dest, capacity + 1) + tuple(values.shape[1:]), fill,
                         dtype=values.dtype, device=values.device)
    buffers[dest, row] = values
    return buffers[:, :capacity], slot, valid


def moe_layer(
    params: Dict[str, Any],
    x: torch.Tensor,  # [B, S, D]: this rank's rows, replicated over model
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    activation: str = "silu",
    mesh=None,
    dp_axes: Tuple[str, ...] = ("data",),
    ep_axis: str = "data",
    tp_axis: str = "model",
    norm_topk_prob: bool = True,
    dropless: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed experts. Returns (y, aux_loss)."""
    n_experts = params["router"].shape[-1]
    ep, tp = axis_size(mesh, ep_axis), axis_size(mesh, tp_axis)
    if dropless and ep * tp > 1:
        raise ValueError("dropless experts run on one device (ep = tp = 1), not ep %d x tp %d"
                         % (ep, tp))
    assert n_experts % ep == 0, (n_experts, ep)
    batch_axes = tuple(a for a in dp_axes if a in mesh_shape(mesh))
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)

    # ---- routing (computed redundantly per model shard; cheap) -------------
    with _obs_trace.span("moe.route"):
        logits = at_least_fp32(xf) @ params["router"]
        probs = torch.softmax(logits, dim=-1)
        w_topk, idx_topk = torch.topk(probs, top_k, dim=-1)  # [T, k]
        if norm_topk_prob:
            w_topk = w_topk / torch.clamp(w_topk.sum(-1, keepdim=True), min=1e-9)

    # The count per expert at a static shape (bincount's output size depends
    # on the data, which fake tensors cannot give).
    flat_idx = idx_topk.reshape(-1)
    counts = torch.zeros(n_experts, dtype=torch.int64, device=x.device).index_add_(
        0, flat_idx, torch.ones_like(flat_idx))
    if dropless and not torch.is_grad_enabled():
        # the aux loss only trains the router: a server's step skips it
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:  # load-balance aux loss (Switch/GShard form)
        me = probs.mean(dim=0)
        ce = counts.float()
        ce = ce / torch.clamp(ce.sum(), min=1.0)
        aux = n_experts * torch.sum(me * ce)
    with _obs_trace.span("moe.experts"):
        if dropless:
            y = _dropless(params, xf, flat_idx, counts, w_topk.reshape(-1), top_k, activation)
        else:
            y = _capacity(params, xf, idx_topk, w_topk, counts, capacity_factor=capacity_factor,
                          activation=activation, mesh=mesh, ep_axis=ep_axis, tp_axis=tp_axis)
    aux = collectives.pmean(aux, mesh, *batch_axes)
    if ep > 1 and ep_axis not in batch_axes:
        aux = collectives.pmean(aux, mesh, ep_axis)
    return y.reshape(B, S, D).to(x.dtype), aux


def _dropless(params, xf: torch.Tensor, flat_idx: torch.Tensor, counts: torch.Tensor,
              pair_w: torch.Tensor, top_k: int, activation: str) -> torch.Tensor:
    """Every token-slot pair through its expert on one device: the pairs
    stably sorted by expert (``counts`` [E] of them each), the gate, up and
    down products as ``torch._grouped_mm`` over the experts' contiguous
    groups (int32 end offsets), each pair's output put back in pair order,
    and each token's ``top_k`` outputs summed by their weights in one
    batched product (fp32 accumulation). Every pair is a row of the grouped
    products, so none is counted dropped."""
    T, D = xf.shape
    order = torch.argsort(flat_idx, stable=True)
    offs = torch.cumsum(counts, 0, dtype=torch.int32)
    xs = xf[order // top_k]  # [P, D], grouped by expert
    a = F.silu if activation == "silu" else act_fn(activation)  # one kernel for silu
    gate = torch._grouped_mm(xs, params["w_gate"], offs=offs)
    up = torch._grouped_mm(xs, params["w_up"], offs=offs)
    ys = torch._grouped_mm(a(gate) * up, params["w_down"], offs=offs)
    _count(counts)
    pair_out = torch.empty_like(ys).index_copy_(0, order, ys).view(T, top_k, D)
    return torch.bmm(pair_w.view(T, 1, top_k).to(ys.dtype), pair_out).view(T, D)


def _capacity(params, xf: torch.Tensor, idx_topk: torch.Tensor, w_topk: torch.Tensor,
              counts: torch.Tensor, *, capacity_factor: float, activation: str, mesh,
              ep_axis: str, tp_axis: str) -> torch.Tensor:
    """The JAX layer's two capacity-bounded dispatches, the experts'
    batched products and the inverse path: [T, D], summed over the model
    shards."""
    n_experts = params["router"].shape[-1]
    ep, tp = axis_size(mesh, ep_axis), axis_size(mesh, tp_axis)
    e_local = n_experts // ep
    T, D = xf.shape
    top_k = idx_topk.shape[1]

    # ---- token-slot pairs, token-major, split over the model axis -----------
    pair_token = torch.arange(T, device=xf.device).repeat_interleave(top_k)
    pair_expert = idx_topk.reshape(-1)
    pair_w = w_topk.reshape(-1)
    n_pairs = T * top_k
    if tp > 1:
        # A replicated input enters the model-split pairs: its gradient is
        # the sum of every model rank's pairs.
        xf_in = collectives.copy_to(xf, mesh, tp_axis)
        pad = -(-n_pairs // tp) * tp - n_pairs
        pair_token = torch.nn.functional.pad(pair_token, (0, pad))
        pair_expert = torch.nn.functional.pad(pair_expert, (0, pad), value=-1)
        pair_w = torch.nn.functional.pad(collectives.copy_to(pair_w, mesh, tp_axis), (0, pad))
        p_l = (n_pairs + pad) // tp
        mine = slice(axis_index(mesh, tp_axis) * p_l, (axis_index(mesh, tp_axis) + 1) * p_l)
        pair_token, pair_expert, pair_w = pair_token[mine], pair_expert[mine], pair_w[mine]
    else:
        xf_in, p_l = xf, n_pairs

    # ---- first dispatch: to the expert-owning data shards ----------------------
    cap1 = max(8, int(math.ceil(p_l / ep * capacity_factor)))
    dest = torch.where(pair_expert >= 0, pair_expert // e_local, -1)
    x_pairs = xf_in[pair_token]  # [P_l, D]
    send_x, slot1, valid1 = _dispatch(dest, x_pairs, ep, cap1)
    meta = torch.where(valid1, pair_expert % e_local, -1)
    send_m, _, _ = _dispatch(dest, meta, ep, cap1, fill=-1)
    recv_x = collectives.all_to_all(send_x, mesh, ep_axis).reshape(ep * cap1, D)
    recv_m = collectives.all_to_all(send_m, mesh, ep_axis).reshape(ep * cap1)

    # ---- second dispatch: onto the local experts -------------------------------
    cap2 = max(8, int(math.ceil(ep * cap1 / e_local * capacity_factor)))
    xe, slot2, valid2 = _dispatch(recv_m, recv_x, e_local, cap2)  # [E_l, C2, D]

    # ---- grouped expert MLP ------------------------------------------------------
    a = act_fn(activation)
    w_gate, w_up, w_down = (collectives.copy_to(params[k], mesh, tp_axis)
                            for k in ("w_gate", "w_up", "w_down"))
    gate = torch.einsum("ecd,edf->ecf", xe, w_gate)
    up = torch.einsum("ecd,edf->ecf", xe, w_up)
    ye = torch.einsum("ecf,efd->ecd", a(gate) * up, w_down)  # [E_l, C2, D]

    # ---- inverse path --------------------------------------------------------------
    e_ids = torch.where(recv_m >= 0, recv_m, 0)
    row2 = torch.where(valid2, slot2, cap2 - 1)
    back = ye[e_ids, row2] * valid2[:, None].to(ye.dtype)  # [ep*cap1, D]
    ret = collectives.all_to_all(back.reshape(ep, cap1, D), mesh, ep_axis)
    d1 = torch.where(valid1, dest, 0)
    r1 = torch.where(valid1, slot1, 0)
    pair_out = ret[d1, torch.clamp(r1, max=cap1 - 1)] * valid1[:, None].to(ret.dtype)
    pair_out = pair_out * pair_w[:, None].to(pair_out.dtype)
    pair_out = torch.where(valid1[:, None], pair_out, 0)

    if ep * tp == 1:
        _count(counts, counts.sum() - valid2.sum())
    # combine the pairs back onto their tokens, in pair order; then sum over
    # the model shards
    if tp > 1:
        y = torch.zeros((T, D), dtype=pair_out.dtype, device=xf.device).index_add(
            0, pair_token, pair_out)
        return collectives.psum(y, mesh, tp_axis)
    pair_out = pair_out.reshape(T, top_k, D)
    y = torch.zeros((T, D), dtype=pair_out.dtype, device=xf.device)
    for j in range(top_k):
        y = y + pair_out[:, j]
    return y
