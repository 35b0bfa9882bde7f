"""Mixture-of-Experts layer (DeepSeek-style) on one device, on PyTorch.

The counterpart of ``repro.models.moe``: it computes what the JAX layer
computes at ``ep = tp = 1`` (experts and token-slot pairs on one device),
without its collectives. Expert parallelism over several cards waits for
the distributed slice.

Routing runs in fp32: softmax, top-k, renormalised with a 1e-9 floor, and
the Switch/GShard load-balancing aux loss. Token-slot pairs (token-major:
pair ``t * k + j`` is token ``t``'s ``j``-th expert) go through the JAX
layer's two capacity-bounded dispatches exactly as written: the first,
to the expert-owning shard, has ``cap1 = max(8, ceil(T * k * cf))`` slots
(it drops nothing when ``cf >= 1``); the second, onto the experts, has
``cap2 = max(8, ceil(cap1 / E * cf))`` slots per expert, assigned in pair
order, and drops the pairs past it. The capacity factor is applied twice,
as in the JAX layer.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from .layers import ParamDef, act_fn, at_least_fp32


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
    x: torch.Tensor,  # [B, S, D]
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    activation: str = "silu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed experts. Returns (y, aux_loss)."""
    n_experts = params["w_gate"].shape[0]
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    ep, e_local = 1, n_experts

    # ---- routing -----------------------------------------------------------
    logits = at_least_fp32(xf) @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    w_topk, idx_topk = torch.topk(probs, top_k, dim=-1)  # [T, k]
    w_topk = w_topk / torch.clamp(w_topk.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch/GShard form)
    me = probs.mean(dim=0)
    ce = torch.bincount(idx_topk.reshape(-1), minlength=n_experts).float()
    ce = ce / torch.clamp(ce.sum(), min=1.0)
    aux = n_experts * torch.sum(me * ce)

    # ---- token-slot pairs, token-major ---------------------------------------
    pair_token = torch.arange(T, device=x.device).repeat_interleave(top_k)
    pair_expert = idx_topk.reshape(-1)
    pair_w = w_topk.reshape(-1)
    n_pairs = T * top_k

    # ---- first dispatch: to the expert-owning shard (one here) ---------------
    cap1 = max(8, int(math.ceil(n_pairs / ep * capacity_factor)))
    dest = torch.where(pair_expert >= 0, pair_expert // e_local, -1)
    x_pairs = xf[pair_token]  # [P, D]
    send_x, slot1, valid1 = _dispatch(dest, x_pairs, ep, cap1)
    meta = torch.where(valid1, pair_expert % e_local, -1)
    send_m, _, _ = _dispatch(dest, meta, ep, cap1, fill=-1)
    recv_x = send_x.reshape(ep * cap1, D)
    recv_m = send_m.reshape(ep * cap1)

    # ---- second dispatch: onto the experts -----------------------------------
    cap2 = max(8, int(math.ceil(ep * cap1 / e_local * capacity_factor)))
    xe, slot2, valid2 = _dispatch(recv_m, recv_x, e_local, cap2)  # [E, C2, D]

    # ---- grouped expert MLP ----------------------------------------------------
    a = act_fn(activation)
    gate = torch.einsum("ecd,edf->ecf", xe, params["w_gate"])
    up = torch.einsum("ecd,edf->ecf", xe, params["w_up"])
    ye = torch.einsum("ecf,efd->ecd", a(gate) * up, params["w_down"])  # [E, C2, D]

    # ---- inverse path ------------------------------------------------------------
    e_ids = torch.where(recv_m >= 0, recv_m, 0)
    row2 = torch.where(valid2, slot2, cap2 - 1)
    back = ye[e_ids, row2] * valid2[:, None].to(ye.dtype)  # [ep*cap1, D]
    ret = back.reshape(ep, cap1, D)
    d1 = torch.where(valid1, dest, 0)
    r1 = torch.where(valid1, slot1, 0)
    pair_out = ret[d1, torch.clamp(r1, max=cap1 - 1)] * valid1[:, None].to(ret.dtype)
    pair_out = pair_out * pair_w[:, None].to(pair_out.dtype)

    # combine the pairs back onto their tokens, in pair order
    pair_out = torch.where(valid1[:, None], pair_out, 0).reshape(T, top_k, D)
    y = torch.zeros((T, D), dtype=pair_out.dtype, device=x.device)
    for j in range(top_k):
        y = y + pair_out[:, j]
    return y.reshape(B, S, D).to(x.dtype), aux
