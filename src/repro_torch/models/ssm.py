"""Selective SSM (Mamba-style) branch of the Hymba hybrid block, on PyTorch.

The counterpart of ``repro.models.ssm``. Hymba (arXiv:2411.13676) runs
attention heads and SSM heads in parallel inside each block and fuses their
(normalized) outputs. The SSM branch is a selective scan: per-channel state
``h_t = exp(dt*A) h_{t-1} + dt*B_t x_t``, ``y_t = C_t . h_t + D_skip x_t``,
chunked at 256 steps as in the JAX package (padding steps past ``S`` carry
``decay = 1`` and ``drive = 0``). PyTorch has no associative scan, so
``_associative_scan`` writes out the recursion of ``jax.lax.associative_scan``
(log-depth, every step a whole-chunk tensor operation); it performs the
same fp32 operations in the same order as the JAX package.

Decode carries O(1) state: the SSM state [B, d_inner, N] plus the causal
conv tail [B, K-1, d_inner].

With ``mesh`` (tensor parallelism), the ``ssm_inner`` channels are this
rank's block of ``model``: ``w_in`` packs z and x in one ``ssm_inner``
dim, so its output blocks are gathered (``collectives.gather_to``) and each
rank takes its channels of z and of x; ``w_bc`` contracts the channels
(summed over ``model``, forward and backward, since each rank reads the
sum with its own channels), the scan runs on this rank's channels, and
``w_out``'s partial result is summed over ``model``. The state keeps this
rank's channels; the conv tail, replicated as the JAX package's cache
layout holds it, is gathered back whole.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed import collectives
from ..distributed.sharding import axis_index
from .layers import ParamDef, at_least_fp32, silu

CONV_K = 4  # causal depthwise conv kernel (mamba default)


def ssm_defs(n_layers: int, d_model: int, d_inner: int, n_state: int) -> Dict[str, Any]:
    L = (n_layers,) if n_layers else ()
    pl = (None,) * len(L)
    return {
        "w_in": ParamDef(L + (d_model, 2 * d_inner), pl + ("embed", "ssm_inner")),
        "conv": ParamDef(L + (CONV_K, d_inner), pl + ("conv_k", "ssm_inner"), scale=0.5),
        "w_dt": ParamDef(L + (d_inner,), pl + ("ssm_inner",), init="zeros"),
        "w_bc": ParamDef(L + (d_inner, 2 * n_state), pl + ("ssm_inner", None)),
        "a_log": ParamDef(L + (d_inner, n_state), pl + ("ssm_inner", "ssm_state"), init="zeros"),
        "d_skip": ParamDef(L + (d_inner,), pl + ("ssm_inner",), init="ones"),
        "w_out": ParamDef(L + (d_inner, d_model), pl + ("ssm_inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor, tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: [B,S,C]; kernel: [K,C]; tail: [B,K-1,C]."""
    k = kernel.shape[0]
    if tail is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = tail.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i : i + x.shape[1]] * kernel[i] for i in range(k))
    new_tail = xp[:, -(k - 1) :] if k > 1 else None
    return out, new_tail


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = torch.empty((even.shape[0], even.shape[1] + odd.shape[1]) + tuple(even.shape[2:]),
                      dtype=even.dtype, device=even.device)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along dim 1 of the pairs ``(a, b)`` under
    ``(a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2)``, by the recursion of
    ``jax.lax.associative_scan`` (adjacent pairs combined, the odd prefix
    scanned, the even ones filled in), so the fp32 operations are the JAX
    package's, in its order."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a_l, b_l, a_r, b_r = a[:, 0 : n - 1 : 2], b[:, 0 : n - 1 : 2], a[:, 1::2], b[:, 1::2]
    odd_a, odd_b = _associative_scan(a_l * a_r, a_r * b_l + b_r)
    a_e, b_e = a[:, 2::2], b[:, 2::2]
    if n % 2 == 0:
        ev_a, ev_b = odd_a[:, :-1] * a_e, a_e * odd_b[:, :-1] + b_e
    else:
        ev_a, ev_b = odd_a * a_e, a_e * odd_b + b_e
    ev_a = torch.cat([a[:, :1], ev_a], dim=1)
    ev_b = torch.cat([b[:, :1], ev_b], dim=1)
    return _interleave(ev_a, odd_a), _interleave(ev_b, odd_b)


def _ssm_scan_chunk(carry: torch.Tensor, a: torch.Tensor, bx: torch.Tensor):
    """Associative scan within one chunk given an incoming state.

    a, bx: [B, C, D, N] per-step decay and input. carry: [B, D, N].
    """
    a_acc, b_acc = _associative_scan(a, bx)
    h = a_acc * carry[:, None] + b_acc  # [B, C, D, N]
    return h[:, -1], h


def selective_ssm(
    params: Dict[str, Any],
    x: torch.Tensor,  # [B, S, D_model]
    *,
    chunk: int = 256,
    state: Optional[Dict[str, torch.Tensor]] = None,
    mesh=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Mamba-style selective scan. Returns (y [B,S,D_model], new_state).
    With ``mesh``, over this rank's channels of ``model`` (module doc)."""
    B, S, _ = x.shape
    d_inner = params["w_in"].shape[-1] // 2
    n_state = params["a_log"].shape[-1]

    if mesh is None:
        zx = torch.einsum("bsd,de->bse", x, params["w_in"])
        z, xc = zx.chunk(2, dim=-1)
        mine = None
    else:
        zx = collectives.gather_to(torch.einsum("bsd,de->bse", collectives.copy_to(
            x, mesh, "model"), params["w_in"]), mesh, "model", -1)
        mine = slice(axis_index(mesh, "model") * d_inner, (axis_index(mesh, "model") + 1)
                     * d_inner)
        z, xc = (t[..., mine] for t in zx.chunk(2, dim=-1))
    conv_tail = state["conv"] if state is not None else None
    if mine is not None and conv_tail is not None:
        conv_tail = conv_tail[..., mine]
    xc, new_tail = _causal_conv(xc, params["conv"], conv_tail)
    if mine is not None and new_tail is not None:
        new_tail = collectives.all_gather(new_tail, mesh, "model", dim=-1)
    xc = silu(xc)

    dt = F.softplus(at_least_fp32(xc) + at_least_fp32(params["w_dt"]))
    # Summed over the channels of every rank, then read by each rank's own
    # channels: its gradient is summed over model too.
    bc = collectives.copy_to(collectives.psum(at_least_fp32(torch.einsum(
        "bse,en->bsn", xc, params["w_bc"])), mesh, "model"), mesh, "model")
    b_in, c_out = bc.chunk(2, dim=-1)  # [B,S,N] each
    a = -torch.exp(at_least_fp32(params["a_log"]))  # [D,N], negative

    decay = torch.exp(dt[..., None] * a)  # [B,S,D,N]
    drive = (dt * at_least_fp32(xc))[..., None] * b_in[:, :, None, :]  # [B,S,D,N]

    h0 = state["h"] if state is not None else torch.zeros(
        (B, d_inner, n_state), dtype=dt.dtype, device=x.device)
    if mine is not None and h0.shape[1] != d_inner:  # a whole state: this rank's channels
        h0 = h0[:, mine]
    if S == 1:
        h = decay[:, 0] * h0 + drive[:, 0]
        hs = h[:, None]
        h_last = h
    else:
        n_chunks = -(-S // chunk)
        pad = n_chunks * chunk - S
        if pad:
            decay = F.pad(decay, (0, 0, 0, 0, 0, pad), value=1.0)
            drive = F.pad(drive, (0, 0, 0, 0, 0, pad))
        h_last, outs = h0, []
        for c in range(n_chunks):
            sl = slice(c * chunk, (c + 1) * chunk)
            h_last, hs_c = _ssm_scan_chunk(h_last, decay[:, sl], drive[:, sl])
            outs.append(hs_c)
        hs = torch.cat(outs, dim=1)[:, :S]

    y = torch.einsum("bsdn,bsn->bsd", hs, c_out)  # [B,S,D_inner] fp32
    y = y + at_least_fp32(params["d_skip"]) * at_least_fp32(xc)
    y = (y * silu(at_least_fp32(z))).to(x.dtype)
    y = collectives.psum(torch.einsum("bse,ed->bsd", y, params["w_out"]), mesh, "model")
    new_state = None
    if state is not None:
        new_state = {"h": h_last, "conv": new_tail}
    return y, new_state


def init_ssm_state(batch: int, d_inner: int, n_state: int, device="cpu",
                   dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The fp32 state (fp64 for an fp64 model) and the conv tail in the
    model's dtype (bf16, as the JAX package holds it)."""
    return {
        "h": torch.zeros((batch, d_inner, n_state), device=device,
                         dtype=torch.float64 if dtype == torch.float64 else torch.float32),
        "conv": torch.zeros((batch, CONV_K - 1, d_inner), dtype=dtype, device=device),
    }
