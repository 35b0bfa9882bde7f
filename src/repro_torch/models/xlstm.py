"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, strictly recurrent), on PyTorch.

The counterpart of ``repro.models.xlstm``. mLSTM has a stabilized parallel
("attention-like") form used for training and an O(1) recurrent form used
for decode:

    C_t = f_t C_{t-1} + i_t v_t k_t^T        (matrix memory, per head)
    n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, 1)

with exponential gating stabilized by the running max m_t. Between them
the chunkwise form carries the recurrent state across chunks of 256 steps
and is quadratic only within a chunk (prefill). sLSTM keeps per-head scalar
memories with recurrent (block-diagonal) gate connections; it has no
parallel form, so it steps through time.

Where the JAX package scans (over chunks, over time), this module loops in
Python. Gates and memories are fp32 (fp64 for an fp64 model); the bf16
products the JAX package accumulates in fp32 (``preferred_element_type``)
take fp32 operands here, an exact cast, so the sums are the same.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import ParamDef, at_least_fp32, rms_norm, silu

PROJ_FACTOR = 2  # mLSTM block up-projection factor


def mlstm_defs(n_layers: int, d_model: int, n_heads: int) -> Dict[str, Any]:
    d_in = PROJ_FACTOR * d_model
    L = (n_layers,) if n_layers else ()
    pl = (None,) * len(L)
    return {
        "norm": ParamDef(L + (d_model,), pl + ("embed",), init="zeros"),
        "w_up": ParamDef(L + (d_model, 2 * d_in), pl + ("embed", "ssm_inner")),
        "w_qkv": ParamDef(L + (d_in, 3 * d_in), pl + ("ssm_inner", None)),
        "w_if": ParamDef(L + (d_in, 2 * n_heads), pl + ("ssm_inner", None), scale=0.01),
        "b_if": ParamDef(L + (2 * n_heads,), pl + (None,), init="zeros"),
        "out_norm": ParamDef(L + (d_in,), pl + ("ssm_inner",), init="zeros"),
        "w_down": ParamDef(L + (d_in, d_model), pl + ("ssm_inner", "embed")),
    }


def slstm_defs(n_layers: int, d_model: int, n_heads: int) -> Dict[str, Any]:
    dh = d_model // n_heads
    L = (n_layers,) if n_layers else ()
    pl = (None,) * len(L)
    return {
        "norm": ParamDef(L + (d_model,), pl + ("embed",), init="zeros"),
        "w_gates": ParamDef(L + (d_model, 4 * d_model), pl + ("embed", "ssm_inner")),
        "r_gates": ParamDef(L + (n_heads, dh, 4 * dh), pl + (None, None, None), scale=0.02),
        "b_gates": ParamDef(L + (4 * d_model,), pl + ("ssm_inner",), init="zeros"),
        "out_norm": ParamDef(L + (d_model,), pl + ("embed",), init="zeros"),
        "w_out": ParamDef(L + (d_model, d_model), pl + ("embed", "embed")),
    }


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_parallel(q, k, v, log_i, log_f):
    """Stabilized parallel mLSTM. q,k,v: [B,S,H,Dh]; gates: [B,S,H] (fp32)."""
    b, s, h, dh = q.shape
    scale = dh ** -0.5
    cum_f = torch.cumsum(log_f, dim=1)  # [B,S,H]
    # log D[t, u] = log_i[u] + cum_f[t] - cum_f[u], valid for u <= t
    log_d = cum_f[:, :, None, :] - cum_f[:, None, :, :] + log_i[:, None, :, :]  # [B,T,U,H]
    tri = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    log_d = torch.where(tri[None, :, :, None], log_d, -math.inf)
    m = log_d.amax(dim=2, keepdim=True)  # [B,T,1,H] stabilizer
    d = torch.exp(log_d - m)
    scores = torch.einsum("bthd,buhd->btuh", at_least_fp32(q), at_least_fp32(k)) * scale
    weighted = scores * d
    norm = torch.maximum(weighted.sum(dim=2).abs(), torch.exp(-m[:, :, 0]))  # [B,T,H]
    out = torch.einsum("btuh,buhd->bthd", weighted, at_least_fp32(v))
    return (out / norm[..., None]).to(q.dtype)


def _mlstm_chunkwise(q, k, v, log_i, log_f, *, chunk: int = 256, init_state=None):
    """Chunkwise-parallel mLSTM: recurrent state across chunks, quadratic
    only within a chunk. The state (c, n, m) stands for the memory
    ``c * exp(m)`` (and ``n * exp(m)``). Padding steps get log_i = -1e30
    and log_f = 0, so they neither write nor decay the state."""
    b, s, h, dh = q.shape
    scale = dh ** -0.5
    acc = at_least_fp32(log_i).dtype
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=-1e30)
        log_f = F.pad(log_f, (0, 0, 0, pad))

    if init_state is not None:
        c_mat, n_vec, m_prev = init_state["c"], init_state["n"], init_state["m"]
    else:
        c_mat = torch.zeros((b, h, dh, dh), dtype=acc, device=q.device)
        n_vec = torch.zeros((b, h, dh), dtype=acc, device=q.device)
        m_prev = torch.full((b, h), -1e30, dtype=acc, device=q.device)

    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    outs = []
    for i in range(n_chunks):
        span = slice(i * chunk, (i + 1) * chunk)
        q_, k_, v_, li, lf = q[:, span], k[:, span], v[:, span], log_i[:, span], log_f[:, span]
        kf, vf = at_least_fp32(k_), at_least_fp32(v_)
        Fc = torch.cumsum(lf, dim=1)  # [B,C,H] inclusive cumsum of log f
        # log weights of intra-chunk source u for target t: F_t - F_u + li_u
        log_w = Fc[:, :, None, :] - Fc[:, None, :, :] + li[:, None, :, :]
        log_w = torch.where(tri[None, :, :, None], log_w, -math.inf)
        inter_log = Fc + m_prev[:, None, :]  # [B,C,H]
        m_t = torch.maximum(log_w.amax(dim=2), inter_log)  # [B,C,H]
        d = torch.exp(log_w - m_t[:, :, None, :])  # [B,C,U,H]
        inter_scale = torch.exp(inter_log - m_t)  # [B,C,H]

        scores = torch.einsum("bthd,buhd->btuh", at_least_fp32(q_), kf) * scale
        intra = torch.einsum("btuh,buhd->bthd", scores * d, vf)
        qf = at_least_fp32(q_) * scale
        inter = torch.einsum("bthd,bhdv->bthv", qf, c_mat) * inter_scale[..., None]
        num = intra + inter
        # normalizer: |q . n_t| with n_t split into intra + inter parts
        den_inter = torch.einsum("bthd,bhd->bth", qf, n_vec) * inter_scale
        den_intra = torch.einsum("bthd,buhd,btuh->bth", qf, kf, d)
        den = torch.maximum((den_intra + den_inter).abs(), torch.exp(-m_t))
        outs.append((num / den[..., None]).to(q.dtype))

        # ---- state update to end of chunk --------------------------------
        F_C = Fc[:, -1]  # [B,H]
        m_new = torch.maximum(F_C + m_prev, (F_C[:, None] - Fc + li).amax(dim=1))
        w_u = torch.exp(F_C[:, None] - Fc + li - m_new[:, None])  # [B,C,H]
        decay = torch.exp(F_C + m_prev - m_new)
        c_mat = decay[:, :, None, None] * c_mat + torch.einsum("buh,buhk,buhv->bhkv", w_u, kf, vf)
        n_vec = decay[:, :, None] * n_vec + torch.einsum("buh,buhk->bhk", w_u, kf)
        m_prev = m_new
    hs = torch.cat(outs, dim=1)
    return hs[:, :s], {"c": c_mat, "n": n_vec, "m": m_prev}


def _mlstm_recurrent_step(state, q, k, v, log_i, log_f):
    """One decode step. state: dict(c [B,H,Dk,Dv], n [B,H,Dk], m [B,H])."""
    dh = q.shape[-1]
    scale = dh ** -0.5
    m_new = torch.maximum(log_f + state["m"], log_i)  # [B,H]
    f_ = torch.exp(log_f + state["m"] - m_new)
    i_ = torch.exp(log_i - m_new)
    kf, vf, qf = at_least_fp32(k), at_least_fp32(v), at_least_fp32(q) * scale
    c = f_[..., None, None] * state["c"] + i_[..., None, None] * torch.einsum("bhk,bhv->bhkv", kf, vf)
    n = f_[..., None] * state["n"] + i_[..., None] * kf
    num = torch.einsum("bhkv,bhk->bhv", c, qf)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qf).abs(), torch.exp(-m_new))
    h = (num / den[..., None]).to(q.dtype)
    return {"c": c, "n": n, "m": m_new}, h


def mlstm_block(
    params,
    x: torch.Tensor,  # [B,S,D]
    n_heads: int,
    *,
    state: Optional[Dict[str, torch.Tensor]] = None,
    return_state: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The recurrent step when a state is given and S == 1; the parallel
    form with no state, no ``return_state`` and S <= 256; else the
    chunkwise form (chunks of 256), from ``state`` when given."""
    b, s, d = x.shape
    xn = rms_norm(x, params["norm"])
    up = torch.einsum("bsd,de->bse", xn, params["w_up"])
    inner, z = up.chunk(2, dim=-1)
    d_in = inner.shape[-1]
    dh = d_in // n_heads
    qkv = torch.einsum("bse,ef->bsf", inner, params["w_qkv"])
    q, k, v = (t.reshape(b, s, n_heads, dh) for t in qkv.chunk(3, dim=-1))
    gates = (at_least_fp32(torch.einsum("bse,eg->bsg", inner, params["w_if"]))
             + at_least_fp32(params["b_if"]))
    log_i, f_raw = gates.chunk(2, dim=-1)  # [B,S,H]
    log_f = F.logsigmoid(f_raw)

    new_state = None
    if state is not None and s == 1:
        new_state, h1 = _mlstm_recurrent_step(
            state, q[:, 0], k[:, 0], v[:, 0], log_i[:, 0], log_f[:, 0]
        )
        h = h1[:, None]
    elif state is None and not return_state and s <= 256:
        h = _mlstm_parallel(q, k, v, log_i, log_f)
    else:
        h, final_state = _mlstm_chunkwise(q, k, v, log_i, log_f, init_state=state)
        if return_state or state is not None:
            new_state = final_state
    h = h.reshape(b, s, d_in)
    h = rms_norm(h, params["out_norm"]) * silu(z)
    y = torch.einsum("bse,ed->bsd", h, params["w_down"])
    return x + y, new_state


def init_mlstm_state(batch: int, d_model: int, n_heads: int, device="cpu",
                     dtype=torch.float32) -> Dict[str, torch.Tensor]:
    d_in = PROJ_FACTOR * d_model
    dh = d_in // n_heads
    return {
        "c": torch.zeros((batch, n_heads, dh, dh), dtype=dtype, device=device),
        "n": torch.zeros((batch, n_heads, dh), dtype=dtype, device=device),
        # -inf-like stabilizer: an empty memory must not distort the
        # normalizer floor exp(-m) on the first real update.
        "m": torch.full((batch, n_heads), -1e30, dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_step(params_r, carry, zifo):
    """carry: (c, n, m, h_prev) each [B, H, Dh]; one timestep."""
    c, n, m, h_prev = carry
    rec = torch.einsum("bhd,hdg->bhg", h_prev, params_r)  # [B,H,4Dh]
    zz, ii, ff, oo = (zifo + rec).chunk(4, dim=-1)
    z = torch.tanh(zz)
    o = torch.sigmoid(oo)
    log_f = F.logsigmoid(ff)
    m_new = torch.maximum(log_f + m, ii)
    i_ = torch.exp(ii - m_new)
    f_ = torch.exp(log_f + m - m_new)
    c_new = f_ * c + i_ * z
    n_new = f_ * n + i_
    h = o * c_new / n_new.clamp(min=1.0)
    return (c_new, n_new, m_new, h), h


def slstm_block(
    params,
    x: torch.Tensor,  # [B,S,D]
    n_heads: int,
    *,
    state: Optional[Tuple[torch.Tensor, ...]] = None,
    return_state: bool = False,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, ...]]]:
    b, s, d = x.shape
    dh = d // n_heads
    xn = rms_norm(x, params["norm"])
    zifo = (at_least_fp32(torch.einsum("bsd,dg->bsg", xn, params["w_gates"]))
            + at_least_fp32(params["b_gates"])).reshape(b, s, n_heads, 4 * dh)
    if state is None:
        zeros = torch.zeros((b, n_heads, dh), dtype=zifo.dtype, device=x.device)
        carry = (zeros, zeros, zeros, zeros)
    else:
        carry = tuple(state)
    r = at_least_fp32(params["r_gates"])
    hs = []
    for t in range(s):
        carry, h_t = _slstm_step(r, carry, zifo[:, t])
        hs.append(h_t)
    h = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    h = rms_norm(h, params["out_norm"])
    y = torch.einsum("bsd,de->bse", h, params["w_out"])
    new_state = carry if (state is not None or return_state) else None
    return x + y, new_state


def init_slstm_state(batch: int, d_model: int, n_heads: int, device="cpu",
                     dtype=torch.float32) -> Tuple[torch.Tensor, ...]:
    dh = d_model // n_heads
    return tuple(torch.zeros((batch, n_heads, dh), dtype=dtype, device=device)
                 for _ in range(4))
