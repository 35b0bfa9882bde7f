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

With ``mesh`` (tensor parallelism), each ``ssm_inner`` leaf is this rank's
block of ``model``, where the JAX package annotates the layouts and leaves
the split to GSPMD:

  * mLSTM: ``w_up`` packs ``inner | z`` in one ``ssm_inner`` dim, so its
    output blocks are gathered (``collectives.gather_to``) and each rank
    takes its channels of ``inner`` and of ``z``; ``w_qkv`` and ``w_if``
    contract those channels, summed over ``model`` (``psum``), so q, k, v
    and the gates are whole on every rank. From no state (train, prefill)
    the cell runs on this rank's heads, or on one head and a block of its
    value columns where the ranks outnumber the heads (xlstm-350m's 4 heads
    on 16 ranks: a head and 128 of its 512 value columns a rank;
    ``_cell_block``), and its outputs are gathered (``gather_from``; q, k,
    v and the gates take their gradients summed over ``model``); a
    prefill's final state is gathered too (``_gather_cell_state``) and cut
    to this rank's ``Dk`` rows. The cell's output is normalized over all
    its channels and each rank keeps its block (``out_norm``'s),
    gated by its ``z``, and ``w_down``'s partial product is summed over
    ``model``. In decode the matrix memory ``c [B, H, Dk, Dv]`` and ``n
    [B, H, Dk]`` hold this rank's ``Dk`` rows (``cache_spec``): the update
    reads this rank's rows of k, and each contraction over ``Dk`` (``C q``,
    ``n . q``) is a sum over ``model``, so the state never leaves its rank;
    ``m`` is whole.
  * sLSTM: ``w_gates`` and ``b_gates`` split their columns, and a head's
    four gates are contiguous, so the gate pre-activations are gathered
    whole (``collectives.gather_from``: every rank then steps every head);
    ``r_gates``, ``w_out`` and the state are whole.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed import collectives
from ..distributed.sharding import axis_index, axis_size
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


def _block(mesh, n: int) -> Optional[slice]:
    """This rank's block of ``n`` channels along ``model``; None off a mesh
    or where ``n`` does not divide (the dim then stays whole, as
    ``fit_spec`` leaves it)."""
    if mesh is None or n % axis_size(mesh, "model"):
        return None
    size = n // axis_size(mesh, "model")
    start = axis_index(mesh, "model") * size
    return slice(start, start + size)


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
        c_mat = torch.zeros((b, h, dh, v.shape[-1]), dtype=acc, device=q.device)
        n_vec = torch.zeros((b, h, dh), dtype=acc, device=q.device)
        m_prev = torch.full((b, h), -1e30, dtype=acc, device=q.device)

    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    outs = []
    # Split once: the backward then writes each input's gradient once (a
    # slice per chunk would add a whole-length zero gradient per chunk).
    pieces = zip(*(t.split(chunk, dim=1) for t in (q, k, v, log_i, log_f)))
    for q_, k_, v_, li, lf in pieces:
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


def _mlstm_recurrent_step(state, q, k, v, log_i, log_f, mesh=None):
    """One decode step. state: dict(c [B,H,Dk,Dv], n [B,H,Dk], m [B,H]);
    with ``mesh``, ``c`` and ``n`` hold this rank's ``Dk`` rows (``_block``)
    and the contractions over ``Dk`` are summed over ``model``."""
    dh = q.shape[-1]
    scale = dh ** -0.5
    rows = _block(mesh, dh)
    if rows is not None:
        q, k = q[..., rows], k[..., rows]
    m_new = torch.maximum(log_f + state["m"], log_i)  # [B,H]
    f_ = torch.exp(log_f + state["m"] - m_new)
    i_ = torch.exp(log_i - m_new)
    kf, vf, qf = at_least_fp32(k), at_least_fp32(v), at_least_fp32(q) * scale
    c = f_[..., None, None] * state["c"] + i_[..., None, None] * torch.einsum("bhk,bhv->bhkv", kf, vf)
    n = f_[..., None] * state["n"] + i_[..., None] * kf
    num = collectives.psum(torch.einsum("bhkv,bhk->bhv", c, qf), mesh, "model")
    den = torch.maximum(collectives.psum(torch.einsum("bhk,bhk->bh", n, qf), mesh,
                                         "model").abs(), torch.exp(-m_new))
    h = (num / den[..., None]).to(q.dtype)
    return {"c": c, "n": n, "m": m_new}, h


def _cell_block(mesh, n_heads: int, dv: int) -> Optional[Tuple[slice, slice]]:
    """(this rank's heads, its value columns) where the mLSTM cell splits
    over ``model`` in training: a block of heads where they divide the
    ranks, else one head and a block of its value columns where the ranks
    divide the heads and the columns; None off a mesh or otherwise."""
    if mesh is None or axis_size(mesh, "model") == 1:
        return None
    tp, r = axis_size(mesh, "model"), axis_index(mesh, "model")
    if n_heads % tp == 0:
        n = n_heads // tp
        return slice(r * n, (r + 1) * n), slice(None)
    per = tp // n_heads
    if tp % n_heads or dv % per:
        return None
    w = dv // per
    return slice(r // per, r // per + 1), slice(r % per * w, (r % per + 1) * w)


def _gather_cell_state(block: Dict[str, torch.Tensor], mesh, n_heads: int):
    """The whole state (c [B, H, Dk, Dv], n [B, H, Dk], m [B, H]) from each
    rank's block of a ``_cell_block`` cell: ``c`` of its heads and value
    columns, ``n`` and ``m`` of its heads (alike on the ranks of a head)."""
    tp = axis_size(mesh, "model")
    c, n, m = (collectives.all_gather(block[k][None], mesh, "model", 0) for k in "cnm")
    b, n_h, dk, w = block["c"].shape
    groups = n_heads // n_h  # of heads; each over ``per`` ranks' value columns
    per = tp // groups
    c = c.reshape(groups, per, b, n_h, dk, w).permute(2, 0, 3, 4, 1, 5)
    return {"c": c.reshape(b, n_heads, dk, per * w),
            "n": n.reshape(groups, per, b, n_h, dk)[:, 0].transpose(0, 1).reshape(b, n_heads, dk),
            "m": m.reshape(groups, per, b, n_h)[:, 0].transpose(0, 1).reshape(b, n_heads)}


def _rms_norm_block(x: torch.Tensor, weight: torch.Tensor, cols: slice,
                    eps: float = 1e-6) -> torch.Tensor:
    """``rms_norm(x, w)[..., cols]`` from ``x`` whole and ``weight``, the
    block ``cols`` of ``w``: the mean square over every channel."""
    xf = at_least_fp32(x)
    normed = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (normed[..., cols] * (1.0 + at_least_fp32(weight))).to(x.dtype)


def mlstm_block(
    params,
    x: torch.Tensor,  # [B,S,D]
    n_heads: int,
    *,
    state: Optional[Dict[str, torch.Tensor]] = None,
    return_state: bool = False,
    mesh=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The recurrent step when a state is given and S == 1; the parallel
    form with no state, no ``return_state`` and S <= 256; else the
    chunkwise form (chunks of 256), from ``state`` when given. With
    ``mesh``, on this rank's blocks of the ``ssm_inner`` leaves and of the
    state's ``Dk`` rows (module doc)."""
    b, s, d = x.shape
    d_in = PROJ_FACTOR * d
    xn = rms_norm(x, params["norm"])
    cols = None
    if mesh is not None and params["w_up"].shape[-1] < 2 * d_in:
        cols = _block(mesh, d_in)
        if cols is None:
            raise NotImplementedError("an mLSTM whose %d channels do not split over model = %d"
                                      % (d_in, axis_size(mesh, "model")))
    if cols is None:
        up = torch.einsum("bsd,de->bse", xn, params["w_up"])
        inner, z = up.chunk(2, dim=-1)
        qkv = torch.einsum("bse,ef->bsf", inner, params["w_qkv"])
        gates = torch.einsum("bse,eg->bsg", inner, params["w_if"])
    else:
        up = collectives.gather_to(torch.einsum("bsd,de->bse", collectives.copy_to(
            xn, mesh, "model"), params["w_up"]), mesh, "model", -1)
        inner, z = (t[..., cols] for t in up.chunk(2, dim=-1))
        qkv = collectives.psum(torch.einsum("bse,ef->bsf", inner, params["w_qkv"]), mesh,
                               "model")
        gates = collectives.psum(torch.einsum("bse,eg->bsg", inner, params["w_if"]), mesh,
                                 "model")
    dh = d_in // n_heads
    # from no state on a mesh (train, prefill): the cell on this rank's heads
    # and value columns, the gradients of q, k, v and the gates summed over model
    cell = _cell_block(mesh, n_heads, dh) if cols is not None and state is None else None
    gates = at_least_fp32(gates) + at_least_fp32(params["b_if"])
    if cell is not None:
        qkv, gates = (collectives.copy_to(t, mesh, "model") for t in (qkv, gates))
    q, k, v = (t.reshape(b, s, n_heads, dh) for t in qkv.chunk(3, dim=-1))
    log_i, f_raw = gates.chunk(2, dim=-1)  # [B,S,H]
    log_f = F.logsigmoid(f_raw)

    rows = _block(mesh, dh)  # the state's Dk rows this rank holds
    new_state = None
    if state is not None and s == 1:
        new_state, h1 = _mlstm_recurrent_step(
            state, q[:, 0], k[:, 0], v[:, 0], log_i[:, 0], log_f[:, 0], mesh=mesh
        )
        h = h1[:, None]
    elif cell is not None:
        heads, vcols = cell
        mine = (q[:, :, heads], k[:, :, heads], v[:, :, heads, vcols], log_i[..., heads],
                log_f[..., heads])
        if s <= 256 and not return_state:
            h = _mlstm_parallel(*mine)
        else:
            h, final = _mlstm_chunkwise(*mine)
            if return_state:  # every rank's block of the state; this rank's Dk rows of it
                new_state = _gather_cell_state(final, mesh, n_heads)
                if rows is not None:
                    new_state = dict(new_state, c=new_state["c"][..., rows, :],
                                     n=new_state["n"][..., rows])
        # every rank's block, in rank order: heads major, then value columns
        h = collectives.gather_from(h.reshape(b, s, -1), mesh, "model", -1)
    elif state is None and not return_state and s <= 256:
        h = _mlstm_parallel(q, k, v, log_i, log_f)
    else:
        if state is not None and rows is not None:  # inference: the whole state
            state = dict(state, c=collectives.all_gather(state["c"], mesh, "model", dim=-2),
                         n=collectives.all_gather(state["n"], mesh, "model", dim=-1))
        h, final_state = _mlstm_chunkwise(q, k, v, log_i, log_f, init_state=state)
        if return_state or state is not None:
            new_state = final_state
            if rows is not None:
                new_state = dict(new_state, c=new_state["c"][..., rows, :],
                                 n=new_state["n"][..., rows])
    h = h.reshape(b, s, d_in)
    if cols is None:
        h = rms_norm(h, params["out_norm"]) * silu(z)
        y = torch.einsum("bse,ed->bsd", h, params["w_down"])
    else:
        # The cell's output is whole on every rank; each reads its block.
        h = _rms_norm_block(collectives.copy_to(h, mesh, "model"), params["out_norm"],
                            cols) * silu(z)
        y = collectives.psum(torch.einsum("bse,ed->bsd", h, params["w_down"]), mesh, "model")
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
    mesh=None,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, ...]]]:
    """With ``mesh``, on this rank's gate columns (module doc)."""
    b, s, d = x.shape
    dh = d // n_heads
    xn = rms_norm(x, params["norm"])
    split = mesh is not None and params["w_gates"].shape[-1] < 4 * d
    if split:
        xn = collectives.copy_to(xn, mesh, "model")
    zifo = (at_least_fp32(torch.einsum("bsd,dg->bsg", xn, params["w_gates"]))
            + at_least_fp32(params["b_gates"]))
    if split:
        zifo = collectives.gather_from(zifo, mesh, "model", -1)
    zifo = zifo.reshape(b, s, n_heads, 4 * dh)
    if state is None:
        zeros = torch.zeros((b, n_heads, dh), dtype=zifo.dtype, device=x.device)
        carry = (zeros, zeros, zeros, zeros)
    else:
        carry = tuple(state)
    r = at_least_fp32(params["r_gates"])
    hs = []
    for zifo_t in zifo.unbind(1):  # one gradient write, not a whole-length one per step
        carry, h_t = _slstm_step(r, carry, zifo_t)
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
