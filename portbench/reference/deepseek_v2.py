"""Plain PyTorch reference of the DeepSeek-V2 decoder the
``deepseek-v2-lite`` configuration states, in float32 with TF32 off:

* pre-norm blocks; RMS norms (eps ``rms_norm_eps``) that scale by 1 + gain;
* Multi-head Latent Attention in its plain, non-absorbed form: the query
  projected directly (``q_lora_rank`` null), the keys' and values'
  latent ``c = rms(h W_dkv[:R])`` expanded per head (``k_nope = c W_uk``,
  ``v = c W_uv``), one rope key ``h W_dkv[R:]`` shared by the heads,
  causal softmax attention over every position;
* YaRN rope (``rope_scaling``) on the rope dims, in the program's
  half-rotation layout (DeepSeek's own code first de-interleaves the rope
  dims: a fixed permutation of ``W_q``'s and ``W_dkv``'s rope columns, which
  random weights do not see), and YaRN's softmax temperature
  ``(0.1 mscale_all_dim ln(factor) + 1)^2`` on ``(nope + rope)^-0.5``;
* the first ``first_k_dense_replace`` layers a SiLU-gated MLP; the others
  the routed experts (softmax over ``n_routed_experts`` in fp32, the
  greedy top ``num_experts_per_tok``, their probabilities kept as they are
  (``norm_topk_prob`` false; ``routed_scaling_factor`` 1, the only scale
  it takes) as a loop over the experts, each taking every pair routed to it
  (dropless), plus the shared experts' MLP;
* untied output projection.

Each layer's weights (bf16, as drawn) are cast to fp32 when that layer
runs, so the whole model fits on one card beside its activations; the
sequences run as one batch, attention a row and ``Q_CHUNK`` queries at a
time. No cache.

Controls and faults, each a departure from the above: ``precision="fp8"``
takes both operands of every product of an activation with a weight
through float8 e4m3 (``granite.fp8``); ``rope="plain"`` is RoPE without
YaRN (theta's frequencies, no temperature); ``renormalize=True`` makes the
kept top-k weights sum to one.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .granite import fp8, no_tf32  # noqa: F401  (no_tf32: for the callers)

Q_CHUNK = 1024


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(scaling: Mapping, dim: int, base: float) -> np.ndarray:
    """YaRN's inverse frequencies: ``base^(-2i/dim)`` blended towards
    ``base^(-2i/dim) / factor`` on a ramp from ``low = floor(corr(beta_fast))``
    to ``high = ceil(corr(beta_slow))``, ``corr(n) = dim ln(L0 / (2 pi n)) /
    (2 ln base)``; float64 rounded to float32."""
    L0, s = float(scaling["original_max_position_embeddings"]), float(scaling["factor"])

    def corr(n):
        return dim * math.log(L0 / (2 * math.pi * n)) / (2 * math.log(base))

    low = max(math.floor(corr(float(scaling["beta_fast"]))), 0)
    high = min(math.ceil(corr(float(scaling["beta_slow"]))), dim - 1)
    if high == low:
        high += 0.001
    out = []
    for i in range(dim // 2):
        ramp = min(1.0, max(0.0, (i - low) / (high - low)))
        f = base ** (-2.0 * i / dim)
        out.append(f * (1 - ramp) + f / s * ramp)
    return np.asarray(out, np.float64).astype(np.float32)


class Decoder:
    """The decoder over the weights ``W`` (``inputs_mla.weights``' leaves)."""

    def __init__(self, cfg: Mapping, W: Dict[str, torch.Tensor], precision: str = "fp32",
                 rope: str = "yarn", renormalize: bool = False):
        if precision not in ("fp32", "fp8"):
            raise ValueError("precision is fp32 or fp8, not %r" % precision)
        if rope not in ("yarn", "plain"):
            raise ValueError("rope is yarn or plain, not %r" % rope)
        if cfg.get("q_lora_rank"):
            raise ValueError("the query LoRA is not part of this reference")
        if float(cfg["routed_scaling_factor"]) != 1.0:
            raise ValueError("a routed scale other than 1 is not part of this reference")
        self.W = W
        self.L = int(cfg["num_hidden_layers"])
        self.H = int(cfg["num_attention_heads"])
        self.R = int(cfg["kv_lora_rank"])
        self.nope, self.rope_d = int(cfg["qk_nope_head_dim"]), int(cfg["qk_rope_head_dim"])
        self.dense = int(cfg["first_k_dense_replace"])
        self.top_k = int(cfg["num_experts_per_tok"])
        self.renormalize = renormalize or bool(cfg["norm_topk_prob"])
        self.eps = float(cfg["rms_norm_eps"])
        self.precision = precision
        base = float(cfg["rope_theta"])
        scaling = cfg.get("rope_scaling")
        self.scale = (self.nope + self.rope_d) ** -0.5
        if rope == "yarn" and scaling:
            self.inv_freq = yarn_inv_freq(scaling, self.rope_d, base)
            s = float(scaling["factor"])
            self.rotated = yarn_mscale(s, float(scaling["mscale"])) / yarn_mscale(
                s, float(scaling["mscale_all_dim"]))
            if scaling.get("mscale_all_dim"):
                self.scale *= yarn_mscale(s, float(scaling["mscale_all_dim"])) ** 2
        else:
            i = np.arange(0, self.rope_d, 2, dtype=np.float64)
            self.inv_freq = (base ** (-i / self.rope_d)).astype(np.float32)
            self.rotated = 1.0

    def leaf(self, name: str) -> torch.Tensor:
        return self.W[name].float()

    # -- operations -----------------------------------------------------------

    def _mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            a, w = fp8(a), fp8(w)
        return a @ w

    def _rms(self, x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * (1.0 + gain)

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x [B, S, h, rope_d], half rotation."""
        freqs = torch.from_numpy(self.inv_freq).to(x.device)
        ang = pos.float()[:, None] * freqs  # [S, rope_d / 2]
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1) * self.rotated

    def _mlp(self, h: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
             down: torch.Tensor) -> torch.Tensor:
        return self._mm(F.silu(self._mm(h, gate)) * self._mm(h, up), down)

    def attention(self, i: int, h: torch.Tensor) -> torch.Tensor:
        """Layer ``i``'s MLA over ``h`` [B, S, D] (normed), causal."""
        B, S, D = h.shape
        H, R, nope = self.H, self.R, self.nope
        lf = lambda n: self.leaf("layers.%d.%s" % (i, n))  # noqa: E731
        pos = torch.arange(S, device=h.device)
        q = self._mm(h, lf("w_q").reshape(D, -1)).reshape(B, S, H, -1)
        kv = self._mm(h, lf("w_dkv"))
        c = self._rms(kv[..., :R], lf("kv_norm"))
        k_pe = self._rope(kv[..., None, R:], pos)  # [B, S, 1, rope_d]
        q_nope, q_pe = q[..., :nope], self._rope(q[..., nope:], pos)
        k_nope = self._mm(c, lf("w_uk").reshape(R, -1)).reshape(B, S, H, nope)
        v = self._mm(c, lf("w_uv").reshape(R, -1)).reshape(B, S, H, -1)
        rows = []
        for b in range(B):
            parts = []
            for lo in range(0, S, Q_CHUNK):
                hi = min(S, lo + Q_CHUNK)
                s = (torch.einsum("chd,shd->hcs", q_nope[b, lo:hi], k_nope[b, :hi])
                     + torch.einsum("chd,sd->hcs", q_pe[b, lo:hi], k_pe[b, :hi, 0])) * self.scale
                qpos = torch.arange(lo, hi, device=h.device)[:, None]
                s = s.masked_fill(torch.arange(hi, device=h.device)[None, :] > qpos,
                                  float("-inf"))
                parts.append(torch.einsum("hcs,shv->chv", torch.softmax(s, dim=-1), v[b, :hi]))
            rows.append(torch.cat(parts, dim=0))
        o = torch.stack(rows).reshape(B, S, -1)
        return self._mm(o, lf("wo").reshape(-1, D))

    def route(self, i: int, h: torch.Tensor):
        """Layer ``i``'s router over ``h`` [T, D]: (weights, experts), [T, k]
        each."""
        probs = torch.softmax(h @ self.leaf("layers.%d.router" % i), dim=-1)
        w, idx = torch.topk(probs, self.top_k, dim=-1)
        if self.renormalize:
            return w / w.sum(-1, keepdim=True), idx
        return w, idx

    def experts(self, i: int, h: torch.Tensor, w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """The routed experts of layer ``i`` over ``h`` [T, D]: each expert
        runs every token routed to it, weighted, summed onto the token."""
        lf = lambda n: self.leaf("layers.%d.%s" % (i, n))  # noqa: E731
        gate, up, down = lf("e_gate"), lf("e_up"), lf("e_down")
        y = torch.zeros_like(h)
        for e in range(gate.shape[0]):
            tok, slot = torch.nonzero(idx == e, as_tuple=True)
            if tok.numel():
                out = self._mlp(h[tok], gate[e], up[e], down[e])
                y.index_add_(0, tok, out * w[tok, slot][:, None])
        return y

    def moe(self, i: int, h: torch.Tensor) -> torch.Tensor:
        """Layer ``i``'s routed and shared experts over ``h`` [B, S, D]."""
        lf = lambda n: self.leaf("layers.%d.%s" % (i, n))  # noqa: E731
        flat = h.reshape(-1, h.shape[-1])
        w, idx = self.route(i, flat)
        y = self.experts(i, flat, w, idx) + self._mlp(flat, lf("s_gate"), lf("s_up"),
                                                      lf("s_down"))
        return y.reshape(h.shape)

    def block(self, i: int, x: torch.Tensor) -> torch.Tensor:
        lf = lambda n: self.leaf("layers.%d.%s" % (i, n))  # noqa: E731
        x = x + self.attention(i, self._rms(x, lf("norm1")))
        h = self._rms(x, lf("norm2"))
        if i < self.dense:
            return x + self._mlp(h, lf("w_gate"), lf("w_up"), lf("w_down"))
        return x + self.moe(i, h)

    def logits(self, tokens: torch.Tensor, first: Optional[int] = 0) -> torch.Tensor:
        """fp32 logits [B, S - first, V] of positions ``first`` on of
        ``tokens`` [B, S]."""
        x = self.leaf("embed")[tokens.long()]
        for i in range(self.L):
            x = self.block(i, x)
        x = self._rms(x[:, first:], self.leaf("final_norm"))
        return self._mm(x, self.leaf("unembed"))
