"""Plain PyTorch reference of the dense decoder the ``granite-3-2b``
configuration states: pre-norm blocks of grouped-query attention with
half-rotation RoPE and a SiLU-gated MLP, RMS norms that scale by 1 + gain,
tied embeddings, bf16 weights and activations, products accumulated in
fp32, norm statistics, RoPE, attention scores and softmax in fp32 with
TF32 off. The loss is the mean next-token NLL plus ``z_loss`` times the
mean squared log-partition; the optimizer is AdamW with global-norm
clipping and a cosine schedule, the update in fp32 rounded to bf16.

``precision="fp8"`` is the control: every product of an activation with a
weight (the projections, the MLP, the output projection) takes both
operands through float8 e4m3 with one scale a tensor, its gradient passed
straight through.

Activations are kept at each layer's input only; each layer is
recomputed in the backward, a batch row and 1024 queries of attention at
a time, so the reference fits beside nothing on one card.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LAYER_LEAVES = ("norm1", "wq", "wk", "wv", "wo", "norm2", "w_gate", "w_up", "w_down")
Q_CHUNK = 1024


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 at one scale (its absolute max
    onto 448), the gradient passed straight through."""
    d = t.detach()
    scale = d.abs().amax().float().clamp(min=1e-30) / 448.0
    q = ((d.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)
    return t + (q - d)


class Decoder:
    """The decoder over the weights ``W`` (``inputs.decoder_weights``'s
    stacked leaves), held as one tensor a layer and a leaf (views of
    ``W``'s storage)."""

    def __init__(self, cfg: Mapping, W: Dict[str, torch.Tensor], precision: str = "bf16"):
        if precision not in ("bf16", "fp8"):
            raise ValueError("precision is bf16 or fp8, not %r" % precision)
        self.L = int(cfg["num_hidden_layers"])
        self.D = int(cfg["hidden_size"])
        self.H = int(cfg["num_attention_heads"])
        self.K = int(cfg["num_key_value_heads"])
        self.Dh = int(cfg.get("head_dim") or self.D // self.H)
        self.eps = float(cfg["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])
        self.precision = precision
        self.leaves: Dict[str, torch.Tensor] = {
            "embed": W["embed"].detach(), "final_norm": W["final_norm"].detach()}
        for name in LAYER_LEAVES:
            for i, t in enumerate(W[name].unbind(0)):
                self.leaves["layers.%d.%s" % (i, name)] = t.detach()

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        return {n: self.leaves["layers.%d.%s" % (i, n)] for n in LAYER_LEAVES}

    # -- operations -----------------------------------------------------------

    def _mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            a, w = fp8(a), fp8(w)
        return a @ w

    def _rms(self, x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        normed = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (normed * (1.0 + gain.float())).to(x.dtype)

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        dh = x.shape[-1]
        freqs = 1.0 / (self.theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                                   device=x.device) / dh))
        ang = pos.float()[:, None] * freqs  # [S, Dh/2]
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x.float().chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)

    def _attention(self, q, k, v) -> torch.Tensor:
        """Causal grouped-query attention, [B, S, H, Dh] from q [B, S, H,
        Dh] and k, v [B, S, K, Dh]: query head h reads KV head h // (H / K)."""
        B, S = q.shape[:2]
        G = self.H // self.K
        scale = 1.0 / math.sqrt(self.Dh)
        rows = []
        for b in range(B):
            parts = []
            for lo in range(0, S, Q_CHUNK):
                hi = min(S, lo + Q_CHUNK)
                qc = q[b, lo:hi].float().reshape(hi - lo, self.K, G, self.Dh)
                kk, vv = k[b, :hi], v[b, :hi]
                s = torch.einsum("ckgd,skd->kgcs", qc, kk.float()) * scale
                qpos = torch.arange(lo, hi, device=q.device)[:, None]
                kpos = torch.arange(hi, device=q.device)[None, :]
                s = s.masked_fill(kpos > qpos, float("-inf"))
                p = torch.softmax(s, dim=-1).to(v.dtype)
                o = torch.einsum("kgcs,skd->ckgd", p, vv)
                parts.append(o.reshape(hi - lo, self.H, self.Dh))
            rows.append(torch.cat(parts, dim=0))
        return torch.stack(rows)

    def _block(self, x: torch.Tensor, i: int) -> torch.Tensor:
        p = self.layer(i)
        B, S, D = x.shape
        H, K, Dh = self.H, self.K, self.Dh
        pos = torch.arange(S, device=x.device)
        h = self._rms(x, p["norm1"])
        q = self._mm(h, p["wq"].reshape(D, H * Dh)).reshape(B, S, H, Dh)
        k = self._mm(h, p["wk"].reshape(D, K * Dh)).reshape(B, S, K, Dh)
        v = self._mm(h, p["wv"].reshape(D, K * Dh)).reshape(B, S, K, Dh)
        o = self._attention(self._rope(q, pos), self._rope(k, pos), v)
        x = x + self._mm(o.reshape(B, S, H * Dh), p["wo"].reshape(H * Dh, D))
        h2 = self._rms(x, p["norm2"])
        g = self._mm(h2, p["w_gate"])
        u = self._mm(h2, p["w_up"])
        return x + self._mm(F.silu(g) * u, p["w_down"])

    def logits(self, tokens: torch.Tensor, *, remat: bool = False) -> torch.Tensor:
        """bf16 logits [B, S, V] of every position of ``tokens`` [B, S]."""
        x = self.leaves["embed"][tokens.long()]
        for i in range(self.L):
            if remat:
                x = checkpoint(self._block, x, i, use_reentrant=False)
            else:
                x = self._block(x, i)
        x = self._rms(x, self.leaves["final_norm"])
        return self._mm(x, self.leaves["embed"].t())

    def loss(self, tokens: torch.Tensor, z_loss: float) -> torch.Tensor:
        """Mean next-token NLL of ``tokens`` [B, S + 1] plus ``z_loss`` x the
        mean squared log-partition."""
        logits = self.logits(tokens[:, :-1], remat=True).float()
        labels = tokens[:, 1:].long()
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, labels[..., None])[..., 0]
        return (lse - picked).mean() + z_loss * lse.square().mean()


def lr_at(opt: Mapping, step: int) -> float:
    """Linear warmup to ``peak_lr``, then cosine decay to
    ``end_lr_fraction`` of it at ``total_steps``."""
    peak, warm = float(opt["peak_lr"]), int(opt["warmup_steps"])
    if step < warm:
        return peak * step / max(1, warm)
    frac = min(1.0, max(0.0, (step - warm) / max(1, int(opt["total_steps"]) - warm)))
    end = float(opt["end_lr_fraction"])
    return peak * (end + (1 - end) * 0.5 * (1 + math.cos(math.pi * frac)))


def train(model: Decoder, batches: Sequence[torch.Tensor], opt: Mapping,
          leaves: Optional[List[str]] = None) -> Dict[str, object]:
    """AdamW over ``batches`` (one a step). Returns each step's loss, each
    leaf's first gradient as the optimizer takes it (clipped) by its norm,
    and each leaf's change after the last step by its norm."""
    names = sorted(model.leaves)
    params = [model.leaves[n].requires_grad_(True) for n in names]
    first = {n: p.detach().clone() for n, p in zip(names, params)}
    m = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
    v = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
    b1, b2, eps = float(opt["b1"]), float(opt["b2"]), float(opt["eps"])
    wd, clip = float(opt["weight_decay"]), float(opt["clip_norm"])
    no_decay = set(opt.get("no_decay", ()))
    losses, grad_norms = [], {}
    for step, tokens in enumerate(batches, start=1):
        loss = model.loss(tokens, float(opt["z_loss"]))
        grads = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
            lr = lr_at(opt, step)
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for n, p, g, mm, vv in zip(names, params, grads, m, v):
                gf = g.float() * scale
                mm.mul_(b1).add_((1 - b1) * gf)
                vv.mul_(b2).add_((1 - b2) * gf.square())
                delta = (mm / bc1) / (torch.sqrt(vv / bc2) + eps)
                if wd and n not in no_decay:
                    delta = delta + wd * p.float()
                p.copy_((p.float() - lr * delta).to(p.dtype))
                if step == 1:
                    grad_norms[n] = float(mm.norm() / (1 - b1))
        del grads, loss
    with torch.no_grad():
        change = {n: float((p.float() - first[n].float()).norm()) for n, p in zip(names, params)}
    for p in params:
        p.requires_grad_(False)
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
