"""Unified model facade: one module per architecture, exposing

    init / abstract / logical                  (parameters)
    loss(batch)                                (train forward + CE)
    prefill(batch)                             (logits + per-layer cache tensors)
    decode_step(tokens, caches, cache_pos)     (caches updated in place)

The counterpart of ``repro.models.model``. A model holds its parameters
(an ``nn.Module``), where the JAX facade takes a parameter tree per call;
``param_tree()`` gives them as the JAX package's tree (for the optimizer
and the checkpoint). Each entry point takes ``ctx``
(``transformer.ModelContext``): off a mesh (None) the model runs on one
device; on a mesh its parameters and inputs are this rank's blocks
(``train.train_step.place_model``) and the loss and its metrics are the
global batch's. Families: dense / moe / hybrid / vlm ->
``Model`` over ``transformer.py`` (vlm with prefix embeddings); ssm
(xLSTM) -> ``XLSTMModel`` over ``xlstm.py``; audio (Whisper) ->
``EncDecModel`` over ``encdec.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..distributed import collectives
from ..distributed.sharding import axis_index, constrain
from ..kernels._build import resolve_device
from . import encdec, transformer, xlstm
from .layers import ParamDef, ParamTree, abstract_tree, logical_tree, rms_norm, stack_defs, tree_map
from .transformer import ModelContext


def cross_entropy(
    logits: torch.Tensor,  # [B, S, V]
    labels: torch.Tensor,  # [B, S] int; negative = masked
    *,
    z_loss: float = 1e-4,
    ctx: Optional[ModelContext] = None,
    vocab: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token NLL over the unmasked labels, in fp32, plus the
    ``z_loss`` term on the log-partition.

    With ``ctx`` on a mesh, ``logits`` are this rank's rows and, when the
    vocabulary (``vocab``) shards over ``model``, its columns (the fp32 logits stay on
    the ("batch", None, "vocab") layout: the log-partition takes a max and
    a sum over ``model``, the label's logit a masked pick summed over
    ``model``); the sums over the rows run over the DP axes, forward only,
    so each rank's gradient is its rows' share of the global loss's.
    """
    mask = (labels >= 0).float()
    safe = labels.clamp(min=0).long()
    lf = logits.float()
    mesh = ctx.mesh if ctx is not None else None
    if mesh is None:
        lse = torch.logsumexp(lf, dim=-1)
        picked = lf.gather(-1, safe[..., None])[..., 0]
        nll = (lse - picked) * mask
        denom = mask.sum().clamp(min=1.0)
        loss = nll.sum() / denom
        metrics = {"nll": loss, "tokens": denom}
        if z_loss:
            zl = z_loss * (lse.square() * mask).sum() / denom
            loss = loss + zl
            metrics["z_loss"] = zl
        return loss, metrics
    lf = constrain(lf, ctx.rules, "batch", None, "vocab")
    if vocab is not None and lf.shape[-1] < vocab:
        from torch.distributed import ReduceOp

        v_l = lf.shape[-1]
        m = collectives.all_reduce_(lf.detach().amax(-1, keepdim=True), mesh, "model",
                                    op=ReduceOp.MAX)
        lse = m[..., 0] + torch.log(collectives.psum(torch.exp(lf - m).sum(-1), mesh, "model"))
        rel = safe - axis_index(mesh, "model") * v_l
        ok = (rel >= 0) & (rel < v_l)
        picked = lf.gather(-1, rel.clamp(0, v_l - 1)[..., None])[..., 0]
        picked = collectives.psum(torch.where(ok, picked, 0.0), mesh, "model")
    else:
        lse = torch.logsumexp(lf, dim=-1)
        picked = lf.gather(-1, safe[..., None])[..., 0]
    rows = ctx.batch_axes
    nll = (lse - picked) * mask
    denom = collectives.all_reduce_(mask.sum(), mesh, *rows).clamp(min=1.0)
    loss = collectives.psum(nll.sum(), mesh, *rows) / denom
    metrics = {"nll": loss, "tokens": denom}
    if z_loss:
        zl = z_loss * collectives.psum((lse.square() * mask).sum(), mesh, *rows) / denom
        loss = loss + zl
        metrics["z_loss"] = zl
    return loss, metrics


# ---------------------------------------------------------------------------
# declarations of every family
# ---------------------------------------------------------------------------

def _xlstm_defs(cfg: ModelConfig):
    V, D, H = cfg.vocab_size, cfg.d_model, cfg.n_heads
    every = max(1, cfg.slstm_every)
    n_groups = cfg.n_layers // every
    n_m = every - 1
    return {
        "embed": ParamDef((V, D), ("vocab", "embed"), scale=D ** -0.5),
        "final_norm": ParamDef((D,), ("embed",), init="zeros"),
        "unembed": ParamDef((D, V), ("embed", "vocab")),
        # groups of (every-1) mLSTM blocks + 1 sLSTM block
        "mlstm": stack_defs(xlstm.mlstm_defs(n_m, D, H), n_groups),
        "slstm": stack_defs(xlstm.slstm_defs(0, D, H), n_groups),
    }


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter declarations of ``cfg``'s family, layers stacked."""
    if cfg.family == "ssm":
        return _xlstm_defs(cfg)
    if cfg.family == "audio":
        return encdec.encdec_defs(cfg)
    return transformer.decoder_defs(cfg)


# ---------------------------------------------------------------------------
# the facade every family shares
# ---------------------------------------------------------------------------

class _Facade(ParamTree):
    """A model on one device: its parameters (allocated, not yet
    initialized: call ``init`` or load them, ``convert.params_from_jax``)
    and the four entry points of the JAX package's ``Model``."""

    def __init__(self, cfg: ModelConfig, device, stacked):
        super().__init__(model_defs(cfg), device, stacked=stacked)
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self["embed"].device

    def init(self, generator: torch.Generator) -> "_Facade":
        """Draw every parameter as the JAX package's ``ParamDef.initialize``
        does (normal x scale or 1/sqrt(fan_in), zeros, ones), from
        ``generator``, which lies on this model's device."""
        self.assign(self.defs, lambda d, path: d.initialize(generator, self.device))
        return self

    def abstract(self) -> Any:
        return abstract_tree(self.defs)

    def logical(self) -> Any:
        return logical_tree(self.defs)


# ---------------------------------------------------------------------------
# decoder-only families (dense / moe / hybrid / vlm)
# ---------------------------------------------------------------------------

class Model(_Facade):
    """A decoder: ``transformer.forward`` in its three modes."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__(cfg, device, tuple(name for name, _ in transformer.STACKS))

    def _prefix(self, batch) -> Optional[torch.Tensor]:
        return batch["patches"] if self.cfg.family == "vlm" else None

    def logits(self, batch, ctx: Optional[ModelContext] = None) -> torch.Tensor:
        """Train-mode (teacher-forced) logits of every position of
        ``batch["tokens"]``."""
        prefix = self._prefix(batch)
        logits = transformer.forward(self.cfg, self, batch["tokens"], mode="train",
                                     prefix_embeds=prefix, ctx=ctx)[0]
        return logits if prefix is None else logits[:, prefix.shape[1] :]

    def loss(self, batch, ctx: Optional[ModelContext] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        prefix = self._prefix(batch)
        logits, aux, _ = transformer.forward(
            self.cfg, self, inputs, mode="train", prefix_embeds=prefix, ctx=ctx
        )
        if prefix is not None:
            logits = logits[:, prefix.shape[1] :]
        ce, metrics = cross_entropy(logits, labels, ctx=ctx, vocab=self.cfg.vocab_size)
        total = ce + 0.01 * aux
        metrics["aux_loss"] = aux
        return total, metrics

    def prefill(self, batch, ctx: Optional[ModelContext] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        logits, _, caches = transformer.forward(
            self.cfg, self, batch["tokens"], mode="prefill", prefix_embeds=self._prefix(batch),
            ctx=ctx,
        )
        return logits[:, -1:], caches

    def decode_step(self, tokens, caches, cache_pos: int, ctx: Optional[ModelContext] = None
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        logits, _, caches = transformer.forward(
            self.cfg, self, tokens, mode="decode", caches=caches, cache_pos=cache_pos, ctx=ctx
        )
        return logits, caches

    def init_decode_caches(self, batch: int, max_len: int, device=None) -> Dict[str, Any]:
        return transformer.init_caches(self.cfg, batch, max_len,
                                       device=self.device if device is None else device)


# ---------------------------------------------------------------------------
# xLSTM (ssm family)
# ---------------------------------------------------------------------------

class XLSTMModel(_Facade):
    """Groups of ``slstm_every - 1`` mLSTM blocks and one sLSTM block.
    Train mode runs the mLSTM's parallel form (S <= 256), prefill its
    chunkwise form and returns every block's state, decode its recurrent
    step, writing the states in place. The caches: ``{"m": {"c", "n",
    "m"} [G, L, B, ...], "s": (c, n, m, h) [G, B, H, Dh]}``. On a mesh the
    blocks run on this rank's ``ssm_inner`` blocks (``xlstm.py``), the
    embedding and the logits on its vocabulary rows, as the decoders'
    do."""

    def __init__(self, cfg: ModelConfig, device):
        n_m = max(1, cfg.slstm_every) - 1
        super().__init__(cfg, device, {"mlstm": 2 if n_m else 1, "slstm": 1})
        self.n_m = n_m

    def _run(self, tokens, *, mode: str, caches=None, ctx: Optional[ModelContext] = None):
        cfg = self.cfg
        mesh = ctx.mesh if ctx is not None and ctx.tp > 1 else None
        x = transformer.sharded_embed_lookup(ctx, self["embed"], tokens, cfg.vocab_size)
        want_state = mode != "train"
        m_states, s_states = [], []
        for g, (p_m, p_s) in enumerate(zip(self["mlstm"], self["slstm"])):
            group_m = []
            for j in range(self.n_m):
                cache = None
                if mode == "decode":
                    cache = {k: v[g, j] for k, v in caches["m"].items()}
                x, st = xlstm.mlstm_block(p_m[j], x, cfg.n_heads, state=cache,
                                          return_state=want_state, mesh=mesh)
                if mode == "decode":
                    for k, v in st.items():
                        cache[k].copy_(v)
                group_m.append(st)
            cache = tuple(v[g] for v in caches["s"]) if mode == "decode" else None
            x, st = xlstm.slstm_block(p_s, x, cfg.n_heads, state=cache, return_state=want_state,
                                      mesh=mesh)
            if mode == "decode":
                for dst, v in zip(cache, st):
                    dst.copy_(v)
            m_states.append(group_m)
            s_states.append(st)
        x = rms_norm(x, self["final_norm"])
        logits = transformer.unembed(cfg, self, x, ctx)
        if mode == "prefill":
            caches = {"s": tuple(torch.stack([st[i] for st in s_states]) for i in range(4))}
            if self.n_m:
                caches["m"] = {k: torch.stack([torch.stack([st[k] for st in group])
                                               for group in m_states])
                               for k in ("c", "n", "m")}
        return logits, caches

    def logits(self, batch, ctx: Optional[ModelContext] = None) -> torch.Tensor:
        """Train-mode (teacher-forced) logits of every position of
        ``batch["tokens"]`` (on a mesh, this rank's vocabulary columns when
        the vocabulary shards over ``model``)."""
        return self._run(batch["tokens"], mode="train", ctx=ctx)[0]

    def loss(self, batch, ctx: Optional[ModelContext] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        tokens = batch["tokens"]
        return cross_entropy(self.logits({"tokens": tokens[:, :-1]}, ctx), tokens[:, 1:],
                             ctx=ctx, vocab=self.cfg.vocab_size)

    def prefill(self, batch, ctx: Optional[ModelContext] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        logits, caches = self._run(batch["tokens"], mode="prefill", ctx=ctx)
        return logits[:, -1:], caches

    def decode_step(self, tokens, caches, cache_pos: int, ctx: Optional[ModelContext] = None
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        return self._run(tokens, mode="decode", caches=caches, ctx=ctx)

    def init_decode_caches(self, batch: int, max_len: int, device=None) -> Dict[str, Any]:
        cfg = self.cfg
        device = self.device if device is None else device
        n_groups = cfg.n_layers // max(1, cfg.slstm_every)
        dtype = torch.float64 if cfg.dtype == torch.float64 else torch.float32  # the states'
        m_state = xlstm.init_mlstm_state(batch, cfg.d_model, cfg.n_heads, device=device,
                                         dtype=dtype)
        s_state = xlstm.init_slstm_state(batch, cfg.d_model, cfg.n_heads, device=device,
                                         dtype=dtype)
        caches = {"s": tuple(t[None].expand((n_groups,) + t.shape).clone() for t in s_state)}
        if self.n_m:
            caches["m"] = tree_map(
                lambda t: t[None, None].expand((n_groups, self.n_m) + t.shape).clone(), m_state)
        return caches


# ---------------------------------------------------------------------------
# Whisper (audio family)
# ---------------------------------------------------------------------------

class EncDecModel(_Facade):
    """The encoder over ``batch["frames"]``, then the decoder stack. The
    caches: ``{"attn": {"k", "v"}, "cross_k", "cross_v"}``, each
    ``[L, B, ...]``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__(cfg, device, ("encoder", "decoder"))

    def logits(self, batch, ctx: Optional[ModelContext] = None) -> torch.Tensor:
        """Train-mode (teacher-forced) logits of every position of
        ``batch["tokens"]``, after encoding ``batch["frames"]``."""
        enc = encdec.encode(self.cfg, self, batch["frames"], ctx)
        return encdec.decode_stack(self.cfg, self, batch["tokens"], enc, mode="train",
                                   ctx=ctx)[0]

    def loss(self, batch, ctx: Optional[ModelContext] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        tokens = batch["tokens"]
        logits = self.logits({"tokens": tokens[:, :-1], "frames": batch["frames"]}, ctx)
        return cross_entropy(logits, tokens[:, 1:], ctx=ctx, vocab=self.cfg.vocab_size)

    def prefill(self, batch, ctx: Optional[ModelContext] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        enc = encdec.encode(self.cfg, self, batch["frames"], ctx)
        logits, caches = encdec.decode_stack(self.cfg, self, batch["tokens"], enc, mode="prefill",
                                             ctx=ctx)
        return logits[:, -1:], caches

    def decode_step(self, tokens, caches, cache_pos: int, ctx: Optional[ModelContext] = None
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        return encdec.decode_stack(self.cfg, self, tokens, None, mode="decode", caches=caches,
                                   cache_pos=cache_pos, ctx=ctx)

    def init_decode_caches(self, batch: int, max_len: int, device=None) -> Dict[str, Any]:
        return encdec.init_decoder_caches(self.cfg, batch, max_len, self.cfg.encoder_frames,
                                          device=self.device if device is None else device)


FAMILIES = {"ssm": XLSTMModel, "audio": EncDecModel}


def build_model(cfg: ModelConfig, device="cuda") -> _Facade:
    """``cfg``'s model with its parameters allocated on ``device``: the card
    by default (raises without one), ``"cpu"`` on request, or ``"meta"``
    (shapes only)."""
    dev = torch.device(device)
    return FAMILIES.get(cfg.family, Model)(cfg, dev if dev.type == "meta" else resolve_device(dev))
