"""Unified model facade: one module per architecture, exposing

    init / abstract / logical                  (parameters)
    loss(batch)                                (train forward + CE)
    prefill(batch)                             (logits + per-layer cache tensors)
    decode_step(tokens, caches, cache_pos)     (caches updated in place)

The counterpart of ``repro.models.model``. The ``Model`` holds its
parameters (an ``nn.Module`` on one device), where the JAX facade takes a
parameter tree per call. Families: dense / moe / hybrid / vlm ->
``transformer.py`` (vlm with prefix embeddings). The ssm (xLSTM) and audio
(Whisper) families are declared (``model_defs``, so ``param_count`` counts
them) but do not run yet: ``build_model`` raises for them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels._build import resolve_device
from . import encdec, transformer, xlstm
from .layers import ParamDef, ParamTree, abstract_tree, logical_tree, stack_defs


def cross_entropy(
    logits: torch.Tensor,  # [B, S, V]
    labels: torch.Tensor,  # [B, S] int; negative = masked
    *,
    z_loss: float = 1e-4,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token NLL over the unmasked labels, in fp32, plus the
    ``z_loss`` term on the log-partition."""
    mask = (labels >= 0).float()
    safe = labels.clamp(min=0).long()
    lf = logits.float()
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
# decoder-only families (dense / moe / hybrid / vlm)
# ---------------------------------------------------------------------------

class Model(ParamTree):
    """A decoder on one device: its parameters (allocated, not yet
    initialized: call ``init`` or load them, ``convert.params_from_jax``)
    and the four entry points of the JAX package's ``Model``."""

    def __init__(self, cfg: ModelConfig, device):
        defs = transformer.decoder_defs(cfg)
        super().__init__(defs, device, stacked=tuple(name for name, _ in transformer.STACKS))
        self.cfg = cfg
        self.defs = defs

    @property
    def device(self) -> torch.device:
        return self["embed"].device

    def init(self, generator: torch.Generator) -> "Model":
        """Draw every parameter as the JAX package's ``ParamDef.initialize``
        does (normal x scale or 1/sqrt(fan_in), zeros, ones), from
        ``generator``, which lies on this model's device."""
        self.assign(self.defs, lambda d, path: d.initialize(generator, self.device))
        return self

    def abstract(self) -> Any:
        return abstract_tree(self.defs)

    def logical(self) -> Any:
        return logical_tree(self.defs)

    def _prefix(self, batch) -> Optional[torch.Tensor]:
        return batch["patches"] if self.cfg.family == "vlm" else None

    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        prefix = self._prefix(batch)
        logits, aux, _ = transformer.forward(
            self.cfg, self, inputs, mode="train", prefix_embeds=prefix
        )
        if prefix is not None:
            logits = logits[:, prefix.shape[1] :]
        ce, metrics = cross_entropy(logits, labels)
        total = ce + 0.01 * aux
        metrics["aux_loss"] = aux
        return total, metrics

    def prefill(self, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        logits, _, caches = transformer.forward(
            self.cfg, self, batch["tokens"], mode="prefill", prefix_embeds=self._prefix(batch)
        )
        return logits[:, -1:], caches

    def decode_step(self, tokens, caches, cache_pos: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
        logits, _, caches = transformer.forward(
            self.cfg, self, tokens, mode="decode", caches=caches, cache_pos=cache_pos
        )
        return logits, caches

    def init_decode_caches(self, batch: int, max_len: int, device=None) -> Dict[str, Any]:
        return transformer.init_caches(self.cfg, batch, max_len,
                                       device=self.device if device is None else device)


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """``cfg``'s model with its parameters allocated on ``device``: the card
    by default (raises without one), ``"cpu"`` on request, or ``"meta"``
    (shapes only)."""
    if cfg.family == "ssm":
        raise NotImplementedError(
            "%s: the ssm family (models/xlstm.py) is not ported yet; ROADMAP.md queue 1, "
            "item 5 ports it" % cfg.name)
    if cfg.family == "audio":
        raise NotImplementedError(
            "%s: the audio family (models/encdec.py) is not ported yet; ROADMAP.md queue 1, "
            "item 5 ports it" % cfg.name)
    dev = torch.device(device)
    return Model(cfg, dev if dev.type == "meta" else resolve_device(dev))
