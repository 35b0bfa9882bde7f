"""The benchmark's frozen arithmetic for a DeepSeek-V2 decoder's decode
step (latent attention in its absorbed form, routed and shared experts),
counted from the configuration's shapes alone, as ``arith.py`` counts a
dense decoder's: each input byte read once, each output byte written once,
and the FLOPs the algorithm needs. Every weight is bf16 (2 bytes), as
published. Nothing here imports the program.
"""

from __future__ import annotations

from typing import Mapping

from .arith import HBM_BYTES_PER_S, PEAK_BF16_FLOPS
from .inputs_mla import dims, param_count

BF16 = 2


def latent_bytes_per_position(cfg: Mapping) -> int:
    """One position's latent cache over every layer: ``kv_lora_rank`` +
    ``qk_rope_head_dim`` values a layer, bf16."""
    m = dims(cfg)
    return m["L"] * (m["R"] + m["rope"]) * BF16


def active_matmul_weights(cfg: Mapping) -> int:
    """The weights one token multiplies in a decode step outside absorbed
    attention: each layer's query, latent and output projections, its dense
    MLP or its router, ``num_experts_per_tok`` routed experts and the
    shared ones, and the output projection. (``W_uk`` and ``W_uv`` enter
    through ``absorbed_attention_flops``.)"""
    m = dims(cfg)
    D, H = m["D"], m["H"]
    attn = D * H * (m["nope"] + m["rope"]) + D * (m["R"] + m["rope"]) + H * m["v"] * D
    dense = 3 * D * m["F"]
    moe = D * m["E"] + 3 * D * m["Fe"] * (m["k"] + m["Es"])
    return (m["L"] * attn + m["dense"] * dense + (m["L"] - m["dense"]) * moe
            + D * m["V"])


def absorbed_attention_flops(cfg: Mapping, pos: int) -> float:
    """One sequence's absorbed MLA in one layer with its new token at
    ``pos``: ``W_uk`` into the query, the scores over ``pos + 1`` latent and
    rope keys, the weighted latents, and ``W_uv`` out:
    ``2 H (nope R + (pos + 1) (R + rope + R) + R v)``."""
    m = dims(cfg)
    R = m["R"]
    return 2.0 * m["H"] * (m["nope"] * R + (pos + 1) * (R + m["rope"] + R) + R * m["v"])


def decode_step_flops(cfg: Mapping, batch: int, pos: int) -> float:
    """2 FLOPs a weight a token for the products, plus absorbed attention in
    every layer, for ``batch`` sequences whose new token sits at ``pos``."""
    m = dims(cfg)
    return batch * (2.0 * active_matmul_weights(cfg)
                    + m["L"] * absorbed_attention_flops(cfg, pos))


def decode_step_bytes(cfg: Mapping, batch: int, pos: int) -> float:
    """Every weight read once (all routed experts: at 96 sequences x 6
    pairs an expert goes without a pair with probability about 8e-5), each
    sequence's latent cache up to ``pos`` read once and its new position
    written, and the bf16 logits written."""
    m = dims(cfg)
    per_pos = latent_bytes_per_position(cfg)
    return (param_count(cfg) * BF16 + batch * (pos + 1) * per_pos + batch * per_pos
            + batch * m["V"] * BF16)


def decode_step_least_s(cfg: Mapping, batch: int, pos: int) -> float:
    """The larger of the step's FLOPs over the bf16 peak and its bytes over
    HBM bandwidth."""
    return max(decode_step_flops(cfg, batch, pos) / PEAK_BF16_FLOPS,
               decode_step_bytes(cfg, batch, pos) / HBM_BYTES_PER_S)


def expert_products_bytes(cfg: Mapping, pairs: int) -> int:
    """One MoE layer's grouped products over ``pairs`` token-slot pairs:
    every routed expert's gate, up and down weights read once, each pair's
    activation read once and its output written once (bf16)."""
    m = dims(cfg)
    return (m["E"] * 3 * m["D"] * m["Fe"] + 2 * pairs * m["D"]) * BF16


def moe_layers(cfg: Mapping) -> int:
    m = dims(cfg)
    return m["L"] - m["dense"]
