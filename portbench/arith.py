"""The benchmark's frozen arithmetic: the card's peaks, and the work each
measured operation needs, counted from shapes alone.

Every count here is what the operation's inputs need, whatever code
computes it: each input byte read once, each output byte written once,
and a model's FLOPs as the algorithm needs them (remat's recompute not
counted). So a later change that replaces a kernel cannot push a share
above 100 %. Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

#: NVIDIA H100 SXM data sheet, dense bf16 tensor-core rate (FLOP/s).
PEAK_BF16_FLOPS = 989e12
#: NVIDIA H100 SXM data sheet, HBM3 bandwidth (bytes/s).
HBM_BYTES_PER_S = 3.35e12

#: Stage 2's marker replacement works on tiles of 8 x 1024 uint16 symbols;
#: a symbol resolves to one output byte through a table of 256 literals
#: and a 32 KiB window (33 024 bytes); each tile names its table (int32).
MARKER_TILE_SYMBOLS = 8 * 1024
MARKER_TABLE_BYTES = 33024
#: Stage 2's CRC launch holds B x 8 x 128 lanes of seg_len bytes and writes
#: one uint32 CRC a lane.
CRC_LANES = 8 * 128


def stage2_launch_bytes(key: Tuple, count: int = 1) -> int:
    """Bytes one stage-2 launch shape needs, times ``count``:
    ``("replace", tiles, tables)`` reads 2 bytes a symbol, each table and
    each tile's table id once, and writes a byte a symbol;
    ``("crc", batch, seg_len)`` reads every lane byte and writes a CRC a
    lane."""
    kind = key[0]
    if kind == "replace":
        _, tiles, tables = key
        symbols = tiles * MARKER_TILE_SYMBOLS
        return count * (2 * symbols + symbols + tables * MARKER_TABLE_BYTES + 4 * tiles)
    if kind == "crc":
        _, batch, seg_len = key
        lanes = batch * CRC_LANES
        return count * (lanes * seg_len + 4 * lanes)
    raise ValueError("unknown stage-2 launch kind %r" % (kind,))


def stage2_bytes(shapes: Mapping[Tuple, int]) -> int:
    """Bytes of every launch in ``shapes`` (launch shape -> count)."""
    return sum(stage2_launch_bytes(k, n) for k, n in shapes.items())


# ---------------------------------------------------------------------------
# decoder models (dense, grouped-query attention, gated MLP)
# ---------------------------------------------------------------------------

def _dims(cfg: Mapping) -> Dict[str, int]:
    d = int(cfg["hidden_size"])
    h = int(cfg["num_attention_heads"])
    return {
        "L": int(cfg["num_hidden_layers"]), "D": d, "H": h,
        "K": int(cfg["num_key_value_heads"]), "Dh": int(cfg.get("head_dim") or d // h),
        "F": int(cfg["intermediate_size"]), "V": int(cfg["vocab_size"]),
        "tied": bool(cfg["tie_word_embeddings"]),
    }


def layer_matmul_params(cfg: Mapping) -> int:
    """Weights of one layer that multiply an activation: q, k, v, o and the
    gated MLP's three."""
    m = _dims(cfg)
    attn = m["D"] * m["H"] * m["Dh"] * 2 + m["D"] * m["K"] * m["Dh"] * 2
    return attn + 3 * m["D"] * m["F"]


def param_count(cfg: Mapping) -> int:
    """Every parameter: the embedding (the output projection too, when
    tied), each layer's products and its two norms, the final norm."""
    m = _dims(cfg)
    per_layer = layer_matmul_params(cfg) + 2 * m["D"]
    out = 0 if m["tied"] else m["D"] * m["V"]
    return m["V"] * m["D"] + m["L"] * per_layer + m["D"] + out


def train_flops_per_token(cfg: Mapping, seq_len: int) -> float:
    """PaLM's appendix B: 6 N + 12 L H Dh T, N every parameter (the tied
    output projection included), T the sequence length; remat's
    recompute not counted."""
    m = _dims(cfg)
    return 6.0 * param_count(cfg) + 12.0 * m["L"] * m["H"] * m["Dh"] * seq_len


def decode_step_flops(cfg: Mapping, batch: int, pos: int) -> float:
    """One decode step of ``batch`` sequences whose new token sits at
    position ``pos`` (it attends to ``pos + 1`` keys): 2 FLOPs a weight a
    token for the layers' products and the output projection, and 4 H Dh
    a key a layer for the scores and the weighted values."""
    m = _dims(cfg)
    weights = m["L"] * layer_matmul_params(cfg) + m["D"] * m["V"]
    attn = 4.0 * m["L"] * m["H"] * m["Dh"] * (pos + 1)
    return batch * (2.0 * weights + attn)


def decode_step_bytes(cfg: Mapping, batch: int, pos: int, *, weight_bytes: int = 2,
                      cache_bytes: int = 2, logit_bytes: int = 2) -> float:
    """Bytes one decode step needs: every weight read once, each sequence's
    keys and values up to ``pos`` read once, its new key and value written
    once, and the logits written once."""
    m = _dims(cfg)
    kv_token = m["L"] * 2 * m["K"] * m["Dh"] * cache_bytes
    return (param_count(cfg) * weight_bytes + batch * (pos + 1) * kv_token
            + batch * kv_token + batch * m["V"] * logit_bytes)


def decode_step_least_s(cfg: Mapping, batch: int, pos: int) -> float:
    """The least time of one decode step on the card: the larger of its
    FLOPs over the bf16 peak and its bytes over HBM bandwidth."""
    return max(decode_step_flops(cfg, batch, pos) / PEAK_BF16_FLOPS,
               decode_step_bytes(cfg, batch, pos) / HBM_BYTES_PER_S)
