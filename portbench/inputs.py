"""The inputs every cell makes from ``--seed``, and hands alike to the
program and to the reference: base64 text and its gzip, prompts, and a
decoder's weights.

Each input draws from its own stream of the seed (``stream``), so adding
an input never changes another. Nothing here imports the program.
"""

from __future__ import annotations

import base64
import gzip
import math
import zlib
from typing import Dict, Mapping

import numpy as np


def stream(seed: int, name: str, *more: int) -> np.random.SeedSequence:
    """The seed sequence of one named input of a run."""
    return np.random.SeedSequence([int(seed), zlib.crc32(name.encode()), *map(int, more)])


def base64_text(seq: np.random.SeedSequence, nbytes: int, columns: int = 76) -> bytes:
    """``nbytes`` of base64 of uniformly random bytes, in lines of
    ``columns`` characters as base64(1) writes them (76 is the only width
    the standard library writes)."""
    if columns != 76:
        raise ValueError("base64 lines are 76 columns wide, not %d" % columns)
    raw = np.random.default_rng(seq).integers(0, 256, nbytes * 3 // 4 + 64, dtype=np.uint8)
    text = base64.encodebytes(raw.tobytes())[:nbytes]
    if len(text) != nbytes:
        raise ValueError("could not make %d bytes of base64" % nbytes)
    return text


def gzip_member(data: bytes, level: int) -> bytes:
    """``data`` as one gzip member (no name, mtime 0, so the bytes are a
    function of the data and the level)."""
    return gzip.compress(data, compresslevel=level, mtime=0)


# ---------------------------------------------------------------------------
# a dense decoder's weights, made on the device
# ---------------------------------------------------------------------------

#: The leaves in the order they are drawn, each stacked over the layers
#: ([L, ...]) but the embedding and the final norm.
WEIGHT_ORDER = ("embed", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                "norm1", "norm2", "final_norm")
#: Each layer's output projections, scaled by 1 / sqrt(2 L).
OUTPUT_PROJECTIONS = ("wo", "w_down")


def weight_shapes(cfg: Mapping) -> Dict[str, tuple]:
    L, D = int(cfg["num_hidden_layers"]), int(cfg["hidden_size"])
    H, K = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    Dh = int(cfg.get("head_dim") or D // H)
    F, V = int(cfg["intermediate_size"]), int(cfg["vocab_size"])
    return {
        "embed": (V, D), "wq": (L, D, H, Dh), "wk": (L, D, K, Dh), "wv": (L, D, K, Dh),
        "wo": (L, H, Dh, D), "w_gate": (L, D, F), "w_up": (L, D, F), "w_down": (L, F, D),
        "norm1": (L, D), "norm2": (L, D), "final_norm": (D,),
    }


def decoder_weights(cfg: Mapping, seed: int, device, names=WEIGHT_ORDER) -> Dict:
    """The decoder's weights in bf16 on ``device``, drawn from one
    ``torch.Generator`` there, a call a leaf: normal with the
    configuration's ``initializer_range``, the output projections of each
    block scaled by 1 / sqrt(2 L) (GPT-2, Megatron-LM), the norms' gains
    zero (the program and the reference scale by 1 + gain). ``names``
    picks leaves; every leaf is drawn, so a leaf's values do not depend on
    which others are asked for."""
    import torch

    shapes = weight_shapes(cfg)
    std = float(cfg["initializer_range"])
    out_scale = 1.0 / math.sqrt(2 * int(cfg["num_hidden_layers"]))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(stream(seed, "weights").generate_state(1, np.uint64)[0]) >> 1)
    out = {}
    for name in WEIGHT_ORDER:
        shape = shapes[name]
        if name in ("norm1", "norm2", "final_norm"):
            if name in names:
                out[name] = torch.zeros(shape, dtype=torch.bfloat16, device=device)
            continue
        scale = std * (out_scale if name in OUTPUT_PROJECTIONS else 1.0)
        draw = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        if name in names:
            out[name] = draw.mul_(scale).to(torch.bfloat16)
        del draw
    return out
