"""The weights of a DeepSeek-V2 decoder (latent attention with a direct
query projection, a leading dense MLP, then routed and shared experts),
made on the device from ``--seed`` and handed alike to the program and to
the reference.

Leaves are named as the reference names them: ``embed``, ``unembed``
([D, V]), ``final_norm``, and ``layers.<i>.<leaf>`` for each layer's
``LAYER_LEAVES`` plus ``DENSE_LEAVES`` (the first
``first_k_dense_replace`` layers) or ``MOE_LEAVES``. Nothing here imports
the program.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, Mapping, Tuple

import numpy as np

from .inputs import stream

LAYER_LEAVES = ("norm1", "w_q", "w_dkv", "kv_norm", "w_uk", "w_uv", "wo", "norm2")
DENSE_LEAVES = ("w_gate", "w_up", "w_down")
MOE_LEAVES = ("router", "e_gate", "e_up", "e_down", "s_gate", "s_up", "s_down")
#: Gains of the RMS norms: drawn as zeros (the program and the reference
#: scale by 1 + gain).
NORMS = ("norm1", "kv_norm", "norm2", "final_norm")
#: Each block's output projections, scaled by 1 / sqrt(2 L).
OUTPUT_PROJECTIONS = ("wo", "w_down", "e_down", "s_down")


def dims(cfg: Mapping) -> Dict[str, int]:
    """The configuration's sizes under short names."""
    if cfg.get("q_lora_rank"):
        raise ValueError("the query LoRA (q_lora_rank %r) is not drawn here" % cfg["q_lora_rank"])
    return {
        "L": int(cfg["num_hidden_layers"]), "D": int(cfg["hidden_size"]),
        "H": int(cfg["num_attention_heads"]), "V": int(cfg["vocab_size"]),
        "F": int(cfg["intermediate_size"]), "Fe": int(cfg["moe_intermediate_size"]),
        "E": int(cfg["n_routed_experts"]), "Es": int(cfg["n_shared_experts"]),
        "k": int(cfg["num_experts_per_tok"]), "dense": int(cfg["first_k_dense_replace"]),
        "R": int(cfg["kv_lora_rank"]), "nope": int(cfg["qk_nope_head_dim"]),
        "rope": int(cfg["qk_rope_head_dim"]), "v": int(cfg["v_head_dim"]),
    }


def layer_shapes(cfg: Mapping, i: int) -> Dict[str, Tuple[int, ...]]:
    """Layer ``i``'s leaves and their shapes, in the order they are drawn."""
    m = dims(cfg)
    D, H, R = m["D"], m["H"], m["R"]
    out = {
        "norm1": (D,), "w_q": (D, H, m["nope"] + m["rope"]), "w_dkv": (D, R + m["rope"]),
        "kv_norm": (R,), "w_uk": (R, H, m["nope"]), "w_uv": (R, H, m["v"]),
        "wo": (H, m["v"], D), "norm2": (D,),
    }
    if i < m["dense"]:
        out.update(w_gate=(D, m["F"]), w_up=(D, m["F"]), w_down=(m["F"], D))
    else:
        E, Fe, Fs = m["E"], m["Fe"], m["Es"] * m["Fe"]
        out.update(router=(D, E), e_gate=(E, D, Fe), e_up=(E, D, Fe), e_down=(E, Fe, D),
                   s_gate=(D, Fs), s_up=(D, Fs), s_down=(Fs, D))
    return out


def shapes(cfg: Mapping) -> Iterator[Tuple[str, Tuple[int, ...]]]:
    """Every leaf's name and shape, in the order they are drawn: the
    embedding, each layer's leaves, the output projection, the final norm."""
    m = dims(cfg)
    yield "embed", (m["V"], m["D"])
    for i in range(m["L"]):
        for leaf, shape in layer_shapes(cfg, i).items():
            yield "layers.%d.%s" % (i, leaf), shape
    yield "unembed", (m["D"], m["V"])
    yield "final_norm", (m["D"],)


def param_count(cfg: Mapping) -> int:
    return sum(math.prod(shape) for _, shape in shapes(cfg))


def draw(cfg: Mapping, seed: int, device, put: Callable) -> None:
    """Each leaf in bf16 on ``device``, handed to ``put(name, tensor)`` as it
    is drawn (one leaf of one layer lives at a time), from one
    ``torch.Generator`` there, a call a leaf: normal with the
    configuration's ``initializer_range``, each block's output projections
    scaled by 1 / sqrt(2 L) (GPT-2, Megatron-LM), the norms' gains zero."""
    import torch

    std = float(cfg["initializer_range"])
    out_scale = 1.0 / math.sqrt(2 * dims(cfg)["L"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(stream(seed, "weights-mla").generate_state(1, np.uint64)[0]) >> 1)
    for name, shape in shapes(cfg):
        leaf = name.rsplit(".", 1)[-1]
        if leaf in NORMS:
            put(name, torch.zeros(shape, dtype=torch.bfloat16, device=device))
            continue
        scale = std * (out_scale if leaf in OUTPUT_PROJECTIONS else 1.0)
        t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        put(name, t.mul_(scale).to(torch.bfloat16))
        del t


def weights(cfg: Mapping, seed: int, device) -> Dict:
    """Every leaf (``draw``) in one dict."""
    out: Dict = {}
    draw(cfg, seed, device, out.__setitem__)
    return out
