"""What the decoder drivers share: the program's configuration made from
the benchmark's file, the benchmark's weights put into the program's
model, the program's parameters named as the reference names them, and
the gaps that compare two sets of per-leaf norms."""

from __future__ import annotations

import statistics
from typing import Dict, Mapping

SMALL_MODEL = {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
               "num_key_value_heads": 2, "intermediate_size": 128, "vocab_size": 512,
               "attn_q_chunk": 16}  # the host tests' size of a decoder configuration

PROGRAM_LEAVES = {"norm1": ("norm1",), "norm2": ("norm2",), "wq": ("attn", "wq"),
                  "wk": ("attn", "wk"), "wv": ("attn", "wv"), "wo": ("attn", "wo"),
                  "w_gate": ("mlp", "w_gate"), "w_up": ("mlp", "w_up"),
                  "w_down": ("mlp", "w_down")}


def program_config(cfg: Mapping):
    """The program's ``ModelConfig`` of the benchmark's configuration."""
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(
        name="portbench-" + str(cfg["model_type"]), family="dense",
        n_layers=int(cfg["num_hidden_layers"]), d_model=int(cfg["hidden_size"]),
        n_heads=int(cfg["num_attention_heads"]), n_kv_heads=int(cfg["num_key_value_heads"]),
        d_ff=int(cfg["intermediate_size"]), vocab_size=int(cfg["vocab_size"]),
        activation=str(cfg["hidden_act"]), qkv_bias=bool(cfg["attention_bias"]),
        rope_theta=float(cfg["rope_theta"]), tie_embeddings=bool(cfg["tie_word_embeddings"]),
        remat_policy=str(cfg["remat_policy"]), attn_q_chunk=int(cfg["attn_q_chunk"]))


def named_leaves(tree) -> Dict:
    """A program tree (``param_tree()``, or a moment of the optimizer state
    laid out alike) as {reference name: tensor}."""
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    for name, path in PROGRAM_LEAVES.items():
        node = tree["layers"]
        for k in path:
            node = node[k]
        for i, t in enumerate(node):
            out["layers.%d.%s" % (i, name)] = t
    return out


def load_weights(model, W: Mapping) -> None:
    """The benchmark's stacked weights into the program's model."""
    import torch

    with torch.no_grad():
        for name, t in named_leaves(model.param_tree()).items():
            if name.startswith("layers."):
                _, i, leaf = name.split(".")
                t.copy_(W[leaf][int(i)])
            else:
                t.copy_(W[name])


def leaf_gaps(program: Mapping[str, float], reference: Mapping[str, float],
              keep=None) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger; ``keep`` names the leaves compared."""
    names = sorted(keep if keep is not None else reference)
    med = statistics.median(reference[n] for n in names)
    return {n: abs(program[n] - reference[n]) / max(reference[n], med, 1e-30) for n in names}


def norm_gap(program: Mapping[str, float], reference: Mapping[str, float],
             keep=None) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(program, reference, keep).values())


def median_gap(program: Mapping[str, float], reference: Mapping[str, float],
               keep=None) -> float:
    """The median leaf's gap (``leaf_gaps``)."""
    return statistics.median(leaf_gaps(program, reference, keep).values())


def moved_leaves(ref_grad_norms: Mapping[str, float]):
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's; the others move under Adam by round-off alone."""
    med = statistics.median(ref_grad_norms.values())
    return [n for n, g in ref_grad_norms.items() if g >= 1e-3 * med]
