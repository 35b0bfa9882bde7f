"""xLSTM parameter declarations (arXiv:2405.04517): mLSTM and sLSTM blocks.

The declarations of ``repro.models.xlstm``, so that
``ModelConfig.param_count`` counts the ``ssm`` family (xlstm-350m) as the
JAX package does. The blocks' compute is not ported yet: ROADMAP.md, queue
1, item 5 ports it, and until then ``build_model`` raises for this family.
"""

from __future__ import annotations

from typing import Any, Dict

from .layers import ParamDef

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
