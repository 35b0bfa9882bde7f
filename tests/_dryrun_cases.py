"""Dry-run cases of repro_torch.launch.dryrun. A process holds one fake
group, whose world size is fixed when it starts, so the cases of one mesh
share a process (``tests/test_torch_dryrun.py`` runs one for each mesh,
one after the other); each process writes its results as JSON, by case.

    python tests/_dryrun_cases.py CASE[,CASE...] OUT
"""

from __future__ import annotations

import dataclasses
import json
import sys


def _granite(out: dict) -> None:
    """granite-3-2b train_4k on the 256-rank mesh at 2 layers: the counts,
    what the shardings say rank 0 holds, and the calibration to 4 layers
    against the direct count there."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.sharding import default_rules, spec_axes
    from repro_torch.launch import dryrun
    from repro_torch.models.layers import leaf_paths
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import opt_state_shardings, param_shardings

    mesh = dryrun.production_mesh(False, "cpu")
    rules = default_rules(mesh)
    shape = SHAPES["train_4k"]
    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=2)
    m = dryrun.run_step(cfg, shape, mesh, device="cpu")
    out["step"] = m
    out["cell"] = dryrun.cell_result(cfg, shape, m, 256)

    model = build_model(cfg, device="meta")
    p_sh = param_shardings(model, mesh, rules)
    o_sh = opt_state_shardings(model, mesh, rules)
    blocks, zero = 0, 0
    for path, d in leaf_paths(model.defs):
        p, o = p_sh, o_sh["m"]
        for k in path:
            p, o = p[k], o[k]
        n = 1
        for s in p.local_shape(d.shape):
            n *= s
        blocks += n * d.dtype.itemsize
        n = 1
        for s in o.local_shape(d.shape):
            n *= s
        blocks += 2 * n * 4  # m and v in fp32
        zero += "data" in spec_axes(o.spec) and "data" not in spec_axes(p.spec)
    rows = shape.global_batch // 16
    out["expected_argument_bytes"] = blocks + 4 + rows * (shape.seq_len + 1) * 4  # step, tokens
    out["zero1_leaves"] = zero

    cfg4 = dataclasses.replace(cfg, n_layers=4)
    out["calibrated"] = dryrun.calibrate(cfg4, shape, mesh, rules, 256, "cpu")
    direct = dryrun.run_step(cfg4, shape, mesh, device="cpu")
    out["direct4"] = {k: direct[k] for k in ("flops", "bytes")}
    out["direct4"]["wire"] = dryrun.collective_wire_bytes(direct["collectives"])["total"]


def _others(out: dict) -> None:
    """deepseek-moe-16b train_4k at smoke depth, an xLSTM cell and hymba's
    ring-cache decode cell, on the 256-rank mesh."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun

    mesh = dryrun.production_mesh(False, "cpu")
    cfg = get_config("deepseek-moe-16b")
    cfg = dataclasses.replace(cfg, n_layers=cfg.first_dense_layers + 1)
    m = dryrun.run_step(cfg, SHAPES["train_4k"], mesh, device="cpu")
    out["moe"] = dryrun.cell_result(cfg, SHAPES["train_4k"], m, 256)
    out["moe_collectives"] = m["collectives"]
    out["xlstm"] = dryrun.lower_cell("xlstm-350m", "decode_32k", multi_pod=False, device="cpu")
    out["hymba"] = dryrun.lower_cell("hymba-1.5b", "decode_32k", multi_pod=False, device="cpu")


def _multi(out: dict) -> None:
    """A whole cell on the 512-rank (pod, data, model) mesh."""
    from repro_torch.launch import dryrun

    out["cell"] = dryrun.lower_cell("granite-3-2b", "decode_32k", multi_pod=True, device="cpu")


CASES = {"granite": _granite, "others": _others, "multi": _multi}

if __name__ == "__main__":
    results: dict = {}
    for case in sys.argv[1].split(","):  # cases of one mesh share its fake group
        results[case] = {}
        CASES[case](results[case])
    with open(sys.argv[2], "w") as f:
        json.dump(results, f)
