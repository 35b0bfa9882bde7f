"""repro_torch.launch.dryrun on the CPU: rank 0's real step on fake
tensors over a fake process group of 256 or 512 ranks.

The cases run in processes of their own (``tests/_dryrun_cases.py``; a
process holds one fake group, one for the 256-rank mesh and one for the
512-rank mesh), one after another from a module fixture:

  * granite-3-2b train_4k on (data=16, model=16) at 2 layers: the
    argument bytes equal rank 0's blocks from ``param_shardings`` and
    ``opt_state_shardings`` plus its batch rows; the FLOPs equal this
    file's count from the config (the unembedding whole on each chip: its
    49 155 rows do not divide ``model``, and each chip computes the
    table's gradient for its 128 columns of ``d_model``; 8 KV heads do not divide 16, so
    rank 0 projects only the one KV head its 2 query heads read; ``dots``
    remat runs attention's two products again in the backward); ZeRO-1's reduce-scatter and
    all-gather over ``data`` are counted; the extrapolation from 1 and 2
    layers equals the direct count at 4 in FLOPs and wire bytes (bytes
    within 1e-4: which dim ZeRO-1 splits, and so which copies a step
    makes, depends on the depth; measured 2.3e-5);
  * deepseek-moe-16b train_4k at smoke depth runs, its EP all-to-alls
    counted; an xLSTM cell runs on (16, 16) (its ``ssm_inner`` leaves over
    ``model``), and so does hymba-1.5b decode_32k (its 1024-slot ring split
    64 a rank);
  * a cell on (pod=2, data=16, model=16);
  * a cell's keys are the JAX cell's, with ``run_s`` for ``lower_s`` and
    ``compile_s``, and ``fits_h100``;
  * the committed ``results/dryrun_torch.json``: 80 cells, per mesh 32 ok,
    8 skipped (the reasons ``repro.configs.shape_applicable`` gives, cell
    for cell), 0 unsupported, 0 errors.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import all_configs as jax_configs
from repro.configs import shape_applicable as jax_applicable
from repro_torch.configs import get_config
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
RESULTS = ROOT / "results" / "dryrun_torch.json"
#: The fields of a JAX cell (``repro/launch/dryrun.py``, ``lower_cell``).
JAX_CELL_KEYS = {"arch", "shape", "mesh", "kind", "status", "lower_s", "compile_s", "memory",
                 "cost", "collectives", "collective_counts", "roofline", "model_flops_total",
                 "model_flops_per_chip", "useful_flops_fraction", "n_chips"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The cases, one process after another: the cell runs are CPU-bound,
    and the other test workers' timing should not feel them."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = {}
    for cases in ("granite,others", "multi"):
        log = tmp / (cases + ".log")
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, str(ROOT / "tests" / "_dryrun_cases.py"), cases,
                                 str(tmp / (cases + ".json"))], env=env, stdout=f,
                                stderr=subprocess.STDOUT, timeout=300).returncode
        assert rc == 0, (cases, log.read_text()[-3000:])
        out.update(json.loads((tmp / (cases + ".json")).read_text()))
    return out


def _dense_train_flops(cfg, shape, data=16, model=16):
    """FLOPs per chip of a dense GQA decoder's train step, from its config:
    projections forward and backward (3x), attention's two products
    forward, again in the ``dots`` recompute, and backward (4x), the
    unembedding (3x). Heads split over ``model``; vocabulary only where it
    divides it, else each rank computes the table's gradient for its block
    of ``d_model`` (``transformer.wgrad_split``); KV heads where they
    divide it, else the KV heads rank 0's query heads read (it projects
    only those). Chunked causal attention: query block i reads the first
    (i + 1) * chunk keys."""
    t = shape.global_batch // data * shape.seq_len  # rank 0's tokens
    d, dh = cfg.d_model, cfg.resolved_head_dim
    heads = cfg.n_heads // model
    if cfg.n_kv_heads % model == 0:
        kv = cfg.n_kv_heads // model
    elif cfg.n_heads % model == 0:  # rank 0's query heads read the first KV heads
        kv = (heads - 1) // (cfg.n_heads // cfg.n_kv_heads) + 1
    else:
        kv = cfg.n_kv_heads
    ff = cfg.d_ff // model
    proj = 2 * t * d * (2 * heads * dh + 2 * kv * dh + 3 * ff)
    chunk = cfg.attn_q_chunk
    keys = sum(min(shape.seq_len, (i + 1) * chunk) for i in range(shape.seq_len // chunk))
    attn = 2 * 2 * (shape.global_batch // data) * heads * chunk * keys * dh
    if cfg.vocab_size % model == 0:
        unembed = 3 * 2 * t * d * (cfg.vocab_size // model)
    else:  # forward and input gradient whole, the table's gradient a block of d
        unembed = 2 * 2 * t * d * cfg.vocab_size + 2 * t * (d // model) * cfg.vocab_size
    return cfg.n_layers * (3 * proj + 4 * attn) + unembed


def test_argument_bytes_are_rank0_blocks(runs):
    g = runs["granite"]
    assert g["step"]["argument_size_in_bytes"] == g["expected_argument_bytes"]
    mem = g["cell"]["memory"]
    assert mem["argument_size_in_bytes"] == g["expected_argument_bytes"]
    assert mem["peak_bytes"] == mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    assert mem["temp_size_in_bytes"] > 0


def test_flops_match_the_config_count(runs):
    import dataclasses

    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=2)
    assert runs["granite"]["step"]["flops"] == _dense_train_flops(cfg, JAX_SHAPES["train_4k"])


def test_zero1_reduce_scatter_and_all_gather_over_data(runs):
    g = runs["granite"]
    by = {}
    for c in g["step"]["collectives"]:
        by.setdefault((c["kind"], c["axis"]), []).append(c["group"])
    assert len(by[("reduce-scatter", "data")]) == g["zero1_leaves"] > 0
    assert len(by[("all-gather", "data")]) >= g["zero1_leaves"]
    assert set(by[("reduce-scatter", "data")]) == {16}
    assert ("all-reduce", "model") in by  # the Megatron pairs' psums
    assert g["cell"]["collectives"]["reduce-scatter"] > 0


def test_calibration_equals_the_direct_count(runs):
    cal, direct = runs["granite"]["calibrated"], runs["granite"]["direct4"]
    assert cal["flops"] == direct["flops"]
    assert cal["wire"] == pytest.approx(direct["wire"], rel=1e-12)
    assert cal["bytes"] == pytest.approx(direct["bytes"], rel=1e-4)
    assert cal["roofline"]["flops"] == cal["flops"]


def test_moe_cell_runs_with_its_all_to_alls(runs):
    moe = runs["others"]["moe"]
    assert moe["status"] == "ok"
    assert moe["cost"]["flops"] > 0
    assert moe["collective_counts"]["all-to-all"] > 0
    assert {c["axis"] for c in runs["others"]["moe_collectives"]
            if c["kind"] == "all-to-all"} == {"data"}


def test_xlstm_cell_runs(runs):
    """xlstm-350m decode_32k on (16, 16): its ``ssm_inner`` leaves and its
    mLSTM states' ``Dk`` rows over ``model``, the contractions over ``Dk``
    summed there."""
    cell = runs["others"]["xlstm"]
    assert cell["status"] == "ok", cell.get("reason")
    assert cell["cost"]["flops"] > 0 and cell["fits_h100"]
    assert cell["collective_counts"]["all-reduce"] > 0


def test_hymba_ring_decode_cell_runs(runs):
    """hymba-1.5b decode_32k on (16, 16): 25 heads and 5 KV heads, neither
    of which divides 16, so its 1024-slot ring splits 64 a rank and decode
    is flash-decode over the slots."""
    cell = runs["others"]["hymba"]
    assert cell["status"] == "ok", cell.get("reason")
    assert cell["cost"]["flops"] > 0 and cell["fits_h100"]
    assert cell["collective_counts"]["all-reduce"] > 0


def test_cell_on_the_512_rank_mesh(runs):
    cell = runs["multi"]["cell"]
    assert cell["status"] == "ok"
    assert cell["mesh"] == "2x16x16" and cell["n_chips"] == 512
    assert cell["roofline"]["dominant"] in ("t_compute", "t_memory", "t_collective")


def test_cell_keys_are_the_jax_cells(runs):
    keys = set(runs["multi"]["cell"])
    assert keys == (JAX_CELL_KEYS - {"lower_s", "compile_s"}) | {"run_s", "fits_h100"}
    assert {"arch", "shape", "mesh", "kind"} | set(runs["granite"]["cell"]) == keys


@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
def test_skipped_cells_need_no_group(multi_pod):
    """A cell ``shape_applicable`` rules out returns before any mesh."""
    for arch, cfg in jax_configs().items():
        for name, shape in JAX_SHAPES.items():
            ok, reason = jax_applicable(cfg, shape)
            if not ok:
                cell = dryrun.lower_cell(arch, name, multi_pod=multi_pod, device="cpu")
                assert cell["status"] == "skipped" and cell["reason"] == reason


def test_dryrun_results_complete():
    """The committed sweep: 40 cells x 2 meshes, 0 errors."""
    d = json.loads(RESULTS.read_text())
    assert len(d) == 80
    for mesh, label in (("single", "16x16"), ("multi", "2x16x16")):
        cells = {k: v for k, v in d.items() if k.endswith("|" + mesh)}
        assert len(cells) == 40
        statuses = [c["status"] for c in cells.values()]
        assert statuses.count("ok") == 32
        assert statuses.count("unsupported") == 0
        assert statuses.count("skipped") == 8
        assert statuses.count("error") == 0
        for key, c in cells.items():
            arch, shape, _ = key.split("|")
            assert (c["arch"], c["shape"], c["mesh"]) == (arch, shape, label)
            ok, reason = jax_applicable(jax_configs()[arch], JAX_SHAPES[shape])
            assert (c["status"] == "skipped") == (not ok), key
            if not ok:
                assert c["reason"] == reason
            if c["status"] == "ok":
                assert {"memory", "cost", "roofline", "fits_h100"} <= set(c), key
                assert c["roofline"]["dominant"] in ("t_compute", "t_memory", "t_collective")
                assert c["memory"]["peak_bytes"] >= c["memory"]["argument_size_in_bytes"] > 0


def test_roofline_report_reads_the_port_file():
    """``benchmarks/roofline_report.py``'s ``report()``, unchanged, prints a
    row for each cell of the port's file."""
    code = ("from benchmarks.roofline_report import report\n"
            "for mesh in ('16x16', '2x16x16'):\n    report(%r, mesh=mesh)" % str(RESULTS))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    rows = [line for line in out.stdout.splitlines() if not line.startswith("arch,")]
    assert len(rows) == 80
