"""``tools/dryrun_xcheck.py``: the port's dry-run held against the JAX
package's compiled program.

  * The HLO dot counter, on modules compiled on 8 host devices in a process
    of their own (``tests/_xcheck_cases.py``; JAX fixes its device count at
    its first import), against hand counts per device of the (2, 4) mesh:
    a 2-D product (x [64, 32] rows over data, w [32, 16] columns over
    model: [32, 4] x 32, 8192), a batched one ([4, 8, 16] x [4, 16, 32],
    batch over data, k over model: [2, 8, 8] x 16, 4096), a hand-written
    module whose dot sits in a fused computation called twice (its
    operands bare names, their shapes on the ``parameter`` lines: 2 x
    1024), and the gradient of a bf16 ``tanh(einsum("btd,df->btf"))``
    w.r.t. ``w`` (131 072; ``cost_analysis()`` counts the elementwise work
    as well). A scan of 5 products is refused (its ``while`` body holds a
    dot) unless loops count their known trip count (5 x 65 536).
  * Two real cells on the 256-rank mesh at the shallow depth of
    ``_layer_variants``, each side in its own process: granite-3-2b
    ``train_4k`` (its batch given ``batch_shardings``) and ``decode_32k``.
    The port's dot FLOPs lie within 2% of the compiled program's and its
    argument bytes equal the program's.
  * The committed ``results/dryrun_xcheck.json``: an entry for every
    ``ok`` cell of ``results/dryrun_torch.json``; every figure of an ``ok``
    entry within its bound (dot FLOPs within 2%, collective totals within
    2x, argument bytes equal) or carrying its cause, the one ``ROADMAP.md``
    logs; argument bytes that part only by the arguments the compiled
    program drops.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import dryrun_xcheck as xcheck  # noqa: E402

RESULTS = ROOT / "results" / "dryrun_xcheck.json"
DRYRUN = ROOT / "results" / "dryrun_torch.json"


@pytest.fixture(scope="module")
def parser(tmp_path_factory):
    out = tmp_path_factory.mktemp("xcheck") / "parser.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(ROOT / "tests" / "_xcheck_cases.py"), str(out)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("case, flops", [("2d", 8192), ("batched", 4096), ("fused", 2048),
                                         ("grad", 131072)])
def test_dot_flops_are_hand_counts(parser, case, flops):
    assert parser[case] == flops


def test_cost_analysis_counts_more_than_the_dots(parser):
    assert parser["grad_cost_analysis"] > parser["grad"]


def test_while_body_with_a_dot_is_refused_unless_trip_counted(parser):
    assert "holds a dot" in parser["while_refused"]
    assert parser["while_dot_times"] == [5]
    assert parser["while_trip_counted"] == 5 * parser["while_dot_each"][0] == 5 * 65536


def test_convolution_is_refused():
    """Whisper's front end is a stub, so no cell holds one: a module that
    does is refused, not counted without it."""
    text = ("HloModule c\n\nENTRY %main (p0: f32[1,8,8,1], p1: f32[3,3,1,1]) -> f32[1,8,8,1] {\n"
            "  %p0 = f32[1,8,8,1]{3,2,1,0} parameter(0)\n"
            "  %p1 = f32[3,3,1,1]{3,2,1,0} parameter(1)\n"
            "  ROOT %conv.1 = f32[1,8,8,1]{3,2,1,0} convolution(%p0, %p1), "
            "window={size=3x3 pad=1_1x1_1}, dim_labels=b01f_01io->b01f\n}\n")
    with pytest.raises(xcheck.HloCountError, match="convolution"):
        xcheck.hlo_dot_flops(text)


CELLS = ("granite-3-2b|train_4k|single", "granite-3-2b|decode_32k|single")


@pytest.fixture(scope="module")
def cells():
    """Both sides of each cell at the shallow depth, four processes at once."""
    jobs = [(key, side) for key in CELLS for side in ("reference", "port")]
    with ThreadPoolExecutor(len(jobs)) as pool:
        done = pool.map(lambda j: xcheck.count_side(j[1], j[0], timeout=240, variants=(0,)),
                        jobs)
        return dict(zip(jobs, done))


@pytest.mark.parametrize("key", CELLS)
def test_real_cell_matches_the_compiled_program(cells, key):
    ref, port = cells[(key, "reference")], cells[(key, "port")]
    assert "variants" in ref, ref
    assert "variants" in port, port
    r, p = ref["variants"][0], port["variants"][0]
    assert r["n_layers"] == p["n_layers"] == 1
    assert r["scan_unroll"] and r["loops"] == 0
    assert abs(p["dot_flops"] / r["dot_flops"] - 1) <= xcheck.FLOPS_TOL, (p["dot_flops"],
                                                                          r["dot_flops"])
    assert p["argument_size_in_bytes"] == r["argument_size_in_bytes"]
    assert r["pruned_argument_bytes"] == 0


def test_committed_xcheck_covers_every_ok_cell():
    dry = json.loads(DRYRUN.read_text())
    got = json.loads(RESULTS.read_text())
    ok = [k for k, c in dry.items() if c["status"] == "ok"]
    assert len(ok) == 64
    assert sorted(got) == sorted(ok)
    for key, cell in got.items():
        assert cell["status"] in ("ok", "unsupported", "timeout"), key
        if cell["status"] != "ok":
            assert cell["reason"], key
            continue
        for side in ("reference", "port"):
            for figure in ("dot_flops", "argument_size_in_bytes", "wire"):
                assert len(cell[side][figure]) == 2, (key, side, figure)
        assert cell["full_depth"]["port_dot_flops"] > 0
        assert not cell["uncaused"], (key, cell["uncaused"])
        assert cell["flops_within"] or "dot_flops" in cell["causes"], key
        assert cell["wire_within"] or "wire" in cell["causes"], key
        if not cell["argument_bytes_equal"]:  # only the arguments jit drops
            assert all(cell["argument_bytes_equal_with_pruned"]), key
