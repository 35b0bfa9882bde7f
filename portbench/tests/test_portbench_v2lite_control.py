"""The ``decode.deepseek-v2-lite`` cell's control and faults on the card,
at the cell's own size (five runs of about a minute): the program's run
is correct by the cell's limits, and the reference in fp8, RoPE without
YaRN, the top-k weights renormalised, the capacity-bounded dispatch and
the dropless path's groups misplaced each come out as not correct
(``python3 -m portbench.control`` reads them on more seeds)."""

import json

import numpy as np
import pytest

from portbench import control, harness

CELL = "decode.deepseek-v2-lite"


def _failed(readings: dict, limits: dict) -> bool:
    return any(v > limits[k] for k, v in readings.items() if k in limits)


@pytest.mark.cuda
def test_v2lite_control_and_faults(card):
    m = harness.Manifest()
    got = control.readings(m, CELL, 2 ** 31 + 2901, device=card, seconds=3)
    print(json.dumps(got))
    limits = m.limits(CELL)
    assert not _failed(got["program"], limits), got["program"]
    assert _failed(got["fp8"], limits) and np.isfinite(got["fp8"]["served_logit_gap"])
    for fault in ("plain_rope", "renormalized", "grouping"):
        assert _failed(got[fault], limits), (fault, got[fault])
    assert got["capacity"]["dropped_pairs"] > limits["dropped_pairs"]
    assert got["grouping"]["experts_gap"] > limits["experts_gap"]
