"""The controls on the card, at the cells' own sizes (about a minute
each): each comes out as not correct by the cell's own limits, where the
program's run on the same inputs is correct (``python3 -m
portbench.control`` reads them on more seeds)."""

import numpy as np
import pytest

from portbench import control, harness


def _failed(readings: dict, limits: dict) -> bool:
    return any(v > limits[k] for k, v in readings.items() if k in limits)


@pytest.mark.cuda
def test_read_control(card):
    m = harness.Manifest()
    got = control.readings(m, "read.b64-gzip", 11, device=card)
    assert _failed(got["zlib_no_crc_flipped_bit"], m.limits("read.b64-gzip"))


@pytest.mark.cuda
def test_train_control_and_fault(card):
    m = harness.Manifest()
    got = control.readings(m, "train.granite-3-2b", 12, device=card)
    limits = m.limits("train.granite-3-2b")
    assert _failed(got["fp8"], limits) and _failed(got["half_batch"], limits)


@pytest.mark.cuda
def test_decode_control(card):
    m = harness.Manifest()
    got = control.readings(m, "decode.granite-3-2b", 13, device=card, seconds=3)
    limits = m.limits("decode.granite-3-2b")
    assert not _failed(got["program"], limits) and _failed(got["fp8"], limits)
    assert np.isfinite(got["fp8"]["served_logit_gap"])
