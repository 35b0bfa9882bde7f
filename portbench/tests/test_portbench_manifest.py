"""BENCHMARK.json against the benchmark's contract, and every file it
names found by its name."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
WIDTH = re.compile(r"(_dim|_rank|hidden_size|intermediate_size|head|expert|expand|state|latent"
                   r"|proj)", re.I)


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes(bench):
    assert set(bench) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 << 10
    assert 1 <= len(bench["paths"]) <= 16 and bench["paths"] == ["portbench"]
    assert all(_line(w) for w in bench["command"]) and len(bench["command"]) <= 32
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43 200 s
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entry_keys(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(c["name"] for c in bench["configs"])) == len(bench["configs"])
    assert len(set(w["name"] for w in bench["workloads"])) == len(bench["workloads"])
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_file_found_by_name(bench):
    m = harness.Manifest(ROOT)
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"] == "portbench/configs/%s.json" % c["name"]
        cfg = m.config(c["name"])
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg and not WIDTH.search(key), key
    for w in bench["workloads"]:
        tr = m.traffic(w["traffic"])
        assert harness.driver(tr["driver"]).run
        assert set(m.limits(w["name"])) > set()
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.metric_reader(metric["name"]))


def test_each_cell_reports_what_it_must(bench):
    m = harness.Manifest(ROOT)
    layers = {}
    for metric in bench["per_layer"]:
        layers.setdefault(metric["layer"], metric["layer"])
        for cell in metric.get("workloads", []):
            reported = {e["name"] for e in m.end_to_end(cell)}
            assert metric["moves"] in reported, (metric["name"], cell)
    for w in bench["workloads"]:
        e2e = {e["name"] for e in m.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert m.per_layer(w["name"])
