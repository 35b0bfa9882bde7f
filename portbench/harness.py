"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
runs its driver, reads its metrics and builds the result line.

A cell names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<traffic>.json``); the traffic names its driver
(``drivers/<driver>.py``), and the cell's limits are
``limits/<cell>.json``. Every metric is a reader of its own,
``metrics/<metric>.py``, with ``read(run)`` returning a number or None
(nothing to read: the metric is left out of the line).
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


class Manifest:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = root
        self.data = load_json(root / "BENCHMARK.json")
        self.cells = {w["name"]: w for w in self.data["workloads"]}

    def cell(self, name: str) -> Dict[str, Any]:
        if name not in self.cells:
            raise KeyError("unknown workload %r; known: %s" % (name, sorted(self.cells)))
        return self.cells[name]

    def config(self, name: str) -> Dict[str, Any]:
        return load_json(HERE / "configs" / ("%s.json" % name))

    def traffic(self, name: str) -> Dict[str, Any]:
        return load_json(HERE / "traffic" / ("%s.json" % name))

    def limits(self, cell: str) -> Dict[str, Any]:
        return load_json(HERE / "limits" / ("%s.json" % cell))

    def end_to_end(self, cell: str) -> List[Dict[str, Any]]:
        return [m for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[Dict[str, Any]]:
        """The metrics that list the cell, and those that list no cells
        and move an end-to-end metric the cell reports."""
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py`` (names may hold dots,
    so the file is loaded by its path)."""
    path = HERE / "metrics" / ("%s.py" % name)
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    return importlib.import_module("portbench.drivers." + name)


def quantile(values: List[float], q: float) -> float:
    """The ``q`` quantile (0-1) of ``values``, linear between order
    statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    at = q * (len(xs) - 1)
    lo = int(at)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (at - lo)


class Run:
    """One run of one cell: what its driver measured, counted and checked.

    The driver makes its inputs, sets up and warms the program, then calls
    ``start_window()``, runs the traffic until ``expired()``, calls
    ``stop_window()`` and checks what the window produced
    (``check(name, value, limit)``). With ``trace`` the window runs under
    ``torch.profiler`` and ``trace_summary`` holds its reduction."""

    def __init__(self, cell: Dict[str, Any], config: Dict[str, Any], traffic: Dict[str, Any],
                 limits: Dict[str, Any], *, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float):
        self.cell, self.config, self.traffic, self.limits = cell, config, traffic, limits
        self.seed, self.seconds, self.trace, self.device = seed, float(seconds), trace, device
        self.t_start = t_start
        self.data: Dict[str, Any] = {}
        self.checks: Dict[str, Dict[str, float]] = {}
        self.attempted = 0
        self.failed = 0
        self.errors: List[str] = []
        self.memory_peak_bytes = 0
        self.trace_summary: Optional[Dict[str, Any]] = None
        self._prof = None
        self._w0 = self._w1 = None
        self._w0_ns = self._w1_ns = None
        self._tmp: Optional[Path] = None
        self._marks: List[list] = []

    # -- scratch files (under TMPDIR, removed at the end) ----------------------

    def scratch(self) -> Path:
        if self._tmp is None:
            self._tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
        return self._tmp

    def write_scratch(self, name: str, data: bytes) -> Path:
        path = self.scratch() / name
        path.write_bytes(data)
        return path

    def cleanup(self) -> None:
        if self._tmp is not None:
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._tmp = None

    # -- the window ------------------------------------------------------------

    def start_window(self) -> None:
        if self.trace:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        self._sync()
        self._w0_ns = time.time_ns()
        self._w0 = time.monotonic()

    def expired(self) -> bool:
        return time.monotonic() - self._w0 >= self.seconds

    def stop_window(self) -> None:
        """Close the window now (the driver has synchronised the device)."""
        self._w1 = time.monotonic()
        self._w1_ns = time.time_ns()

    def finish_trace(self) -> None:
        if self._prof is None:
            return
        self._sync()
        self._prof.__exit__(None, None, None)
        self.trace_summary = reduce_trace(self._prof, self._w0_ns, self._w1_ns)
        self._prof = None

    def _sync(self) -> None:
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()

    @property
    def window_s(self) -> float:
        return self._w1 - self._w0

    @property
    def setup_s(self) -> float:
        return self._w0 - self.t_start

    # -- correctness -----------------------------------------------------------

    def check(self, name: str, value: float, *, limit: Optional[float] = None) -> None:
        """Compare ``value`` with its limit (``limits/<cell>.json`` unless
        given): correct while value <= limit."""
        lim = self.limits[name] if limit is None else limit
        self.checks[name] = {"value": float(value), "limit": float(lim)}

    def mark(self, phase: str) -> None:
        """Note that a phase of set-up ended (seconds since process start)."""
        self._marks.append([phase, round(time.monotonic() - self.t_start, 3)])

    def notes(self) -> Dict[str, Any]:
        """What the run read beside its checks, for the record: the
        set-up's phases, the window's length, and whatever the driver
        noted (``data["notes"]``)."""
        return dict({"setup_phases_end_s": self._marks, "window_s": self.window_s},
                    **self.data.get("notes", {}))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and not self.errors and all(
            c["value"] <= c["limit"] for c in self.checks.values())


@contextlib.contextmanager
def span(name: str):
    """A span of the benchmark's own, seen by the profiler in a traced run
    (it names the host's work in the idle gaps)."""
    from torch.profiler import record_function

    with record_function(name):
        yield


def reduce_trace(prof, w0_ns: int, w1_ns: int) -> Dict[str, Any]:
    """Device busy seconds (the union of the intervals of device work:
    kernels, copies and sets, inside the window), device seconds by
    operation name, and the idle gaps by the benchmark's innermost span
    (``pb.*``) on the host at each gap's middle."""
    from torch.autograd import DeviceType

    dev, spans = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # The benchmark's own spans appear on the device's timeline too
            # (user annotations); they are not device work.
            if d > 0 and s + d > w0_ns and s < w1_ns and not e.is_user_annotation():
                dev.append((max(s, w0_ns), min(s + d, w1_ns), e.name()))
        elif e.name().startswith("pb."):
            spans.append((s, s + d, e.name()))
    by_name: Dict[str, float] = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-9
    dev.sort()
    busy, gaps, cur_s, cur_e = 0, [], None, w0_ns
    for s, e, _ in dev:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    gaps.append((cur_e, w1_ns))
    spans.sort(key=lambda t: t[1] - t[0])
    idle: Dict[str, float] = {}
    for a, b in gaps:
        if b <= a:
            continue
        mid = (a + b) // 2
        label = next((n for s, e, n in spans if s <= mid <= e), "host")
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"busy_s": busy * 1e-9, "window_s": (w1_ns - w0_ns) * 1e-9, "kernels": by_name,
            "device_ops": top(by_name), "idle_gaps": top(idle)}


def run_cell(manifest: Manifest, cell_name: str, *, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, config: Optional[Dict[str, Any]] = None,
             traffic: Optional[Dict[str, Any]] = None) -> Run:
    """Run the cell's driver once. ``config``/``traffic`` replace the
    cell's files (the CPU tests run a cell's driver at a small size)."""
    cell = manifest.cell(cell_name)
    cfg = config if config is not None else manifest.config(cell["config"])
    tr = traffic if traffic is not None else manifest.traffic(cell["traffic"])
    run = Run(cell, cfg, tr, manifest.limits(cell_name), seed=seed, seconds=seconds,
              trace=trace, device=device, t_start=t_start)
    run.mark("imports")
    try:
        driver(tr["driver"]).run(run)
    finally:
        run.cleanup()
    return run


def result_line(manifest: Manifest, run: Run, *, device_kind: str, chips: int) -> Dict[str, Any]:
    """The result's JSON object; the compared numbers come last."""
    name = run.cell["name"]
    metrics: Dict[str, Dict[str, Any]] = {}
    wanted = manifest.per_layer(name) if run.trace else manifest.end_to_end(name)
    for m in wanted:
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if run.device != "cpu" else "cpu", "kind": device_kind,
              "count": chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    out: Dict[str, Any] = {"correct": run.correct, "attempted": int(run.attempted),
                           "failed": int(run.failed), "metrics": metrics, "device": device}
    if run.trace and run.trace_summary is not None:
        device["busy_s"] = run.trace_summary["busy_s"]
        device["window_s"] = run.trace_summary["window_s"]
        out["breakdown"] = {"device_ops": run.trace_summary["device_ops"],
                            "idle_gaps": run.trace_summary["idle_gaps"]}
    out["checks"] = dict(run.checks, **({"errors": {"value": len(run.errors), "limit": 0}}
                                        if run.errors else {}))
    return out
