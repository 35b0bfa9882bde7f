"""Run one cell of the benchmark once, and print its result as the last
line of standard output.

    python3 -m portbench.run --workload read.b64-gzip --seed 12345 --seconds 20 --trace 0

From the root of a checkout. The program (``src/repro_torch``) runs on the
CUDA device; without one, or with fewer than the cell asks for, the run
prints no result and exits with 2. ``--trace 1`` runs the window under
``torch.profiler`` and reports the cell's per-layer metrics instead of its
end-to-end ones. The numbers compared to decide ``correct`` are printed
beside their limits as the last lines of standard error and, under
``checks``, last in the result.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def forbidden_loaded(names=None) -> list:
    """The forbidden top-level packages among ``names`` (the loaded
    modules by default), each compared whole: ``repro_torch`` is not
    ``repro``."""
    from portbench.harness import FORBIDDEN_MODULES

    tops = {name.split(".", 1)[0] for name in list(sys.modules if names is None else names)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: no program at %s" % (ROOT / "src" / "repro_torch"), file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from portbench import harness

    manifest = harness.Manifest(ROOT)
    cell = manifest.cell(args.workload)

    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("portbench: the cell needs %d CUDA device(s); found %d" % (
            chips, torch.cuda.device_count() if torch.cuda.is_available() else 0),
            file=sys.stderr)
        return 2
    try:
        run = harness.run_cell(manifest, args.workload, seed=args.seed, seconds=args.seconds,
                               trace=bool(args.trace), device="cuda", t_start=T_START)
        line = harness.result_line(manifest, run, device_kind=torch.cuda.get_device_name(0),
                                   chips=chips)
    except Exception:
        traceback.print_exc()
        return 1
    bad = forbidden_loaded()
    if bad:
        print("portbench: forbidden modules loaded: %s" % ", ".join(bad), file=sys.stderr)
        return 3
    for err in run.errors:
        print("error: %s" % err, file=sys.stderr)
    for name, value in run.notes().items():
        print("note %s %s" % (name, value), file=sys.stderr)
    for name, c in line["checks"].items():
        print("check %s %r limit %r" % (name, c["value"], c["limit"]), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
