"""The controls of the comparisons that decide ``correct``, read at a
cell's own size by the numbers the cell compares. The benchmark's own runs
never run them; they set the upper readings of each limit
(``limits/<cell>.json``).

Each driver (``drivers/<driver>.py``) has its cell's control as its
``control(manifest, cell, cfg, tr, seed, device=, seconds=)``.

    python3 -m portbench.control --workload train.granite-3-2b --seeds 1,2,3 \\
        [--out chiprun_out/control.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(manifest, cell: str, seed: int, *, device: str = "cuda", seconds: float = 5.0,
             config=None, traffic=None) -> dict:
    """The control's readings of ``cell`` on ``seed``, from the ``control``
    of the cell's driver; ``config`` and ``traffic`` replace the cell's
    files (the tests' smaller sizes)."""
    from . import harness

    c = manifest.cell(cell)
    cfg = config if config is not None else manifest.config(c["config"])
    tr = traffic if traffic is not None else manifest.traffic(c["traffic"])
    return harness.driver(tr["driver"]).control(manifest, cell, cfg, tr, seed, device=device,
                                                seconds=seconds)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0, help="decode's short window")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from . import harness

    manifest = harness.Manifest(ROOT)
    out = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        out[seed] = readings(manifest, args.workload, seed, seconds=args.seconds)
        print(json.dumps({"seed": seed, **out[seed]}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
