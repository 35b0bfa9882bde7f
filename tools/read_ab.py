#!/usr/bin/env python3
"""The main-path reads of two checkouts, in turns on one card.

    python3 tools/read_ab.py --base DIR [--turns 5] [--mib 16] [--out results.json]

DIR is another checkout of the repository (for example the parent commit,
unpacked with ``git archive`` into the git-ignored ``build/``). Each turn
runs the base and then this checkout, or this checkout and then the base
(base, this, this, base, ...), each in a process of its own that imports
that tree's ``chip_smoke.py`` and ``repro_torch`` and runs its
``main_path``: phase 4, the gzip read of the seeded base64 corpus on the
default CUDA engine under torch.profiler, 64 preads and the BGZF read, all
checked against the corpus. One timed read of a host-bound path varies by
tens of percent between runs, so two commits are compared by the medians
and quartiles of several runs in turns. Prints one JSON row per run, then
the medians and quartiles of each metric per side; the card's name and
power limit head the output. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
METRICS = ("gzip_MBps", "bgzf_MBps", "gzip_device_busy_ms", "gzip_device_idle_share")


def worker(tree: Path, seed: int, mib: int) -> None:
    sys.path.insert(0, str(tree))
    import chip_smoke  # puts the tree's src first on the path

    import repro_torch

    if not Path(repro_torch.__file__).resolve().is_relative_to(tree.resolve()):
        raise SystemExit("imported %s, not the tree's repro_torch" % repro_torch.__file__)
    result, engine, _, _ = chip_smoke.main_path(seed, mib, min(16, os.cpu_count() or 1))
    engine.shutdown()
    print(json.dumps({k: result[k] for k in METRICS + ("launches",)}))


def run(tree: Path, seed: int, mib: int) -> dict:
    proc = subprocess.run([sys.executable, __file__, "--worker", str(tree), "--seed", str(seed),
                           "--mib", str(mib)], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit("worker for %s failed:\n%s%s" % (tree, proc.stdout, proc.stderr))
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--base", type=Path, help="the other checkout")
    ap.add_argument("--turns", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mib", type=int, default=16)
    ap.add_argument("--out", help="also write every run to this JSON file")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.seed, args.mib)
        return 0
    if args.base is None:
        ap.error("--base is required")

    import torch

    if not torch.cuda.is_available():
        print("read_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    trees = {"base": args.base.resolve(), "change": ROOT}
    runs = []
    for turn in range(args.turns):
        for side in (("base", "change") if turn % 2 == 0 else ("change", "base")):
            runs.append({"side": side, "turn": turn, **run(trees[side], args.seed, args.mib)})
            print(json.dumps(runs[-1]), flush=True)

    print("%-24s %-8s %12s %12s %12s" % ("metric", "side", "q1", "median", "q3"))
    for metric in METRICS:
        for side in trees:
            q1, med, q3 = statistics.quantiles(
                [r[metric] for r in runs if r["side"] == side], n=4, method="inclusive")
            print("%-24s %-8s %12.6f %12.6f %12.6f" % (metric, side, q1, med, q3))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
