#!/usr/bin/env python3
"""The kernels of two checkouts, timed in turns on one card.

    python3 tools/kernel_ab.py --base DIR [--turns 2] [--out results.json]

DIR is another checkout of the repository (for example the parent commit,
unpacked with ``git archive`` into the git-ignored ``build/``). Each turn
runs the base and then this checkout, or this checkout and then the base
(base, this, this, base, ...), each in a process of its own that imports
that tree's ``repro_torch``, builds its kernels and runs this checkout's
``chip_smoke.marker_case``, ``chip_smoke.crc_case`` and
``chip_smoke.precode_case`` at the same shapes on the same seeded inputs:
the precheck over the gzip -6 of ``chip_smoke.base64_corpus(seed, 16
MiB)`` (``chip_smoke.py``'s main-path shape), over its densest stream and
over Silesia-sized random bytes. Every case is checked exact against the
plain version, as in ``chip_smoke.py``. Prints one JSON row per case and run,
then a table of the kernel times side by side; the card's name and power
limit head the output. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import gzip
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

MARKER_SHAPES = [(1, 1), (8, 1), (16, 1), (32, 1), (32, 8), (512, 1), (512, 8)]
SILESIA_TILES = 25_872  # chip_smoke.SILESIA_BYTES in 8192-symbol tiles
CRC_SHAPES = [(1, 2048), (1, 4096), (8, 4096), (16, 4096),
              (1, 1), (1, 7), (1, 32), (1, 64), (1, 127), (1, 128), (1, 256), (1, 1000),
              (1, 4097), (1, 12464)]


def worker(tree: Path, seed: int) -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # puts this checkout's src first on the path

    sys.path.insert(0, str(tree / "src"))
    import torch

    import repro_torch
    from repro_torch.kernels import _build

    if not Path(repro_torch.__file__).resolve().is_relative_to(tree.resolve()):
        raise SystemExit("imported %s, not the tree's repro_torch" % repro_torch.__file__)
    _build.build(("marker_replace", "crc32", "precode_check"))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rows = [dict(chip_smoke.marker_case(t, n, gen, device), case="marker %dx%d" % (t, n))
            for t, n in MARKER_SHAPES]
    rows.append(dict(chip_smoke.marker_case(SILESIA_TILES, 8, gen, device, launches=5),
                     case="marker %dx8" % SILESIA_TILES))
    rows += [dict(chip_smoke.crc_case(b, s, gen, device), case="crc B=%d seg_len=%d" % (b, s))
             for b, s in CRC_SHAPES]
    gz = gzip.compress(chip_smoke.base64_corpus(seed, 16 << 20), 6, mtime=0)
    data = torch.frombuffer(bytearray(gz), dtype=torch.uint8).to(device)
    rows.append(dict(chip_smoke.precode_case(data, 0, 8 * len(gz) - chip_smoke.HALO, "gzip"),
                     case="precode gzip %d B" % len(gz)))
    dense = chip_smoke.pattern_bytes(chip_smoke.DENSE_BITS,
                                     chip_smoke.DENSE_OFFSETS + chip_smoke.HALO, device)
    rows.append(dict(chip_smoke.precode_case(dense, 0, chip_smoke.DENSE_OFFSETS, "dense"),
                     case="precode (0,0,1) x %d" % chip_smoke.DENSE_OFFSETS))
    n = chip_smoke.SILESIA_GZ_BYTES
    rand = torch.randint(0, 256, (n,), generator=gen, device=device,
                         dtype=torch.int32).to(torch.uint8)
    rows.append(dict(chip_smoke.precode_case(rand, 0, 8 * n - chip_smoke.HALO, "Silesia-sized",
                                             launches=5), case="precode %d random B" % n))
    print(json.dumps({"launch_floor_ms": chip_smoke.launch_floor_ms(), "rows": rows}))


def run(tree: Path, seed: int) -> dict:
    proc = subprocess.run([sys.executable, __file__, "--worker", str(tree), "--seed", str(seed)],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit("worker for %s failed:\n%s%s" % (tree, proc.stdout, proc.stderr))
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--base", type=Path, help="the other checkout")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write every row to this JSON file")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.seed)
        return 0
    if args.base is None:
        ap.error("--base is required")

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    trees = {"base": args.base.resolve(), "change": ROOT}
    runs = []
    for turn in range(args.turns):
        order = ("base", "change") if turn % 2 == 0 else ("change", "base")
        for side in order:
            result = run(trees[side], args.seed)
            runs.append({"side": side, "turn": turn, **result})
            print("%s turn %d: launch_floor_ms %.6f" % (side, turn, result["launch_floor_ms"]),
                  flush=True)
            for row in result["rows"]:
                print(json.dumps(dict(row, side=side, turn=turn)), flush=True)

    cases = [row["case"] for row in runs[0]["rows"]]
    print("%-30s %12s %12s %8s %12s" % ("case", "base ms", "change ms", "ratio", "library ms"))
    for i, case in enumerate(cases):
        ms = {side: statistics.median(r["rows"][i]["kernel_ms"] for r in runs if r["side"] == side)
              for side in trees}
        lib = [r["rows"][i]["library_ms"] for r in runs if r["side"] == "change"]
        print("%-30s %12.6f %12.6f %8.3f %12s" % (
            case, ms["base"], ms["change"], ms["change"] / ms["base"],
            "%.6f" % statistics.median(lib) if lib[0] is not None else "none"))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
