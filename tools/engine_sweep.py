#!/usr/bin/env python3
"""The stage-2 engine's sweep: where the card starts to beat the host.

    python3 tools/engine_sweep.py [--device cuda] [--repeats 30] [--crc-payload 524288]
                                  [--out results/engine_sweep_h100.json] [--commit SHA]

The counterpart of ``bench_engine`` in ``benchmarks/bench_kernels.py``, on
``repro_torch``: the same rows, by the same names and in the same format
(``{"name", "value_us", "derived"}``, MB/s in ``derived``), so that
``repro_torch.kernels.engine.derive_crossover`` reads them unchanged.

  * ``kernel_engine_cpu_replace``: the host's marker gather
    (``core.markers.replace_markers``) over one chunk of one tile (8 192
    symbols).
  * ``kernel_engine_per_chunk_b{1,4,16,64}``: B such chunks, one
    ``kernels.ops.marker_replace`` call each (table build, upload, launch,
    readback per chunk).
  * ``kernel_engine_batched_b{1,4,16,64}``: the same chunks submitted to one
    ``TorchDecodeEngine(force_device=True, max_batch_tiles=min(B, 16),
    max_delay_s=0.05)``, waiting for every future.
  * ``kernel_engine_cpu_crc``, ``kernel_engine_crc_batched_b{1,8}``: zlib
    against the engine's batched CRC.
  * ``kernel_engine_interactive_singleton``: one chunk through an engine
    routed by the crossover these rows give, with its fallback count.

Chunks, windows (four of 32 KiB), engine settings and best-of-N timing are
the reference's; on the card each timed call ends with
``torch.cuda.synchronize()``. N is 30 for every row (the reference's 3 and
5 left the derived replace crossover to noise on the card: the batched and
the host rows lie within tens of percent of each other). The reference
takes its batched CRC rows as the best of 1, since each request there
costs a host fold of its 1 024 lane CRCs; the port's CRC launch folds them
on the card, so those rows are timed like the others.

The CRC payload differs. The reference cut it to 8 KiB, as its interpret
mode runs the kernel's per-byte loop step by step. On the card 8 KiB times
only the dispatch: B = 8 of them move 64 KiB in about one launch's
overhead, so the device's bandwidth would be read far too low. Here
``kernel_engine_cpu_crc`` and ``kernel_engine_crc_batched_b8`` take 512 KiB
a request (8 x 512 KiB = 4 MiB, the engine's ``max_batch_crc_bytes``: one
dispatch; the reader's requests are chunks of hundreds of KiB to MiB), and
``kernel_engine_crc_batched_b1`` keeps 8 KiB, since ``derive_crossover``
takes its time as the overhead of a dispatch of 8 192 bytes. The rows at
the other payload stand beside them with a ``_8KiB`` or ``_512KiB`` suffix.

With ``--out`` (by default ``results/engine_sweep_h100.json`` on the card,
nothing on the host) the rows are written with the crossover they give,
the commit, and the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` reports them.
``TorchDecodeEngine(crossover="auto")`` reads that file.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ARTIFACT = ROOT / "results" / "engine_sweep_h100.json"
CHUNK_SYMBOLS = 8 * 1024  # one tile a chunk
BATCHES = (1, 4, 16, 64)
CRC_BATCHES = (1, 8)
CRC_PAYLOAD = 512 << 10
CRC_OVERHEAD_PAYLOAD = 8 << 10  # the bytes derive_crossover's overhead term assumes
SEED = 0xBEEF  # the reference's DataGen seed


def _row(name: str, seconds: float, derived: str) -> dict:
    return {"name": name, "value_us": round(seconds * 1e6, 3), "derived": derived}


def _kib(n: int) -> str:
    return "%dKiB" % (n >> 10)


def sweep(device: str = "cuda", repeats: int = 30, crc_payload: int = CRC_PAYLOAD) -> list:
    """The sweep's rows on ``device``, in the order the reference emits them."""
    import torch

    from repro_torch.core.markers import replace_markers as cpu_replace
    from repro_torch.kernels import ops
    from repro_torch.kernels.engine import TorchDecodeEngine, derive_crossover

    on_card = torch.device(device).type == "cuda"

    def best_of(fn, n: int = repeats) -> float:
        """Best of ``n`` after one warm-up call; the card's work is
        finished inside each timed call."""
        def call():
            fn()
            if on_card:
                torch.cuda.synchronize()

        call()
        best = float("inf")
        for _ in range(n):
            t0 = time.perf_counter()
            call()
            best = min(best, time.perf_counter() - t0)
        return best

    rng = np.random.default_rng(SEED)
    windows = [rng.integers(0, 256, 32768, dtype=np.uint8).tobytes() for _ in range(4)]

    def make_chunk() -> np.ndarray:
        return rng.integers(0, 33024, CHUNK_SYMBOLS, dtype=np.int64).astype(np.uint16)

    rows = []
    syms0 = make_chunk()
    t_cpu = best_of(lambda: cpu_replace(syms0, windows[0]))
    rows.append(_row("kernel_engine_cpu_replace", t_cpu, "%.0fMB/s" % (CHUNK_SYMBOLS / t_cpu / 1e6)))

    t_single = None
    for b in BATCHES:
        chunks = [make_chunk() for _ in range(b)]
        wins = [windows[i % len(windows)] for i in range(b)]

        def per_chunk():
            for c, w in zip(chunks, wins):
                ops.marker_replace(c, w, device=device)

        t_pc = best_of(per_chunk)
        rows.append(_row("kernel_engine_per_chunk_b%d" % b, t_pc,
                         "%.1fMB/s" % (b * CHUNK_SYMBOLS / t_pc / 1e6)))
        with TorchDecodeEngine(device=device, force_device=True, crossover=None,
                               max_batch_tiles=min(b, 16), max_delay_s=0.05) as eng:
            def batched():
                futs = [eng.submit_replace(c, w) for c, w in zip(chunks, wins)]
                for f in futs:
                    f.result()

            t_b = best_of(batched)
        if t_single is None:
            t_single = t_b
        rows.append(_row("kernel_engine_batched_b%d" % b, t_b,
                         "%.1fMB/s;%.2fx_vs_per_chunk;%.2fx_vs_single"
                         % (b * CHUNK_SYMBOLS / t_b / 1e6, t_pc / t_b, b * t_single / t_b)))

    def crc_rows(payload: int, suffix: str, names) -> None:
        datas = [rng.integers(0, 256, payload, dtype=np.uint8).tobytes()
                 for _ in range(max(CRC_BATCHES))]
        if "cpu" in names:
            t_zc = best_of(lambda: zlib.crc32(datas[0]))
            rows.append(_row("kernel_engine_cpu_crc" + suffix, t_zc,
                             "%.0fMB/s" % (payload / t_zc / 1e6)))
        for b in CRC_BATCHES:
            if b not in names:
                continue
            with TorchDecodeEngine(device=device, force_device=True, crossover=None,
                                   max_crc_requests=b, max_delay_s=0.05) as eng:
                def crc_batched():
                    futs = [eng.submit_crc(d) for d in datas[:b]]
                    for d, f in zip(datas, futs):
                        assert f.result() == zlib.crc32(d) & 0xFFFFFFFF

                t_c = best_of(crc_batched)
            rows.append(_row("kernel_engine_crc_batched_b%d%s" % (b, suffix), t_c,
                             "%.1fMB/s" % (b * payload / t_c / 1e6)))

    # The rows derive_crossover reads (module docstring), then the others.
    crc_rows(crc_payload, "", ("cpu", 8))
    crc_rows(CRC_OVERHEAD_PAYLOAD, "", (1,))
    crc_rows(CRC_OVERHEAD_PAYLOAD, "_" + _kib(CRC_OVERHEAD_PAYLOAD), ("cpu", 8))
    crc_rows(crc_payload, "_" + _kib(crc_payload), (1,))

    # Interactive: one chunk through an engine routed by these rows.
    with TorchDecodeEngine(device=device, crossover=derive_crossover(rows)) as eng:
        t_i = best_of(lambda: eng.replace_markers(syms0, windows[0]))
        stats = eng.stats()
    rows.append(_row("kernel_engine_interactive_singleton", t_i, "fallbacks=%d;batches=%d"
                     % (stats["fallbacks"]["replace"], stats["batches"])))
    return rows


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def git_commit() -> str:
    """HEAD, with ``-dirty`` when the tree has uncommitted changes."""
    head = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                          text=True, check=True).stdout.strip()
    dirty = subprocess.run(["git", "status", "--porcelain", "--untracked-files=no"], cwd=ROOT,
                           capture_output=True, text=True, check=True).stdout.strip()
    return head + ("-dirty" if dirty else "")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--repeats", type=int, default=30, help="best of N, after one warm-up")
    ap.add_argument("--crc-payload", type=int, default=CRC_PAYLOAD,
                    help="bytes a CRC request of the bandwidth rows")
    ap.add_argument("--out", help="artifact path (default: %s on the card)"
                    % ARTIFACT.relative_to(ROOT))
    ap.add_argument("--commit", help="the commit the tree is (default: git rev-parse HEAD)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.kernels.engine import derive_crossover

    card = None
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("engine_sweep: no CUDA device", file=sys.stderr)
            return 1
        card = card_line()
        print(card, flush=True)
    rows = sweep(args.device, args.repeats, args.crc_payload)
    for row in rows:
        print("%s,%.3f,%s" % (row["name"], row["value_us"], row["derived"]), flush=True)
    crossover = derive_crossover(rows)
    print(json.dumps({"crossover": crossover}), flush=True)
    out = args.out or (str(ARTIFACT) if card else None)
    if out:
        name, _, limit = card.partition(",") if card else ("cpu", "", "")
        payload = {
            "tool": "tools/engine_sweep.py",
            "commit": args.commit or git_commit(),
            "date": datetime.datetime.now(datetime.timezone.utc).isoformat(timespec="seconds"),
            "card": {"name": name.strip(), "power_limit": limit.strip(), "nvidia_smi": card},
            "device": torch.cuda.get_device_name(0) if card else "cpu",
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "host_cpus": os.cpu_count(), "seed": SEED, "repeats": args.repeats,
            "chunk_symbols": CHUNK_SYMBOLS, "crc_payload": args.crc_payload,
            "crc_overhead_payload": CRC_OVERHEAD_PAYLOAD,
            "results": rows, "crossover": crossover,
        }
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(payload, indent=1) + "\n")
        print("wrote %s" % out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
