#!/usr/bin/env python3
"""Smoke run of repro_torch on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py [--seed 0] [--mib 16] [--out results.json]

Phases, each fatal on failure:
  1. the card's name and power limit, as nvidia-smi reports them;
  2. build the CUDA kernels from src/repro_torch/kernels/csrc with nvcc;
  3. every kernel against its plain PyTorch version on the card, exact, at
     the engine's shapes and at one Silesia-sized launch, timed with CUDA
     events: the kernel and the library call as device time (back-to-back
     launches in a CUDA graph), the wrapper call and the plain version as
     what a caller pays; beside them the memory bound;
  4. the main path: a base64 corpus (the paper's base64 workload) made from
     --seed, gzip -6 and BGZF, read through
     repro_torch.core.ParallelGzipReader on the default CUDA engine, checked
     byte for byte, with random preads; every kernel must have launched.
     The gzip read runs under torch.profiler (CUDA activity) for the
     device's busy time;
  5. each kernel at the shape the main path launched it most, then one JSON
     line of kernel results and, last, the {"ok": true, ...} line.

Without a CUDA device, or without the rest of the repository beside it, the
script exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import base64
import gzip
import json
import os
import statistics
import struct
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# Integer ALU rate: the fp32 67 TFLOP/s counts an FMA as two operations on
# 128 lanes/clk/SM; 32-bit integer logic and shifts issue on 64 lanes/clk/SM.
INT32_OPS_PER_S = 67e12 / 2 / 2
TABLE_SIZE = 256 + 32768
TILE = 8 * 1024
SILESIA_BYTES = 211_938_580  # the Silesia corpus, as one tar


def log(*parts) -> None:
    print(*parts, flush=True)


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median over ``reps`` calls of the time between two CUDA events around
    one call: what a caller pays, host work between launches included."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Device time of one call: ``launches`` calls captured in a CUDA graph
    run back to back, so no host work sits between them; the median replay
    over ``launches``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return median_ms(graph.replay, reps, warmup=1) / launches


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3/5: kernels against their plain versions
# ---------------------------------------------------------------------------

def marker_case(n_tiles: int, n_tables: int, gen, device, pad: bool = False, launches: int = 20):
    import torch

    from repro_torch.kernels import marker_replace as mr

    syms = torch.randint(0, TABLE_SIZE, (n_tiles, 8, 1024), generator=gen, device=device,
                         dtype=torch.int32)
    tids = torch.randint(0, n_tables, (n_tiles,), generator=gen, device=device, dtype=torch.int32)
    if pad:  # pad region: symbols >= TABLE_SIZE, and table ids >= n_tables
        flat = syms.view(-1)
        tail = flat.shape[0] // 4
        flat[-tail:] = torch.randint(TABLE_SIZE, 1 << 16, (tail,), generator=gen, device=device,
                                     dtype=torch.int32)
        tids[-max(1, n_tiles // 4):] = n_tables
    syms = syms.to(torch.uint16)
    tables = torch.randint(0, 256, (n_tables, TABLE_SIZE), generator=gen, device=device,
                           dtype=torch.int32).to(torch.uint8)

    call = lambda: mr.marker_replace_tiles_multi(syms, tables, tids)  # noqa: E731
    out = call()
    plain = mr.marker_replace_tiles_multi_plain(syms, tables, tids)
    torch.cuda.synchronize()
    err = int((out.to(torch.int32) - plain.to(torch.int32)).abs().max())
    if not torch.equal(out, plain):
        raise AssertionError("marker kernel != plain at %d tiles x %d tables (max err %d)"
                             % (n_tiles, n_tables, err))
    if n_tables == 1 and not torch.equal(mr.marker_replace_tiles(syms, tables[0]), plain):
        raise AssertionError("marker_replace_tiles != plain at %d tiles" % n_tiles)
    # The library yardstick: one gather through torch.take with the flat
    # int64 index precomputed (torch cannot index with uint16).
    idx = (tids.clamp(0, n_tables - 1).to(torch.int64)[:, None] * TABLE_SIZE
           + syms.view(n_tiles, -1).to(torch.int64).clamp(max=TABLE_SIZE - 1))
    flat_tables = tables.view(-1)
    n_sym = n_tiles * TILE
    t_bound, by = bound(3 * n_sym + n_tables * TABLE_SIZE + 4 * n_tiles, 2 * n_sym)
    row = {
        "kernel": "marker_replace", "n_tiles": n_tiles, "n_tables": n_tables, "pad": pad,
        "max_abs_err": err,
        "kernel_ms": graph_ms(call, launches),
        "call_ms": median_ms(call, 20),
        "plain_ms": median_ms(lambda: mr.marker_replace_tiles_multi_plain(syms, tables, tids), 5),
        "library_ms": graph_ms(lambda: torch.take(flat_tables, idx), launches),
        "bound_ms": t_bound, "bound_by": by,
    }
    del idx
    return row


def crc_case(batch: int, seg_len: int, gen, device, unbatched: bool = False):
    import torch

    from repro_torch.kernels import crc32 as kc
    from repro_torch.kernels.ref import make_crc_table

    data = torch.randint(0, 256, (batch, 8, 128, seg_len), generator=gen, device=device,
                         dtype=torch.int32).to(torch.uint8)
    table = make_crc_table().to(device)
    if unbatched:
        call = lambda: kc.crc32_segments(data[0], table)  # noqa: E731
        plain_call = lambda: kc.crc32_segments_batched_plain(data, table)[0]  # noqa: E731
    else:
        call = lambda: kc.crc32_segments_batched(data, table)  # noqa: E731
        plain_call = lambda: kc.crc32_segments_batched_plain(data, table)  # noqa: E731
    out, plain = call(), plain_call()
    torch.cuda.synchronize()
    err = int((out.to(torch.int64) - plain.to(torch.int64)).abs().max())
    if not torch.equal(out, plain):
        raise AssertionError("crc kernel != plain at B=%d seg_len=%d" % (batch, seg_len))
    host = data.view(-1, seg_len)[:4].cpu().numpy()
    got = out.reshape(-1)[:4].cpu().numpy().astype("uint32")
    if [zlib.crc32(lane.tobytes()) for lane in host] != [int(x) for x in got]:
        raise AssertionError("crc kernel != zlib at B=%d seg_len=%d" % (batch, seg_len))
    n = data.numel()
    t_bound, by = bound(n + 1024 + 4 * batch * 1024, 4 * n)
    return {
        "kernel": "crc32", "batch": batch, "seg_len": seg_len, "unbatched": unbatched,
        "max_abs_err": err,
        "kernel_ms": graph_ms(call),
        "call_ms": median_ms(call, 20),
        "plain_ms": median_ms(plain_call, 3, warmup=1),
        "library_ms": None,
        "bound_ms": t_bound, "bound_by": by,
    }


def check_kernels(gen, device):
    rows = []
    for n_tiles in (1, 32, 512):
        for n_tables in (1, 8):
            rows.append(marker_case(n_tiles, n_tables, gen, device))
    rows.append(marker_case(32, 8, gen, device, pad=True))
    rows.append(marker_case(-(-SILESIA_BYTES // TILE), 8, gen, device, launches=5))
    for batch in (1, 8, 16):
        rows.append(crc_case(batch, 4096, gen, device))
    rows.append(crc_case(1, 4096, gen, device, unbatched=True))
    return rows


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def base64_corpus(seed: int, nbytes: int) -> bytes:
    import numpy as np

    raw = np.random.default_rng(seed).integers(0, 256, nbytes * 3 // 4 + 64, dtype=np.uint8)
    return base64.encodebytes(raw.tobytes())[:nbytes]  # 76-column lines, like base64(1)


def bgzf(data: bytes, level: int = 6, block: int = 0xFF00) -> bytes:
    """BGZF writer: gzip members of at most 0xFF00 input bytes, each with the
    BC extra subfield holding the member size, then the EOF member."""
    out = []
    for off in range(0, len(data), block):
        piece = data[off : off + block]
        c = zlib.compressobj(level, zlib.DEFLATED, -15)
        body = c.compress(piece) + c.flush()
        size = 18 + len(body) + 8
        out.append(b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff" + struct.pack("<H", 6)
                   + b"BC" + struct.pack("<HH", 2, size - 1) + body
                   + struct.pack("<II", zlib.crc32(piece), len(piece)))
    out.append(bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000"))
    return b"".join(out)


def read_all(blob: bytes, corpus: bytes, workers: int, tag: str):
    """An open reader that has read ``blob`` whole, and the seconds it took."""
    from repro_torch.core import ParallelGzipReader

    t0 = time.perf_counter()
    r = ParallelGzipReader(blob, chunk_size=1 << 20, parallelization=workers)
    try:
        out = r.read()
        secs = time.perf_counter() - t0
        if r.codec.tag != tag:
            raise AssertionError("codec %s, expected %s" % (r.codec.tag, tag))
        if out != corpus:
            raise AssertionError("%s read differs from the corpus" % tag)
    except BaseException:
        r.close()
        raise
    return r, secs


def main_path(seed: int, mib: int, workers: int):
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import crc32 as kc
    from repro_torch.kernels import marker_replace as mr
    from repro_torch.kernels.engine import shared_engine

    corpus = base64_corpus(seed, mib << 20)
    gz = gzip.compress(corpus, 6, mtime=0)
    bz = bgzf(corpus)
    engine = shared_engine("cuda")
    log("reduced: corpus %d MiB, where the paper reads 211 MB (Silesia) to GBs: stage 1 "
        "is pure-Python host decoding at about 0.5 MB/s" % mib)

    mr.reset_launches()
    kc.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r, secs = read_all(gz, corpus, workers, "deflate")
    device = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                     if e.self_device_time_total > 0), key=lambda e: -e[1])
    busy_ms = sum(e[1] for e in device)
    rng = np.random.default_rng(seed + 1)
    with r:
        for _ in range(64):
            off = int(rng.integers(0, len(corpus)))
            size = int(rng.integers(0, 1 << 20))
            if r.pread(off, size) != corpus[off : off + size]:
                raise AssertionError("pread(%d, %d) differs" % (off, size))
        fetcher = r.stats()["fetcher"]
    r_b, secs_b = read_all(bz, corpus, workers, "bgzf")
    r_b.close()
    launches = {"marker_replace": mr.launches, "crc32": kc.launches}
    stats = engine.stats()

    result = {
        "corpus_bytes": len(corpus), "gzip_bytes": len(gz), "bgzf_bytes": len(bz),
        "gzip_s": secs, "gzip_MBps": len(corpus) / secs / 1e6,
        "gzip_device_busy_ms": busy_ms,
        "gzip_device_idle_share": 1 - busy_ms / (secs * 1e3) if busy_ms else None,
        "gzip_device_ops": [{"name": n, "ms": ms, "count": c} for n, ms, c in device],
        "bgzf_s": secs_b, "bgzf_MBps": len(corpus) / secs_b / 1e6,
        "preads": 64, "fetcher": fetcher, "engine": stats, "launches": launches,
        "shapes": {"%s:%d:%d" % k: v for k, v in engine.dispatch_shapes().items()},
    }
    if not (stats["batches"] > 0 and stats["dispatches"] > 0 and stats["errors"] == 0):
        raise AssertionError("engine did not serve the read: %s" % stats)
    if stats["fallbacks"] != {"replace": 0, "crc": 0}:
        raise AssertionError("engine fell back to the CPU: %s" % stats["fallbacks"])
    if min(launches.values()) < 1:
        raise AssertionError("a kernel never launched on the main path: %s" % launches)
    return result, engine


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mib", type=int, default=16, help="corpus size of the main path")
    ap.add_argument("--out", help="also write every result to this JSON file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    log("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0)))

    build_s = _build.build()
    log("build_s %.2f" % build_s)
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log("ptxas %s: %s" % (name, line.strip()))

    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    rows = check_kernels(gen, device)
    for row in rows:
        log(json.dumps(row))

    workers = min(16, os.cpu_count() or 1)
    path, engine = main_path(args.seed, args.mib, workers)
    log("main path: gzip %.3f MB/s, bgzf %.3f MB/s, %d workers"
        % (path["gzip_MBps"], path["bgzf_MBps"], workers))
    log("gzip read: device busy %.3f ms of %.3f s (idle share %s); device ops %s"
        % (path["gzip_device_busy_ms"], path["gzip_s"], path["gzip_device_idle_share"],
           json.dumps(path["gzip_device_ops"])))
    log("engine stats: %s" % json.dumps(path["engine"]))
    log("launches: %s, shapes: %s" % (json.dumps(path["launches"]), json.dumps(path["shapes"])))

    # Each kernel once more at the shape the main path launched it most.
    shapes = engine.dispatch_shapes()
    engine.shutdown()
    rep = max((k for k in shapes if k[0] == "replace"), key=shapes.get)
    crc = max((k for k in shapes if k[0] == "crc"), key=shapes.get)
    at_path = [marker_case(rep[1], rep[2], gen, device), crc_case(crc[1], crc[2], gen, device)]
    for row in at_path:
        log(json.dumps(dict(row, at="main path shape")))

    sources = {
        "marker_replace": ("src/repro_torch/kernels/csrc/marker_replace.cu",
                           "src/repro/kernels/marker_replace.py:101"),
        "crc32": ("src/repro_torch/kernels/csrc/crc32.cu", "src/repro/kernels/crc32.py:117"),
    }
    kernels = []
    for row in at_path:
        name = row["kernel"]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": path["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows + at_path if r["kernel"] == name),
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "card": card, "build_s": build_s, "kernel_rows": rows, "at_path": at_path,
            "main_path": path, "kernels": kernels,
        }, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
