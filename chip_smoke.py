#!/usr/bin/env python3
"""Smoke run of repro_torch on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py [--seed 0] [--mib 16] [--out results.json]

Phases, each fatal on failure:
  1. the card's name and power limit, as nvidia-smi reports them;
  2. build the CUDA kernels from src/repro_torch/kernels/csrc with nvcc;
  3. every kernel against its plain PyTorch version on the card, exact, at
     the engine's shapes, at ragged CRC lanes and at one Silesia-sized
     launch, timed with CUDA events: the kernel and the library call as
     device time (back-to-back launches in a CUDA graph), the wrapper call
     and the plain version as what a caller pays; beside them the memory
     bound, and a near-empty launch timed the same way (launch_floor_ms);
  4. the main path: a base64 corpus (the paper's base64 workload) made from
     --seed, gzip -6 and BGZF, read through
     repro_torch.core.ParallelGzipReader on the default CUDA engine, checked
     byte for byte, with random preads; every kernel must have launched.
     The gzip read runs under torch.profiler (CUDA activity) for the
     device's busy time;
  5. the ops path (repro_torch.kernels.ops): the precode kernel against its
     plain version, exact, at 1 block, a ragged count, an unaligned start,
     a buffer end, the densest survivors of steps 1-3 ((0, 0, 1) repeated),
     the whole gzip of phase 4 and a Silesia-sized launch;
     then, with every count at 0, ops.precode_candidates over that gzip
     (equal as a set to the host finder's candidates, which are timed
     beside it) and over a gzip of the corpus's first MiB (containing every
     dynamic block start the host decoder finds), ops.marker_replace and
     ops.crc32_parallel against the host path and zlib; every kernel of
     the ops path must have launched; last, the steps of
     ops.precode_candidates over the gzip timed apart with CUDA events;
  6. each kernel at the shape its path launched it most;
  7. the service path (repro_torch.service): two base64 corpora made from
     --seed, 8 MiB each, as gzip -6, one opened from a local file
     and one as an http:// URL from a loopback range server (so
     RemoteFileReader is on the path), served by a GatewayServer on
     loopback whose ArchiveServer owns a CUDA engine. Two client threads,
     two tenants, open both archives and read each whole (the first pass,
     under torch.profiler), then 64 random ranges of 4 KiB to 1 MiB; every
     body is checked byte for byte. Then every index is persisted and a
     new gateway over the same IndexStore serves the ranges again with no
     first pass. Fatal: any byte differs, the engine fell back or erred, a
     kernel did not launch in the phase, the engine in metrics() is not
     the server's own, the process-wide shared_engine was reached, or
     /metrics lacks the engine's counters;
  then one JSON line of kernel results and, last, the {"ok": true, ...}
  line.

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
# Integer operation rate: the fp32 67 TFLOP/s counts an FMA as two
# operations on 128 lanes/clk/SM. Integer logic, shifts, adds, compares and
# byte permutes issue on the ALU pipe (64 lanes/clk/SM) and IMAD, which nvcc
# also uses for moves and adds, on the FMA pipe (64 more), so the least time
# for integer work is set by the SM's issue limit of 128 lanes/clk/SM.
INT32_OPS_PER_S = 67e12 / 2
TABLE_SIZE = 256 + 32768
TILE = 8 * 1024
SILESIA_BYTES = 211_938_580  # the Silesia corpus, as one tar
SILESIA_GZ_BYTES = 68_000_000  # about its gzip -6 size
HALO = 74  # bits a precode offset reads
# The least integer work of the precheck, counted on the run's own data (a
# cascade that ends early counts what its inputs need), not this kernel's
# instruction count:
#   * steps 1-3 for every offset, bit-sliced 32 offsets to a word: 7 funnel
#     shifts for the bit planes of header bits 0-2 and 4-7, then 3
#     three-input logic operations (final bit 0, type (0, 1), HLIT < 30);
#   * step 4 only for the offsets that pass them: 2 funnel shifts for the
#     precode bits, 2 to read HCLEN, 3 per precode length read (extract,
#     look the term up, add; HCLEN + 4 of them) and 1 compare.
PRECODE_SLICED_OPS = 10  # per 32 offsets
PRECODE_SURVIVOR_OPS = 5  # per offset passing steps 1-3
PRECODE_LENGTH_OPS = 3  # per precode length such an offset reads


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
# phases 3, 5 and 6: kernels against their plain versions
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


def precode_work(data, start_bit: int, n: int):
    """(offsets passing steps 1-3, precode lengths those offsets read) over
    bits ``start_bit .. start_bit + n`` of ``data`` (uint8), bytes past its
    end reading as zero: the data-dependent part of the precheck's least
    work."""
    import torch
    import torch.nn.functional as F

    d = F.pad(data.to(torch.int64), (0, 4))
    word = d[:-3] | d[1:-2] << 8 | d[2:-1] << 16 | d[3:] << 24  # bits 8 b .. 8 b + 31
    pos = torch.arange(word.numel(), device=data.device, dtype=torch.int64) * 8
    survivors = lengths = 0
    for s in range(8):
        w = word >> s
        at = pos + s
        ok = ((w & 7) == 4) & (((w >> 3) & 31) < 30) & (at >= start_bit) & (at < start_bit + n)
        survivors += int(ok.sum())
        lengths += int((((w >> 13) & 15) + 4).mul_(ok).sum())
    return survivors, lengths


def precode_case(data, start_bit: int, n: int, shape: str, launches: int = 20):
    """The precode kernel against its plain version on ``data`` (uint8 on
    the card), exact, timed like the other kernels."""
    import torch

    from repro_torch.kernels import precode_check as pc

    call = lambda: pc.precode_check_packed(data, start_bit, n)  # noqa: E731
    plain_call = lambda: pc.precode_check_packed_plain(data, start_bit, n)  # noqa: E731
    out, plain = call(), plain_call()
    torch.cuda.synchronize()
    err = int((out.to(torch.int32) - plain.to(torch.int32)).abs().max())
    if not torch.equal(out, plain):
        raise AssertionError("precode kernel != plain at %s (max err %d)" % (shape, err))
    n_read = min(-(-(start_bit + n + HALO) // 8), data.numel()) - start_bit // 8
    survivors, lengths = precode_work(data, start_bit, n)
    ops = (PRECODE_SLICED_OPS * -(-n // 32) + PRECODE_SURVIVOR_OPS * survivors
           + PRECODE_LENGTH_OPS * lengths)
    t_bound, by = bound(n_read + n, ops)
    row = {
        "kernel": "precode_check", "shape": shape, "start_bit": start_bit, "n_offsets": n,
        "n_bytes": data.numel(), "candidates": int(out.sum(dtype=torch.int64)),
        "passed_steps_1_3": survivors, "lengths_read": lengths, "bound_ops": ops,
        "max_abs_err": err,
        "kernel_ms": graph_ms(call, launches),
        "call_ms": median_ms(call, 20),
        "plain_ms": median_ms(plain_call, 3, warmup=1),
        "library_ms": None,
        "bound_ms": t_bound, "bound_by": by,
    }
    del out, plain
    return row


def pattern_bytes(bits, nbits: int, device):
    """``bits`` (0/1, LSB first) repeated over ``nbits`` bits, as uint8 on
    ``device``."""
    import numpy as np
    import torch

    stream = np.resize(np.array(bits, np.uint8), 8 * -(-nbits // 8))
    return torch.from_numpy(np.packbits(stream, bitorder="little")).to(device)


#: (0, 0, 1) repeated: every third offset passes steps 1-3, the most any
#: stream allows (the next pass needs bit o + 2 to be 0), and none the Kraft
#: step: the precode kernel's densest queue.
DENSE_BITS = (0, 0, 1)
DENSE_OFFSETS = 1 << 20


def check_precode(gen, device, gz: bytes):
    import torch

    def rand(nbytes):
        return torch.randint(0, 256, (nbytes,), generator=gen, device=device,
                             dtype=torch.int32).to(torch.uint8)

    rows = [
        precode_case(rand(300), 0, 2048, "1 block"),
        precode_case(rand(660), 0, 5000, "ragged n"),
        precode_case(rand(300), 13, 2049, "unaligned start_bit"),
        precode_case(rand(-(-(5 + 100_000) // 8)), 5, 100_000, "buffer end"),
        precode_case(pattern_bytes(DENSE_BITS, DENSE_OFFSETS + HALO, device), 0, DENSE_OFFSETS,
                     "densest survivors: (0, 0, 1) repeated"),
    ]
    data = torch.frombuffer(bytearray(gz), dtype=torch.uint8).to(device)
    rows.append(precode_case(data, 0, 8 * len(gz) - HALO, "main path: gzip of phase 4"))
    rows.append(precode_case(rand(SILESIA_GZ_BYTES), 0, 8 * SILESIA_GZ_BYTES - HALO,
                             "Silesia-sized: %d random bytes" % SILESIA_GZ_BYTES, launches=5))
    return rows


def launch_floor_ms() -> float:
    """Device time of a near-empty launch (``torch.cuda._sleep(0)``), timed
    like the kernels: what is left of a small launch once its work is gone.
    The port never calls it."""
    import torch

    return graph_ms(lambda: torch.cuda._sleep(0))


def check_kernels(gen, device):
    rows = []
    for n_tiles in (1, 8, 16, 32, 512):  # 8, 16 and 32 x 1 are the engine's buckets
        for n_tables in (1, 8):
            rows.append(marker_case(n_tiles, n_tables, gen, device))
    rows.append(marker_case(32, 8, gen, device, pad=True))
    rows.append(marker_case(-(-SILESIA_BYTES // TILE), 8, gen, device, launches=5))
    for batch in (1, 8, 16):
        rows.append(crc_case(batch, 4096, gen, device))
    rows.append(crc_case(1, 4096, gen, device, unbatched=True))
    rows.append(crc_case(1, 2048, gen, device))  # the gzip read's shape
    # Ragged and unaligned lanes (ops.crc32_parallel passes ceil(n / 1024)),
    # either side of the split threshold (127, 128), and that seg_len for
    # the 12.76 MB gzip of the main path (12464).
    for seg_len in (1, 7, 127, 128, 1000, 4097, 12464):
        rows.append(crc_case(1, seg_len, gen, device))
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
    return result, engine, corpus, gz


# ---------------------------------------------------------------------------
# phase 5: the ops path
# ---------------------------------------------------------------------------

PARTS = ("host_copy", "h2d", "kernel", "nonzero", "d2h", "host_offsets")


def precode_candidates_parts(data: bytes, reps: int = 5) -> dict:
    """``ops.precode_candidates(data)`` over the whole of ``data``, its steps
    (src/repro_torch/kernels/ops.py:86-89) run one by one with a CUDA
    event between each two: the host copy of the bytes it reads, their copy
    to the card, the kernel's wrapper call and the kernel, the
    ``torch.nonzero`` compaction (which waits for the kernel), the copy
    of the offsets back, and the host's int64 offsets. The stream is idle
    around the host steps, so their events time the host. Median ms of
    each part over ``reps`` calls after one warm-up, and of their sum."""
    import numpy as np
    import torch

    from repro_torch.kernels.precode_check import precode_check_packed

    n = 8 * len(data) - HALO
    need = -(-(n + HALO) // 8)
    runs = []
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(PARTS) + 1)]
        ev[0].record()
        raw = np.frombuffer(data, np.uint8, count=need).copy()
        ev[1].record()
        dev = torch.from_numpy(raw).to("cuda")
        ev[2].record()
        mask = precode_check_packed(dev, 0, n)
        ev[3].record()
        hits = torch.nonzero(mask).reshape(-1)
        ev[4].record()
        host = hits.cpu()
        ev[5].record()
        offsets = host.numpy().astype(np.int64)
        ev[6].record()
        ev[6].synchronize()
        runs.append([ev[i].elapsed_time(ev[i + 1]) for i in range(len(PARTS))])
        del raw, dev, mask, hits, host, offsets
    runs = runs[1:]
    out = {name: statistics.median(r[i] for r in runs) for i, name in enumerate(PARTS)}
    out["sum"] = statistics.median(sum(r) for r in runs)
    return out


def ops_path(seed: int, corpus: bytes, gz: bytes):
    """The kernel-level entry points on the card, checked against the host.

    The host's answers are made first; then every launch count is set to 0,
    the three entry points run, and the counts are read."""
    import numpy as np
    import torch

    from repro_torch.core import BitReader, DeflateChunkDecoder, parse_gzip_header
    from repro_torch.core.block_finder import scan_dynamic_candidates
    from repro_torch.core.markers import replace_markers
    from repro_torch.kernels import crc32 as kc
    from repro_torch.kernels import marker_replace as mr
    from repro_torch.kernels import ops
    from repro_torch.kernels import precode_check as pc

    end = 8 * len(gz) - HALO
    t0 = time.perf_counter()
    host = [c for c in scan_dynamic_candidates(gz, 0, 8 * len(gz), full_validation=False)
            if c < end]
    host_s = time.perf_counter() - t0
    head = gzip.compress(corpus[: 1 << 20], 6, mtime=0)
    br = BitReader(head)
    parse_gzip_header(br)
    blocks = DeflateChunkDecoder(head).decode_chunk(br.bit_pos, len(head) * 8, window=b"").blocks
    dynamic = [b.bit_offset for b in blocks if b.block_type == 2 and not b.is_final]
    if not dynamic:
        raise AssertionError("the host decoder found no dynamic block in the first MiB")
    rng = np.random.default_rng(seed + 2)
    window = rng.integers(0, 256, 32768, dtype=np.uint8).tobytes()
    syms = rng.integers(0, TABLE_SIZE, 1 << 20, dtype=np.int64).astype(np.uint16)
    blobs = [corpus[: 1 << 20], gz, b"", b"x"]

    for mod in (pc, mr, kc):
        mod.reset_launches()
    t0 = time.perf_counter()
    cands = ops.precode_candidates(gz)
    cands_s = time.perf_counter() - t0
    head_cands = set(ops.precode_candidates(head).tolist())
    replaced = ops.marker_replace(syms, window)
    crcs = [ops.crc32_parallel(b) for b in blobs]
    torch.cuda.synchronize()
    launches = {"precode_check": pc.launches, "marker_replace": mr.launches, "crc32": kc.launches}

    if set(cands.tolist()) != set(host):
        raise AssertionError("precode_candidates: %d candidates, the host finder %d"
                             % (cands.size, len(host)))
    missing = [b for b in dynamic if b not in head_cands]
    if missing:
        raise AssertionError("precode_candidates misses dynamic blocks at %s" % missing[:8])
    if not np.array_equal(replaced, replace_markers(syms, window)):
        raise AssertionError("ops.marker_replace differs from the host path")
    if crcs != [zlib.crc32(b) for b in blobs]:
        raise AssertionError("ops.crc32_parallel differs from zlib")
    if min(launches.values()) < 1:
        raise AssertionError("a kernel never launched on the ops path: %s" % launches)
    return {
        "gzip_bytes": len(gz), "offsets": end, "candidates": len(host),
        "host_finder_s": host_s, "precode_candidates_s": cands_s,
        "precode_candidates_ms": median_ms(lambda: ops.precode_candidates(gz), 5),
        "precode_candidates_parts_ms": precode_candidates_parts(gz),
        "head_gzip_bytes": len(head), "head_dynamic_blocks": len(dynamic),
        "launches": launches,
    }


# ---------------------------------------------------------------------------
# phase 7: the service path
# ---------------------------------------------------------------------------

SERVICE_MIB = 8  # each of the two archives; 2 tenants x 2 first passes at ~0.5 MB/s in all
TENANTS = 2
RANGES_PER_ARCHIVE = 64
RANGE_SIZES = (4 << 10, 32 << 10, 256 << 10, 1 << 20)
ENGINE_SERIES = ("repro_engine_batches", "repro_engine_dispatches",
                 "repro_engine_requests_replace", "repro_engine_requests_crc",
                 "repro_engine_fallbacks_replace", "repro_engine_fallbacks_crc",
                 "repro_engine_errors")


def http_call(base: str, method: str, path: str, headers=None, body=None, timeout=900.0):
    """One request on a fresh loopback connection: (status, headers, body)."""
    import http.client
    import urllib.parse

    url = urllib.parse.urlsplit(base)
    conn = http.client.HTTPConnection(url.hostname, url.port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp.read()
    finally:
        conn.close()


def run_tenants(fn, tenants: int, timeout: float = 900.0):
    """``fn(t)`` in one thread per tenant; re-raises the first failure."""
    import threading

    out, errors = [None] * tenants, []

    def body(t):
        try:
            out[t] = fn(t)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=body, args=(t,), name="tenant-%d" % t)
               for t in range(tenants)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout)
    if any(th.is_alive() for th in threads):
        raise AssertionError("a tenant thread did not finish in %.0f s" % timeout)
    if errors:
        raise errors[0]
    return out


def quantiles_ms(samples):
    import numpy as np

    a = np.asarray(samples) * 1e3
    return {"n": len(samples), "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99))}


def check_server_engine(gw, label: str) -> dict:
    """The engine behind ``gw`` is its server's own CUDA engine, owned by
    it, resolved every reader's stage 2, and is the one in ``metrics()``;
    it neither fell back nor erred. Returns its stats."""
    srv = gw.server
    engine = srv.device_engine
    if not srv._owns_engine or engine.device.type != "cuda":  # noqa: SLF001
        raise AssertionError("%s: the server does not own a CUDA engine" % label)
    for handle, entry in list(srv._entries.items()):  # noqa: SLF001
        reader = entry.reader
        if reader is not None and reader._fetcher.resolver is not engine:  # noqa: SLF001
            raise AssertionError("%s: reader %s resolves through another engine" % (label, handle))
    stats = engine.stats()
    snap = json.loads(http_call(gw.url, "GET", "/v1/metrics")[2])["engine"]
    for key in ("requests", "batches", "dispatches", "crc_bytes", "tiles_dispatched"):
        if snap[key] != stats[key]:
            raise AssertionError("%s: metrics()['engine'][%r] = %s, the server's engine %s"
                                 % (label, key, snap[key], stats[key]))
    if stats["errors"] or stats["fallbacks"] != {"replace": 0, "crc": 0}:
        raise AssertionError("%s: engine errors %s, fallbacks %s"
                             % (label, stats["errors"], stats["fallbacks"]))
    return stats


def check_prometheus(gw, label: str) -> dict:
    status, headers, body = http_call(gw.url, "GET", "/metrics")
    if status != 200 or not headers.get("content-type", "").startswith("text/plain"):
        raise AssertionError("%s: /metrics answered %s %s" % (label, status, headers))
    values = {}
    for line in body.decode().splitlines():
        name, _, value = line.partition(" ")
        if name in ENGINE_SERIES:
            values[name] = float(value)
    missing = [n for n in ENGINE_SERIES if n not in values]
    if missing:
        raise AssertionError("%s: /metrics lacks the engine's %s" % (label, missing))
    return values


def service_path(seed: int, card: str):
    """Phase 7: the archive service on the card, driven over HTTP."""
    import shutil
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT / "tests"))
    from _range_server import RangeHTTPServer

    from repro_torch.kernels import engine as tengine
    from repro_torch.service import IndexStore
    from repro_torch.service.gateway import GatewayServer, TenantAdmission

    corpora = [base64_corpus(seed + 10 + i, SERVICE_MIB << 20) for i in range(2)]
    blobs = [gzip.compress(c, 6, mtime=0) for c in corpora]
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="service-", dir=ROOT / "build"))
    local = work / "corpus-0.gz"
    local.write_bytes(blobs[0])
    tokens = {"tok-%d" % t: "tenant-%d" % t for t in range(TENANTS)}

    def start_gateway():
        return GatewayServer(
            device="cuda", max_workers=8, cache_budget_bytes=256 << 20, chunk_size=1 << 20,
            reader_parallelization=4, stream_span=1 << 20,
            admission=TenantAdmission(tokens=tokens, default_tenant=None),
            index_store=IndexStore(str(work / "index")),
        ).start()

    rng = np.random.default_rng(seed + 3)
    per_size = RANGES_PER_ARCHIVE // len(RANGE_SIZES)
    plans = [[[(int(rng.integers(0, len(c) - size + 1)), int(size))
               for size in rng.permutation(np.repeat(RANGE_SIZES, per_size))]
              for c in corpora] for _ in range(TENANTS)]

    # The process-wide engine must stay out of the phase: count calls to it
    # and keep what it held before.
    shared_before = dict(tengine._shared)  # noqa: SLF001
    shared_calls = []
    real_shared = tengine.shared_engine
    tengine.shared_engine = lambda dev="cuda": shared_calls.append(dev) or real_shared(dev)
    remote = RangeHTTPServer(blobs[1])
    gateways = []
    try:
        sources = [str(local), remote.url]

        def open_all(gw, t):
            auth = {"Authorization": "Bearer tok-%d" % t}
            handles = []
            for src in sources:
                status, _, body = http_call(gw.url, "POST", "/v1/archives", dict(
                    auth, **{"Content-Type": "application/json"}), json.dumps({"source": src}))
                if status != 201:
                    raise AssertionError("open %s: %s %s" % (src, status, body[:200]))
                handles.append(json.loads(body)["handle"])
            return auth, handles

        def get(gw, auth, handle, off, size, corpus):
            t0 = time.perf_counter()
            status, headers, body = http_call(
                gw.url, "GET", "/v1/archives/%s/bytes" % handle,
                dict(auth, Range="bytes=%d-%d" % (off, off + size - 1)))
            secs = time.perf_counter() - t0
            if status != 206 or body != corpus[off : off + size]:
                raise AssertionError("GET %s bytes=%d+%d: status %s, %d bytes differ from "
                                     "the corpus" % (handle, off, size, status, len(body)))
            return secs

        def ranges(gw, opened, t):
            auth, handles = opened[t]
            lat = {size: [] for size in RANGE_SIZES}
            for a, handle in enumerate(handles):
                for off, size in plans[t][a]:
                    lat[size].append(get(gw, auth, handle, off, size, corpora[a]))
            return lat

        # Server 1: cold opens, the first pass over HTTP, then warm ranges.
        gw = start_gateway()
        gateways.append(gw)
        opened = [open_all(gw, t) for t in range(TENANTS)]

        def first_pass(t):
            auth, handles = opened[t]
            order = range(len(handles)) if t % 2 == 0 else reversed(range(len(handles)))
            return {a: get(gw, auth, handles[a], 0, len(corpora[a]), corpora[a]) for a in order}

        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            first = run_tenants(first_pass, TENANTS)
        first_s = time.perf_counter() - t0
        device_ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                             for e in prof.key_averages() if e.self_device_time_total > 0),
                            key=lambda e: -e[1])
        busy_ms = sum(e[1] for e in device_ops)
        warm = run_tenants(lambda t: ranges(gw, opened, t), TENANTS)
        stats1 = check_server_engine(gw, "server 1")
        prom1 = check_prometheus(gw, "server 1")
        fetcher1 = gw.server.metrics()["fleet"]["fetcher"]
        shapes = {"%s:%d:%d" % k: v for k, v in gw.server.device_engine.dispatch_shapes().items()}
        keys = []
        for t in range(TENANTS):
            for handle in opened[t][1]:
                key = gw.server.persist_index(handle)
                if key is None:
                    raise AssertionError("persist_index(%s): no finalized index" % handle)
                keys.append(key)
        engine1 = gw.server.device_engine
        gw.close()
        if not engine1.stats()["closed"]:
            raise AssertionError("server 1's engine outlived its server")

        # Server 2: the same IndexStore, so every open is warm; no first pass.
        gw = start_gateway()
        gateways.append(gw)
        opened = [open_all(gw, t) for t in range(TENANTS)]
        cold = run_tenants(lambda t: ranges(gw, opened, t), TENANTS)
        stats2 = check_server_engine(gw, "server 2")
        prom2 = check_prometheus(gw, "server 2")
        metrics2 = gw.server.metrics()
        not_warm = [h for h, f in metrics2["per_file"].items() if not f["index_was_warm"]]
        nominal = metrics2["fleet"]["fetcher"]["nominal_tasks"]
        if not_warm or nominal:
            raise AssertionError("server 2 ran a first pass: handles %s not warm, %d nominal "
                                 "tasks" % (not_warm, nominal))
        if gw.server.device_engine is engine1:
            raise AssertionError("server 2 reused server 1's engine")
    finally:
        tengine.shared_engine = real_shared
        for g in gateways:
            g.close()
        remote.close()
        shutil.rmtree(work, ignore_errors=True)
    shared_after = dict(tengine._shared)  # noqa: SLF001
    if shared_calls or shared_after.keys() != shared_before.keys() or any(
            shared_after[k] is not v for k, v in shared_before.items()):
        raise AssertionError("the process-wide shared_engine was reached in the phase: calls %s"
                             % shared_calls)

    mbps = {}
    for t in range(TENANTS):
        for a, secs in first[t].items():
            mbps["tenant-%d/%s" % (t, ("local", "http")[a])] = len(corpora[a]) / secs / 1e6
    latency = {}
    for label, runs in (("warm", warm), ("cold", cold)):
        for size in RANGE_SIZES:
            latency["%s/%d" % (label, size)] = quantiles_ms(
                [x for run in runs for x in run[size]])
    return {
        "card": card, "tenants": TENANTS, "corpus_bytes": [len(c) for c in corpora],
        "gzip_bytes": [len(b) for b in blobs], "ranges_per_archive": RANGES_PER_ARCHIVE,
        "first_pass_s": first_s, "first_pass_MBps": mbps,
        "first_pass_device_busy_ms": busy_ms,
        "first_pass_device_idle_share": 1 - busy_ms / (first_s * 1e3) if busy_ms else None,
        "first_pass_device_ops": [{"name": n, "ms": ms, "count": c} for n, ms, c in device_ops],
        "pread_latency": latency, "engine": stats1, "engine_cold_server": stats2,
        "shapes": shapes, "fetcher": fetcher1, "persisted": len(keys),
        "prometheus": {"server 1": prom1, "server 2": prom2},
    }


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
    floor_ms = launch_floor_ms()
    log("launch_floor_ms %.6f" % floor_ms)
    rows = check_kernels(gen, device)
    for row in rows:
        log(json.dumps(row))

    workers = min(16, os.cpu_count() or 1)
    path, engine, corpus, gz = main_path(args.seed, args.mib, workers)
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

    precode_rows = check_precode(gen, device, gz)
    for row in precode_rows:
        log(json.dumps(row))
    ops = ops_path(args.seed, corpus, gz)
    log("ops path: host finder %.3f s, ops.precode_candidates %.6f s (median %.3f ms) over %d "
        "offsets, %d candidates; first MiB: %d dynamic blocks, all among the candidates; "
        "launches %s" % (ops["host_finder_s"], ops["precode_candidates_s"],
                         ops["precode_candidates_ms"], ops["offsets"], ops["candidates"],
                         ops["head_dynamic_blocks"], json.dumps(ops["launches"])))
    log("ops.precode_candidates parts, median ms (CUDA events): %s"
        % json.dumps(ops["precode_candidates_parts_ms"]))
    at_path.append(next(r for r in precode_rows if r["shape"].startswith("main path")))

    from repro_torch.kernels import crc32 as kc
    from repro_torch.kernels import marker_replace as mr

    mr.reset_launches()
    kc.reset_launches()
    service = service_path(args.seed, card)
    service["launches"] = {"marker_replace": mr.launches, "crc32": kc.launches}
    if min(service["launches"].values()) < 1:
        raise AssertionError("a kernel never launched on the service path: %s"
                             % service["launches"])
    log("service path [%s]: %d tenants over HTTP, 2 archives of %d bytes (gzip %s), first "
        "pass %.3f s, MB/s %s" % (card, service["tenants"], service["corpus_bytes"][0],
                                   service["gzip_bytes"], service["first_pass_s"],
                                   json.dumps(service["first_pass_MBps"])))
    log("service path [%s]: first passes device busy %.3f ms (idle share %s); device ops %s"
        % (card, service["first_pass_device_busy_ms"], service["first_pass_device_idle_share"],
           json.dumps(service["first_pass_device_ops"])))
    log("service path [%s]: pread latency by range size, warm (server 1, after its first "
        "pass) and cold (server 2, index from the store): %s"
        % (card, json.dumps(service["pread_latency"])))
    log("service path [%s]: engine batches %d, dispatches %d, requests %s, fallbacks %s, "
        "errors %d; launches %s; shapes %s; server 2 engine requests %s"
        % (card, service["engine"]["batches"], service["engine"]["dispatches"],
           json.dumps(service["engine"]["requests"]), json.dumps(service["engine"]["fallbacks"]),
           service["engine"]["errors"], json.dumps(service["launches"]),
           json.dumps(service["shapes"]), json.dumps(service["engine_cold_server"]["requests"])))

    sources = {
        "marker_replace": ("src/repro_torch/kernels/csrc/marker_replace.cu",
                           "src/repro/kernels/marker_replace.py:101"),
        "crc32": ("src/repro_torch/kernels/csrc/crc32.cu", "src/repro/kernels/crc32.py:117"),
        "precode_check": ("src/repro_torch/kernels/csrc/precode_check.cu",
                          "src/repro/kernels/precode_check.py:83"),
    }
    # Each kernel's launches on its own path: the gzip read for stage 2, the
    # ops path for the precheck.
    path_launches = dict(path["launches"], precode_check=ops["launches"]["precode_check"])
    checked = rows + at_path + precode_rows
    kernels = []
    for row in at_path:
        name = row["kernel"]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": path_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in checked if r["kernel"] == name),
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "card": card, "build_s": build_s, "launch_floor_ms": floor_ms, "kernel_rows": rows,
            "at_path": at_path, "main_path": path, "precode_rows": precode_rows, "ops_path": ops,
            "service_path": service, "kernels": kernels,
        }, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
