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
  8. the fleet (repro_torch.service.fleet): an 8 MiB base64 corpus made
     from --seed + 20, gzip -6, in a local file; three GatewayServers,
     each over its own ArchiveServer with a CUDA engine and its own
     IndexStore, the stores cross-wired by make_index_fallback, behind a
     FleetRouter(eject_after=1). The archive is streamed in 64 KiB reads
     under torch.profiler; after 1 MiB its owner is killed with close()
     while the router's client holds its connection, and the stream must
     finish on the next peer bit for bit. The third peer then opens the
     archive warm from its peers' index and serves 64 seeded ranges of
     4 KiB to 1 MiB, each checked. Fatal: the kill's close() takes over
     1 s or leaves its engine open, a surviving peer's engine is not its
     own or fell back or erred, a first-pass peer's engine did not
     dispatch both kernels, shared_engine was reached, or a kernel did not
     launch in the phase;
  9. the corpus pipeline (repro_torch.data, the paper's §1.1 deployment):
     four base64 shards of 2 MiB made from --seed + 30..33, gzip -6, three
     local files and one http:// URL; one epoch of
     GzipCorpusDataset(seq_len=2048, batch_size=8, device="cuda") over an
     IndexStore under torch.profiler, whose tokens must reproduce the
     shards in order; the state saved in the middle of the http:// shard is
     restored by a new dataset over the warm store, whose next 8 batches
     must equal the first run's with no first pass. Fatal: a kernel did
     not launch, or the engine erred or fell back;
 10. the serve path (repro_torch.models, repro_torch.serve): granite-3-2b
     at full width (40 layers, d_model 2048, vocab 49 155, bf16, random
     weights from --seed + 40) built on the card; make_serve_steps prefills
     4 prompts of 512 tokens and greedy-decodes 64 tokens, and after each
     decode step every sequence reads 512 bytes of one of two 1 MiB base64
     gzip shards (--seed + 41, + 42) through an ArchiveServer(device="cuda")
     at the addresses of examples/serve_batched.py, each checked; 8 more
     steps run with no reads beside them and 16 more, reads included,
     under torch.profiler for the device's idle share. The decode
     logits are held to the train-mode forward of the same 576 tokens at
     rtol = atol = 5e-2 and reported: the served bf16 run, its first 1-8
     layers, and the whole model in fp32 and fp64 (the JAX package's init
     makes attention nearly hard at this width: a rounding flips keys, and
     the flip carries through every later layer). Fatal: each layer of
     each decode step against the forward's, fed the forward's input to
     that layer, in fp64 (reported in bf16). Then the seven other decoder
     configs, xlstm-350m and whisper-tiny at smoke width: prefill plus
     decode against the forward in bf16, and the card against the same
     module on the host in bf16 (reported) and fp64 (fatal). Fatal: a byte
     differs, the engine fell back or erred, a kernel did not launch in the
     phase, a model tensor lies off the card, shared_engine was reached, or
     a check misses. Then xlstm-350m (24 blocks, d_model 1024, vocab
     50 304; --seed + 60) and whisper-tiny (4 + 4 layers, d_model 384,
     1 500 stub frames from the seed, vocab 51 865; --seed + 61) at full
     width: 4 prompts (512 tokens; 64 for Whisper) prefilled, 32 greedy
     decode steps, the decode logits against the teacher-forced forward in
     bf16 (reported; the xLSTM's first step also against the prefill of
     the longer prefix), and in fp64 each xLSTM block's recurrent steps
     against its chunkwise form and each Whisper decoder layer's decode
     steps against its forward, fed the forward's input (fatal at rtol =
     atol = 1e-6);
 11. the train path (repro_torch.launch.train.run, the driver's entry):
     granite-3-2b at full width (40 layers, 2 533 531 648 parameters,
     --seed + 70), batch 8 x seq 128, 12 timed steps and 2 more under
     torch.profiler over make_corpus shards read by
     GzipCorpusDataset(device="cuda") on the process-wide engine; then at
     full width and 2 layers (--seed + 80): an unbroken run of 12 steps, the
     same weights preempted after 6 (save_checkpoint), a model from another
     seed and a new dataset restored (restore_checkpoint) for the other 6,
     grad_accum=2 against 1 from one state, and 6 steps with compressed
     gradients; then xlstm-350m and whisper-tiny at full width, 4 steps
     each. Fatal: a loss not finite, a parameter, gradient or moment off
     the card, a kernel that did not launch, the engine erred or fell back,
     a restored leaf not bit-equal to the saved one, a batch after the
     restore not equal to the unbroken run's, a resumed loss more than
     1e-3 from the unbroken run's, or grad_accum=2 outside rtol 3e-2, atol
     3e-3 of 1;
 12. the mesh (repro_torch.launch.mesh, repro_torch.distributed):
     make_host_mesh() on the card, an NCCL group of one rank, (data,
     model) = (1, 1), where every collective is skipped and the step is the
     one-card step operation for operation. granite-3-2b at full width
     through repro_torch.launch.train.run (which builds that mesh) on phase
     11's shards: 2 layers for 12 steps from phase 11's seed, held to its
     unbroken run's losses; 40 layers for 6 timed steps and 2 profiled;
     2 layers for 6 steps with compressed gradients through
     make_train_step(model, mesh, rules, ...), held to phase 11's
     compressed losses; compressed_psum of a [vocab, d_model] fp32 tensor
     over the NCCL group against compress/decompress; then
     make_serve_steps(model, mesh, rules, ...) on phase 10's weights and
     prompts for 16 greedy steps, held to phase 10's tokens and logits.
     Fatal: the group is not NCCL, a loss more than 1e-3 from phase 11's,
     decode tokens not phase 10's or logits past its 5e-2 bound,
     compressed_psum not the round trip, a parameter, gradient, moment or
     cache off the card, a kernel that did not launch, or the engine erred
     or fell back;
 13. remat and the roofline (repro_torch.launch.dryrun, .roofline): (a)
     granite-3-2b at full width and 2 layers, batch 2 x seq 4096, the
     trainer's forward and backward under each policy once untimed, then
     under none, dots, full, dots, none on the same weights and batch; at 40
     layers and phase 11's 8 x 128 tokens, none, dots, dots, none (the
     host's share: the step is host-bound there); (b) the
     dry-run's estimates of the one-card step (mesh (1, 1) over a fake
     group, 40 layers, seq 4096) at batch 1-4, each in a worker process on
     the host, and granite-3-2b at its 40 layers through
     repro_torch.launch.train.run on phase 11's shards at the largest
     batch estimated under 72 GB, 2 warm, 4 timed and 1 profiled step,
     beside the estimate's memory, FLOPs and roofline terms; (c) rank 0 of
     three production cells on (16, 16) over a fake group of 256, each in
     a worker process, on real tensors on the card (the collectives move
     nothing; a gather's other blocks are filled with this rank's own),
     beside the dry-run's estimate of the same cut cell, made in worker
     processes on the host from phase 11 on: granite-3-2b train_4k
     cut to 2 layers, one warm and one measured train step; xlstm-350m
     train_4k at full width cut to one group of 8 blocks and 8 rows a
     rank, the same; hymba-1.5b decode_32k at full width cut to 2 layers,
     its ring split 64 slots a rank: a prefill of 1 084 tokens and 8
     decode steps on slots 60-67, steps 2-8 measured. Fatal: a loss or
     gradient norm (1e-4) that differs from none's, dots' memory not below
     none's, no batch under the budget, a loss or logit not finite, a
     kernel that did not launch, a tensor off the card, the engine erred
     or fell back, or a cell not on a fake group of 256 on the card (a
     NotImplementedError ends the worker, which is fatal too);
 14. routing and examples: (a) tools/engine_sweep.py's sweep on the card
     (the reference's kernel_engine_* rows: the host's marker gather and
     zlib against ops.marker_replace and TorchDecodeEngine at 1-64 chunks),
     each row printed beside the committed results/engine_sweep_h100.json's
     and the crossover each gives; (b) a TorchDecodeEngine(crossover="auto")
     whose crossover must be derive_crossover over the artifact's rows;
     marker and CRC requests of seeded sizes, one below and one at or
     above each kind's threshold (both to the host when it is None), each
     of which must land where the crossover says (by the engine's
     fallbacks and dispatch shapes) and equal the host path and zlib byte
     for byte; then a 4 MiB base64 gzip from --seed + 140 read through
     ParallelGzipReader(resolver=<that engine>) and 64 random preads, all
     exact, with the engine's routed counts; (c) examples/quickstart_torch.py,
     serve_gateway_torch.py and serve_fleet_torch.py with --device cuda,
     each in its own process, started together while (b) runs. Fatal: a
     sweep row missing, a request landing on the wrong side, a byte that
     differs, an example's non-zero exit, the engine erred, or a stage-2
     kernel that did not launch in the phase;
  then one JSON line of kernel results and, last, the {"ok": true, ...}
  line.

Without a CUDA device, or without the rest of the repository beside it, the
script exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import gzip
import json
import math
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


def stage2_launches() -> dict:
    """Launches of the stage-2 kernels since their last reset; ``crc32``
    counts both forms, ``crc32_fold`` the folding one alone."""
    from repro_torch.kernels import crc32 as kc
    from repro_torch.kernels import marker_replace as mr

    return {"marker_replace": mr.launches, "crc32": kc.launches, "crc32_fold": kc.fold_launches}


def unlaunched(launches: dict) -> list:
    """Kernels of a path's launch counts that never launched; ``crc32_fold``
    is the folding form, already counted in ``crc32``."""
    return [k for k, n in launches.items() if k != "crc32_fold" and n < 1]


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


def crc_case(batch: int, seg_len: int, gen, device, unbatched: bool = False,
             fold: bool = False):
    """The CRC launch against its plain version and zlib; with ``fold`` the
    folding launch (``crc32_fold_batched``, every lane of every row folded),
    whose words are held to zlib's CRC of each whole row as well."""
    import torch

    from repro_torch.kernels import crc32 as kc
    from repro_torch.kernels.ref import make_crc_table

    data = torch.randint(0, 256, (batch, 8, 128, seg_len), generator=gen, device=device,
                         dtype=torch.int32).to(torch.uint8)
    table = make_crc_table().to(device)
    full = [kc.N_SEGMENTS] * batch
    if unbatched:
        call = lambda: kc.crc32_segments(data[0], table)  # noqa: E731
        plain_call = lambda: kc.crc32_segments_batched_plain(data, table)[0]  # noqa: E731
    elif fold:
        call = lambda: kc.crc32_fold_batched(data, table, full)  # noqa: E731
        plain_call = lambda: kc.crc32_fold_batched_plain(data, table, full)  # noqa: E731
    else:
        call = lambda: kc.crc32_segments_batched(data, table)  # noqa: E731
        plain_call = lambda: kc.crc32_segments_batched_plain(data, table)  # noqa: E731
    got, want = call(), plain_call()
    torch.cuda.synchronize()
    out, plain = (got[0], want[0]) if fold else (got, want)
    err = int((out.to(torch.int64) - plain.to(torch.int64)).abs().max())
    if not torch.equal(out, plain) or (fold and not torch.equal(got[1], want[1])):
        raise AssertionError("crc kernel != plain at B=%d seg_len=%d" % (batch, seg_len))
    host = data.view(-1, seg_len)[:4].cpu().numpy()
    got_lanes = out.reshape(-1)[:4].cpu().numpy().astype("uint32")
    if [zlib.crc32(lane.tobytes()) for lane in host] != [int(x) for x in got_lanes]:
        raise AssertionError("crc kernel != zlib at B=%d seg_len=%d" % (batch, seg_len))
    if fold and int(got[1][0].item()) & 0xFFFFFFFF != zlib.crc32(data[0].cpu().numpy().tobytes()):
        raise AssertionError("crc fold != zlib at B=%d seg_len=%d" % (batch, seg_len))
    n = data.numel()
    t_bound, by = bound(n + 1024 + 4 * batch * 1024 + (4 * batch if fold else 0), 4 * n)
    return {
        "kernel": "crc32", "batch": batch, "seg_len": seg_len, "unbatched": unbatched,
        "fold": fold, "max_abs_err": err,
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
    # The folding launch the engine makes: the read's shape, a full batch,
    # and one thread a lane.
    for batch, seg_len in ((1, 2048), (16, 4096), (16, 7)):
        rows.append(crc_case(batch, seg_len, gen, device, fold=True))
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
    launches = stage2_launches()
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
    if unlaunched(launches):
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
    launches = dict(stage2_launches(), precode_check=pc.launches)

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
    if unlaunched(launches):
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


@contextlib.contextmanager
def shared_engine_untouched():
    """Fails, once the block is left without an error, if anything in it
    reached the process-wide ``shared_engine``: a call, or a change to the
    engines it holds."""
    from repro_torch.kernels import engine as tengine

    before = dict(tengine._shared)  # noqa: SLF001
    calls = []
    real = tengine.shared_engine
    tengine.shared_engine = lambda dev="cuda": calls.append(dev) or real(dev)
    try:
        yield
    finally:
        tengine.shared_engine = real
    after = dict(tengine._shared)  # noqa: SLF001
    if calls or after.keys() != before.keys() or any(
            after[k] is not v for k, v in before.items()):
        raise AssertionError("the process-wide shared_engine was reached in the phase: calls %s"
                             % calls)


def service_path(seed: int, card: str):
    """Phase 7: the archive service on the card, driven over HTTP."""
    import shutil
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT / "tests"))
    from _range_server import RangeHTTPServer

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
        for g in gateways:
            g.close()
        remote.close()
        shutil.rmtree(work, ignore_errors=True)

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

# ---------------------------------------------------------------------------
# phase 8: the fleet
# ---------------------------------------------------------------------------

FLEET_PEERS = 3
FLEET_READ = 64 << 10  # the client's read size and the gateways' stream span
FLEET_KILL_AT = 1 << 20  # stream bytes before the owner is killed
FLEET_RANGES = 64


def engine_kinds(engine) -> set:
    """The stage-2 kinds ("replace", "crc") ``engine`` dispatched."""
    return {k[0] for k in engine.dispatch_shapes()}


def fleet_path(seed: int, card: str):
    """Phase 8: three gateway peers, each over its own ArchiveServer and
    CUDA engine and its own IndexStore (the stores cross-wired by
    make_index_fallback), behind a FleetRouter. The owner of the archive is
    killed mid-stream; the stream must finish on the next peer bit for bit;
    the third peer must then open warm from its peers' index."""
    import shutil
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import crc32 as kc
    from repro_torch.kernels import marker_replace as mr
    from repro_torch.service import IndexStore
    from repro_torch.service.fleet import FleetRouter, make_index_fallback
    from repro_torch.service.gateway import GatewayClient, GatewayServer

    corpus = base64_corpus(seed + 20, SERVICE_MIB << 20)
    blob = gzip.compress(corpus, 6, mtime=0)
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="fleet-", dir=ROOT / "build"))
    path = work / "corpus.gz"
    path.write_bytes(blob)
    rng = np.random.default_rng(seed + 4)
    per_size = FLEET_RANGES // len(RANGE_SIZES)
    plan = [(int(rng.integers(0, len(corpus) - size + 1)), int(size))
            for size in rng.permutation(np.repeat(RANGE_SIZES, per_size))]

    gws, router, clients = [], None, []
    mr.reset_launches()
    kc.reset_launches()
    try:
        for i in range(FLEET_PEERS):
            gws.append(GatewayServer(
                device="cuda", max_workers=8, cache_budget_bytes=256 << 20,
                chunk_size=1 << 20, reader_parallelization=4, stream_span=FLEET_READ,
                index_store=IndexStore(str(work / ("index-%d" % i))),
            ).start())
        urls = [gw.url for gw in gws]
        for i, gw in enumerate(gws):
            gw.server.index_store.set_remote_fallback(make_index_fallback(urls, exclude=[urls[i]]))
        router = FleetRouter(urls, eject_after=1)

        # 1-2. Stream the archive; kill its owner after FLEET_KILL_AT bytes
        # while the router's client holds the connection. The open's HEAD
        # asks the owner for the size, which runs its whole first pass; after
        # the kill, the survivor's open does the same.
        t_start = time.perf_counter()
        c = router.open(str(path))
        clients.append(c)
        open_s = time.perf_counter() - t_start
        owner = next(gw for gw in gws if gw.url == c.peer)
        owner_engine = owner.server.device_engine
        got, n, t_kill, close_s, gap_s, n_kill, stall_s = [], 0, None, None, None, None, 0.0
        t_start = t_last = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for chunk in c.stream(read_size=FLEET_READ):
                now = time.perf_counter()
                if t_kill is not None:
                    if gap_s is None:
                        gap_s = now - t_kill
                    stall_s = max(stall_s, now - t_last)
                t_last = now
                got.append(chunk)
                n += len(chunk)
                if t_kill is None and n >= FLEET_KILL_AT:
                    n_kill = n
                    owner_kinds = engine_kinds(owner_engine)
                    owner_stats = owner_engine.stats()
                    t_kill = time.perf_counter()
                    owner.close()
                    close_s = time.perf_counter() - t_kill
                    t_last = time.perf_counter()
        t_end = time.perf_counter()
        device_ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                             for e in prof.key_averages() if e.self_device_time_total > 0),
                            key=lambda e: -e[1])
        busy_ms = sum(e[1] for e in device_ops)
        if t_kill is None:
            raise AssertionError("the stream ended before the owner was killed")
        if close_s > 1.0:
            raise AssertionError("killing the owner: close() took %.3f s" % close_s)
        if not owner_engine.stats()["closed"]:
            raise AssertionError("the killed owner's engine is still open")
        if b"".join(got) != corpus:
            raise AssertionError("the stream across the owner's death differs from the corpus")
        if c.stats["failovers"] < 1 or c.stats["resumed_streams"] < 1:
            raise AssertionError("no failover in the stream: %s" % c.stats)
        survivor = next(gw for gw in gws if gw.url == c.peer)
        if survivor is owner:
            raise AssertionError("the stream ended on the killed owner")
        survivor_kinds = engine_kinds(survivor.server.device_engine)
        if owner_kinds != {"replace", "crc"} or survivor_kinds != {"replace", "crc"}:
            raise AssertionError("a first-pass peer's engine did not dispatch both kernels: "
                                 "owner %s, survivor %s" % (owner_kinds, survivor_kinds))
        client_stats = dict(c.stats)
        c.close()  # closes the survivor's handle, which persists its index

        # 3. The third peer never saw the archive: its open imports the
        # index from a peer, then serves seeded ranges.
        third = next(gw for gw in gws if gw is not owner and gw is not survivor)
        t0 = time.perf_counter()
        g = GatewayClient(third.url, source=str(path))
        clients.append(g)
        stat = g.stat()
        warm_open_s = time.perf_counter() - t0
        lat = {size: [] for size in RANGE_SIZES}
        for off, size in plan:
            t0 = time.perf_counter()
            status, _, body = http_call(third.url, "GET", "/v1/archives/%s/bytes" % g.handle,
                                        {"Range": "bytes=%d-%d" % (off, off + size - 1)})
            lat[size].append(time.perf_counter() - t0)
            if status != 206 or body != corpus[off : off + size]:
                raise AssertionError("third peer GET bytes=%d+%d: status %s, bytes differ"
                                     % (off, size, status))
        metrics3 = third.server.metrics()
        remote_hits = metrics3["index_store"]["remote_hits"]
        nominal = metrics3["fleet"]["fetcher"]["nominal_tasks"]
        if not stat["index_was_warm"] or remote_hits < 1 or nominal:
            raise AssertionError("the third peer's open was not warm from its peers: warm %s, "
                                 "remote_hits %d, %d nominal tasks"
                                 % (stat["index_was_warm"], remote_hits, nominal))
        engines = {"owner": owner_stats,
                   "survivor": check_server_engine(survivor, "survivor"),
                   "third": check_server_engine(third, "third peer")}
        router.membership.probe_once()
        membership = router.membership.snapshot()
        if membership["alive"] != FLEET_PEERS - 1 or membership["peers"][owner.url]["alive"]:
            raise AssertionError("the probe did not eject the killed owner: %s" % membership)
    finally:
        for client in clients:
            client.close()
        if router is not None:
            router.close()
        for gw in gws:
            gw.close()
        shutil.rmtree(work, ignore_errors=True)

    launches = stage2_launches()
    stream_s = t_end - t_start
    return {
        "card": card, "peers": FLEET_PEERS, "corpus_bytes": len(corpus), "gzip_bytes": len(blob),
        "read_size": FLEET_READ, "killed_at": n_kill,
        "open_s": open_s, "stream_s": stream_s, "close_s": close_s, "gap_s": gap_s,
        "stall_s": stall_s,
        "MBps_before_kill": n_kill / (t_kill - t_start) / 1e6,
        "MBps_after_kill": (len(corpus) - n_kill) / (t_end - t_kill) / 1e6,
        "MBps_resumed": (len(corpus) - n_kill) / (t_end - t_kill - gap_s) / 1e6,
        "client": client_stats, "owner_kinds": sorted(owner_kinds),
        "stream_device_busy_ms": busy_ms,
        "stream_device_idle_share": 1 - busy_ms / (stream_s * 1e3) if busy_ms else None,
        "stream_device_ops": [{"name": k, "ms": ms, "count": cnt} for k, ms, cnt in device_ops],
        "warm_open_s": warm_open_s, "remote_hits": remote_hits,
        "pread_latency": {str(size): quantiles_ms(v) for size, v in lat.items()},
        "pread_all": quantiles_ms([x for v in lat.values() for x in v]),
        "engines": engines, "launches": launches,
    }


# ---------------------------------------------------------------------------
# phase 9: the corpus pipeline
# ---------------------------------------------------------------------------

PIPELINE_SHARDS = 4
PIPELINE_SHARD_MIB = 2
PIPELINE_HTTP_SHARD = 2  # the shard served over http://, and the one the restore lands in
PIPELINE_SEQ = 2048
PIPELINE_BATCH = 8
PIPELINE_RESTORE_BATCHES = 8


def pipeline_path(seed: int, card: str):
    """Phase 9: one epoch of GzipCorpusDataset over four base64 shards (three
    local files, one http:// URL) on the process-wide CUDA engine, then a
    restore in the middle of the http:// shard over the warm IndexStore."""
    import shutil
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT / "tests"))
    from _range_server import RangeHTTPServer

    from repro_torch.data import BOS, ByteTokenizer, GzipCorpusDataset
    from repro_torch.kernels import crc32 as kc
    from repro_torch.kernels import marker_replace as mr
    from repro_torch.kernels.engine import shared_engine
    from repro_torch.service import IndexStore

    corpora = [base64_corpus(seed + 30 + i, PIPELINE_SHARD_MIB << 20)
               for i in range(PIPELINE_SHARDS)]
    blobs = [gzip.compress(c, 6, mtime=0) for c in corpora]
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="pipeline-", dir=ROOT / "build"))
    remote = RangeHTTPServer(blobs[PIPELINE_HTTP_SHARD])
    engine = shared_engine("cuda")  # the engine every reader below resolves through
    before = engine.stats()
    datasets = []
    mr.reset_launches()
    kc.reset_launches()
    try:
        shards = []
        for i, b in enumerate(blobs):
            if i == PIPELINE_HTTP_SHARD:
                shards.append(remote.url)
            else:
                (work / ("shard-%d.gz" % i)).write_bytes(b)
                shards.append(str(work / ("shard-%d.gz" % i)))
        store = IndexStore(str(work / "index"))

        def dataset():
            ds = GzipCorpusDataset(shards, seq_len=PIPELINE_SEQ, batch_size=PIPELINE_BATCH,
                                   device="cuda", index_store=store, loop=False)
            datasets.append(ds)
            return ds

        # 1. One epoch; the state is saved once, in the second half of the
        # http:// shard, where the buffer holds only that shard's bytes.
        half = len(corpora[PIPELINE_HTTP_SHARD]) // 2
        batches, state, saved_at = [], None, None
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ds = dataset()
            for batch in ds:
                if not batches:
                    first_batch_s = time.perf_counter() - t0
                batches.append(batch["tokens"])
                st = ds.state_dict()
                if (state is None and st["shard_idx"] == PIPELINE_HTTP_SHARD
                        and st["byte_offset"] - st["pending_buffer"] >= half):
                    state, saved_at = st, len(batches)
            ds.close()
        epoch_s = time.perf_counter() - t0
        device_ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                             for e in prof.key_averages() if e.self_device_time_total > 0),
                            key=lambda e: -e[1])
        busy_ms = sum(e[1] for e in device_ops)
        stream = np.concatenate([b.reshape(-1) for b in batches])
        if any(b.shape != (PIPELINE_BATCH, PIPELINE_SEQ + 1) or b.dtype != np.int32
               for b in batches):
            raise AssertionError("a batch is not int32 of shape (%d, %d)"
                                 % (PIPELINE_BATCH, PIPELINE_SEQ + 1))
        if int((stream == BOS).sum()) != PIPELINE_SHARDS or stream[0] != BOS:
            raise AssertionError("the epoch does not start each shard once with BOS")
        if ByteTokenizer().decode(stream) != b"".join(corpora):
            raise AssertionError("the epoch's tokens do not reproduce the shards in order")
        if state is None:
            raise AssertionError("the epoch never reached the middle of shard %d"
                                 % PIPELINE_HTTP_SHARD)
        expected = batches[saved_at : saved_at + PIPELINE_RESTORE_BATCHES]

        # 2. A new dataset over the warm store restores the saved state.
        t0 = time.perf_counter()
        ds2 = dataset()
        ds2.load_state_dict(state)
        restored = [ds2.next_batch()["tokens"]]
        restore_s = time.perf_counter() - t0
        restored += [ds2.next_batch()["tokens"] for _ in range(PIPELINE_RESTORE_BATCHES - 1)]
        fetcher = ds2._reader.stats()["fetcher"]  # noqa: SLF001
        resolver_ok = ds2._reader._fetcher.resolver is engine  # noqa: SLF001
        ds2.close()
        if not resolver_ok:
            raise AssertionError("the restored reader resolves through another engine")
        if len(restored) != len(expected) or any(
                not np.array_equal(a, b) for a, b in zip(restored, expected)):
            raise AssertionError("the restored batches differ from the first run's")
        if fetcher["nominal_tasks"]:
            raise AssertionError("the restore ran a first pass: %d nominal tasks"
                                 % fetcher["nominal_tasks"])
    finally:
        for ds in datasets:
            ds.close()
        remote.close()
        shutil.rmtree(work, ignore_errors=True)
    after = engine.stats()
    engine.shutdown()
    if after["errors"] != before["errors"] or after["fallbacks"] != before["fallbacks"]:
        raise AssertionError("the pipeline's engine erred or fell back: errors %d, fallbacks %s"
                             % (after["errors"], after["fallbacks"]))
    tokens = len(batches) * PIPELINE_BATCH * (PIPELINE_SEQ + 1)
    return {
        "card": card, "shards": PIPELINE_SHARDS, "corpus_bytes": [len(c) for c in corpora],
        "gzip_bytes": [len(b) for b in blobs], "http_shard": PIPELINE_HTTP_SHARD,
        "seq_len": PIPELINE_SEQ, "batch_size": PIPELINE_BATCH, "batches": len(batches),
        "tokens": tokens, "epoch_s": epoch_s, "tokens_per_s": tokens / epoch_s,
        "corpus_MBps": sum(map(len, corpora)) / epoch_s / 1e6,
        "first_batch_s": first_batch_s, "saved_after_batch": saved_at, "state": state,
        "restore_s": restore_s, "restore_fetcher": fetcher,
        "epoch_device_busy_ms": busy_ms,
        "epoch_device_idle_share": 1 - busy_ms / (epoch_s * 1e3) if busy_ms else None,
        "epoch_device_ops": [{"name": k, "ms": ms, "count": cnt} for k, ms, cnt in device_ops],
        "engine": {k: after[k] for k in ("requests", "batches", "dispatches", "fallbacks",
                                         "errors")},
        "launches": stage2_launches(),
    }


# ---------------------------------------------------------------------------
# phase 10: the serve path
# ---------------------------------------------------------------------------

SERVE_ARCH = "granite-3-2b"
SERVE_BATCH = 4
SERVE_PROMPT = 512
SERVE_NEW = 64  # decode steps checked against the full forward
SERVE_QUIET = 8  # decode steps after them with no reads beside them
SERVE_PROFILED = 16  # decode steps after those, under torch.profiler
SERVE_SHARDS = 2
SERVE_SHARD_MIB = 1
SERVE_READ = 512
SERVE_TOL = 5e-2  # rtol = atol, decode logits against the train-mode forward
SERVE_DEPTHS = (1, 2, 4, 8)  # first layers of the served weights, checked in bf16 too
SMOKE_FAMILIES = ("gemma-2b", "qwen2.5-32b", "internlm2-20b", "deepseek-moe-16b",
                  "deepseek-v2-236b", "hymba-1.5b", "internvl2-76b", "xlstm-350m",
                  "whisper-tiny")
SMOKE_TOL = 5e-2  # card against host, and decode against the forward ...
SMOKE_MLA_DECODE_TOL = 3e-1  # ... but MLA's absorbed decode (tests/test_torch_serve.py)


def allclose_ratio(ref, got, tol: float) -> float:
    """max |got - ref| / (tol + tol |ref|): at most 1 where torch.allclose
    (rtol = atol = tol) holds."""
    import torch

    wide = torch.float64 if torch.float64 in (ref.dtype, got.dtype) else torch.float32
    ref, got = ref.to(wide), got.to(device=ref.device, dtype=wide)
    return float(((got - ref).abs() / (tol + tol * ref.abs())).max())


def teacher_forced(model, tokens, prompt: int, extra=None):
    """(forward logits of ``tokens`` [B, S], prefill logits of the first
    ``prompt``, decode logits of the rest, each fed its true token)."""
    import torch

    from repro_torch.serve import make_serve_steps, prefill_to_decode_caches

    cfg = model.cfg
    extra = extra or {}
    B, S = tokens.shape
    prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
    with torch.inference_mode():
        full = model.logits({"tokens": tokens, **extra})
    prefill_fn, decode_fn, _ = make_serve_steps(model, batch=B, max_len=S + prefix)
    logits, pc = prefill_fn({"tokens": tokens[:, :prompt], **extra})
    caches = prefill_to_decode_caches(cfg, model, pc, B, S + prefix, prompt + prefix)
    steps = []
    for t in range(prompt, S):
        _, logits_d, caches = decode_fn(tokens[:, t : t + 1], caches, t + prefix)
        steps.append(logits_d[:, 0])
    return full, logits[:, 0], torch.stack(steps, dim=1)


def layerwise(model, tokens, prompt: int, tol: float) -> dict:
    """Decode held to the forward one layer at a time: every layer of the
    decode step at position t takes the forward's input to that layer at t
    (and its cache, filled the same way), so a rounding difference in one
    layer does not carry into the next. Returns the largest allclose ratio
    and |difference| over all layers and positions."""
    import torch

    from repro_torch.models import transformer

    cfg = model.cfg
    B, S = tokens.shape
    worst = {"ratio": 0.0, "max_abs_err": 0.0, "layer": None, "position": None}
    with torch.inference_mode():
        x = transformer.embed_tokens(cfg, model, tokens)
        pos = torch.arange(S, device=x.device)[None, :].expand(B, S)
        caches = transformer.init_caches(cfg, B, S, device=x.device)["layers"]
        for i, p in enumerate(model["layers"]):
            y, _, _ = transformer._block(cfg, p, x, pos, moe=False, mode="train")
            cache = transformer._layer_cache(caches, i)
            _, pre, _ = transformer._block(cfg, p, x[:, :prompt], pos[:, :prompt], moe=False,
                                           mode="prefill")
            for k in ("k", "v"):
                cache["attn"][k][:, :prompt] = pre["attn"][k]
            for t in range(prompt, S):
                y_t, _, _ = transformer._block(cfg, p, x[:, t : t + 1], pos[:, t : t + 1],
                                               moe=False, mode="decode", cache=cache, cache_pos=t)
                ratio = allclose_ratio(y[:, t], y_t[:, 0], tol)
                if ratio > worst["ratio"]:
                    worst = {"ratio": ratio, "layer": i, "position": t,
                             "max_abs_err": float((y_t[:, 0] - y[:, t]).abs().max())}
            x = y
    return worst


def smoke_families(seed: int) -> list:
    """The seven other decoder configs and the xLSTM and Whisper families
    at smoke width on the card: prefill
    plus decode against the full forward in bf16, and the card against the
    same module on the host (which tests/test_torch_models.py holds to the
    JAX package), in bf16 (reported: the hybrid's SSM branch, normalized
    after a small output, turns the two devices' roundings into up to
    0.23 of a logit) and in fp64 (fatal)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import build_model

    rows = []
    for i, arch in enumerate(SMOKE_FAMILIES):
        cfg = smoke_config(get_config(arch))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed + 50 + i)
        card = build_model(cfg, device="cuda").init(gen)
        host = build_model(cfg, device="cpu")
        host.load_state_dict(card.state_dict())
        rng = np.random.default_rng(seed + 50 + i)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32), dtype=np.int64))
        extra = {}
        if cfg.family == "vlm":
            extra["patches"] = torch.from_numpy(rng.normal(
                size=(2, cfg.vision_tokens, cfg.d_model)).astype(np.float32)).bfloat16()
        if cfg.family == "audio":
            extra["frames"] = torch.from_numpy(rng.normal(
                size=(2, cfg.encoder_frames, cfg.d_model)).astype(np.float32)).bfloat16()
        off_card = [n for n, p in card.named_parameters() if p.device.type != "cuda"]

        def both():
            t0 = time.perf_counter()
            on_card = teacher_forced(card, tokens.cuda(), 24,
                                     {k: v.to(device="cuda", dtype=card.cfg.dtype)
                                      for k, v in extra.items()})
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            on_host = teacher_forced(host, tokens, 24,
                                     {k: v.to(host.cfg.dtype) for k, v in extra.items()})
            return on_card, on_host, card_s

        on_card, on_host, card_s = both()
        full, pre, dec = on_card
        decode_tol = SMOKE_MLA_DECODE_TOL if cfg.use_mla else SMOKE_TOL
        row = {
            "arch": cfg.name, "card_s": card_s, "off_card": off_card,
            "prefill_vs_forward": allclose_ratio(full[:, 23], pre, SMOKE_TOL),
            "decode_vs_forward": allclose_ratio(full[:, 24:], dec, decode_tol),
            "decode_tol": decode_tol,
            "card_vs_host_bf16": max(allclose_ratio(h, c, SMOKE_TOL)
                                     for c, h in zip(on_card, on_host)),
            "max_abs_card_vs_host_bf16": max(float((c.float().cpu() - h.float()).abs().max())
                                             for c, h in zip(on_card, on_host)),
        }
        for m in (card, host):
            m.to(torch.float64)
            m.cfg = dataclasses.replace(cfg, dtype=torch.float64)
        on_card, on_host, _ = both()
        row["card_vs_host_fp64"] = max(allclose_ratio(h, c, SMOKE_TOL)
                                       for c, h in zip(on_card, on_host))
        row["max_abs_card_vs_host_fp64"] = max(float((c.cpu() - h).abs().max())
                                               for c, h in zip(on_card, on_host))
        row["ok"] = (max(row["prefill_vs_forward"], row["decode_vs_forward"],
                         row["card_vs_host_fp64"]) <= 1 and not off_card)
        rows.append(row)
        del card, host
    return rows


def serve_path(seed: int, card: str):
    """Phase 10: granite-3-2b at full width serves 4 prompts of 512 tokens
    for 64 greedy tokens on the card, and after each decode step every
    sequence reads 512 bytes of a gzip shard through an
    ArchiveServer(device="cuda") (examples/serve_batched.py's traffic); then
    the other decoder families at smoke width."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import crc32 as kc
    from repro_torch.kernels import marker_replace as mr
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.serve import make_serve_steps, prefill_to_decode_caches
    from repro_torch.service import ArchiveServer, IndexStore

    cfg = get_config(SERVE_ARCH)
    B, P, N = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    max_len = P + N + SERVE_QUIET + SERVE_PROFILED
    t0_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 40)
    model = build_model(cfg, device="cuda").init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()  # the init draws in fp32, a stack at a time
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    off_card = [n for n, p in model.named_parameters() if p.device.type != "cuda"]
    if off_card:
        raise AssertionError("model tensors off the card: %s" % off_card[:8])
    if n_params != cfg.param_count():
        raise AssertionError("%d parameters, param_count() says %d" % (n_params, cfg.param_count()))
    log("serve path [%s]: %s at full width (%d layers, d_model %d, %d heads, %d KV heads, d_ff "
        "%d, vocab %d, tied embeddings %s, %s): %d parameters (param_count() %d), %d bytes, "
        "drawn on the card in %.3f s" % (card, cfg.name, cfg.n_layers, cfg.d_model, cfg.n_heads,
                                          cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size,
                                          cfg.tie_embeddings, cfg.dtype, n_params,
                                          cfg.param_count(), param_bytes, init_s))

    corpora = [base64_corpus(seed + 41 + i, SERVE_SHARD_MIB << 20) for i in range(SERVE_SHARDS)]
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="serve-", dir=ROOT / "build"))
    prompts = torch.from_numpy(np.random.default_rng(seed + 40).integers(
        0, cfg.vocab_size, (B, P), dtype=np.int64)).cuda()
    prefill_fn, decode_fn, caches_abstract = make_serve_steps(model, batch=B, max_len=max_len)
    server = None
    try:
        paths = []
        for i, c in enumerate(corpora):
            paths.append(work / ("corpus-%02d.txt.gz" % i))
            paths[-1].write_bytes(gzip.compress(c, 6, mtime=0))
        server = ArchiveServer(max_workers=4, cache_budget_bytes=8 << 20,
                               index_store=IndexStore(str(work / "indexes")),
                               chunk_size=256 << 10, device="cuda")
        handles = [server.open(str(p), tenant="serve") for p in paths]
        engine = server.device_engine
        if not server._owns_engine or engine.device.type != "cuda":  # noqa: SLF001
            raise AssertionError("the server does not own a CUDA engine")
        read = {"n": 0, "bytes": 0, "s": 0.0}

        def retrieve(tok_host, t):
            for b in range(B):  # examples/serve_batched.py:112-115
                shard = (b + t) % len(handles)
                off = int(tok_host[b, 0]) * 1009 % max(1, len(corpora[shard]) - SERVE_READ)
                t1 = time.perf_counter()
                data = server.read_range(handles[shard], off, SERVE_READ)
                read["s"] += time.perf_counter() - t1
                if data != corpora[shard][off : off + SERVE_READ]:
                    raise AssertionError("read_range(%d, %d) of shard %d differs"
                                         % (off, SERVE_READ, shard))
                read["n"] += 1
                read["bytes"] += len(data)

        # One prefill first: cuBLAS and the allocator warm up outside the
        # timed and counted run.
        t0 = time.perf_counter()
        prefill_fn({"tokens": prompts})
        torch.cuda.synchronize()
        prefill_first_ms = (time.perf_counter() - t0) * 1e3

        mr.reset_launches()
        kc.reset_launches()
        t0 = time.perf_counter()
        logits, pc = prefill_fn({"tokens": prompts})
        caches = prefill_to_decode_caches(cfg, model, pc, B, max_len, P)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        del pc
        prefill_logits = logits[:, 0]
        fed, step_logits, step_ms = [tok], [], []
        t_loop = time.perf_counter()
        for t in range(N):
            t1 = time.perf_counter()
            tok, logits_d, caches = decode_fn(tok, caches, P + t)
            tok_host = tok.cpu().numpy()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            step_logits.append(logits_d[:, 0])
            fed.append(tok)
            retrieve(tok_host, t)
        loop_s = time.perf_counter() - t_loop
        reads_in_loop = dict(read)
        # What phase 12's decode on the mesh is held to.
        PHASE10_DECODE.update(
            prefill=prefill_logits.float().cpu(),
            tokens=torch.cat(fed[: MESH_SERVE_NEW + 1], dim=1).cpu(),
            logits=torch.stack(step_logits[:MESH_SERVE_NEW], dim=1).float().cpu())

        # Decode steps with no read beside them: what the reads' host work
        # (stage 1 in the server's threads) costs the steps.
        quiet_ms = []
        for t in range(N, N + SERVE_QUIET):
            t1 = time.perf_counter()
            tok, _, caches = decode_fn(tok, caches, P + t)
            tok.cpu()
            quiet_ms.append((time.perf_counter() - t1) * 1e3)

        # The device's idle share over more decode steps, reads included.
        prof_ms = []
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t_prof = time.perf_counter()
            for t in range(N + SERVE_QUIET, N + SERVE_QUIET + SERVE_PROFILED):
                t1 = time.perf_counter()
                tok, _, caches = decode_fn(tok, caches, P + t)
                tok_host = tok.cpu().numpy()
                prof_ms.append((time.perf_counter() - t1) * 1e3)
                retrieve(tok_host, t)
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t_prof
        launches = stage2_launches()
        device_ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                             for e in prof.key_averages() if e.self_device_time_total > 0),
                            key=lambda e: -e[1])
        busy_ms = sum(e[1] for e in device_ops)
        stats = engine.stats()
        cache_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(caches))
        abstract_ok = [tuple(a.shape) for a in tree_leaves(caches_abstract)] == \
            [tuple(c.shape) for c in tree_leaves(caches)]
    finally:
        if server is not None:
            server.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()  # the served run's
    if stats["errors"] or stats["fallbacks"] != {"replace": 0, "crc": 0}:
        raise AssertionError("the server's engine erred or fell back: errors %d, fallbacks %s"
                             % (stats["errors"], stats["fallbacks"]))
    if unlaunched(launches):
        raise AssertionError("a kernel never launched on the serve path: %s" % launches)
    if not abstract_ok:
        raise AssertionError("the decode caches differ from make_serve_steps' caches_abstract")

    # Consistency: the decode logits against the train-mode forward of the
    # same 576 tokens (the prompts and the 64 tokens fed back). The JAX
    # package's init draws wq/wk/wv with fan_in = shape[-2], the head count,
    # so at this width attention scores have a std near 64 and attention is
    # nearly hard: a rounding difference between the 1-row decode products
    # and the 576-row forward flips which keys win, and the flip carries on
    # through every later layer (the JAX package's own decode misses this
    # bound at 8 layers of this width, bf16 and fp32 alike). So the logits
    # are measured and reported end to end (the served bf16 run, its first
    # 1-8 layers, the whole model in fp32 and fp64), and what tells a fault
    # from rounding is fatal: every layer of every decode step against the
    # forward one layer at a time, in fp64 (reported in bf16 too).
    served_s = time.perf_counter() - t0_phase
    seq = torch.cat([prompts] + [t.long() for t in fed[:N]], dim=1)
    with torch.inference_mode():
        from repro_torch.models import transformer

        full = transformer.forward(cfg, model, seq, mode="train")[0]

    def agreement(full, pre, dec):
        return {"max_abs_err": float((dec.float() - full[:, P:].float()).abs().max()),
                "ratio": allclose_ratio(full[:, P:], dec, SERVE_TOL),
                "prefill_ratio": allclose_ratio(full[:, P - 1], pre, SERVE_TOL),
                "finite": bool(torch.isfinite(dec.float()).all()
                               and torch.isfinite(full.float()).all())}

    consistency = {"bf16, %d layers (served)" % cfg.n_layers:
                   agreement(full, prefill_logits, torch.stack(step_logits, dim=1))}
    del full, step_logits, caches
    for depth in (d for d in SERVE_DEPTHS if d < cfg.n_layers):  # the first layers, same weights
        shallow = build_model(dataclasses.replace(cfg, n_layers=depth), device="cuda")
        keep = shallow.state_dict().keys()
        shallow.load_state_dict({k: v for k, v in model.state_dict().items() if k in keep})
        consistency["bf16, %d layers" % depth] = agreement(*teacher_forced(shallow, seq, P))
        del shallow
    layer_by_layer = {"bf16": layerwise(model, seq, P, SERVE_TOL)}
    for dtype, name in ((torch.float32, "fp32"), (torch.float64, "fp64")):
        model.to(dtype)
        model.cfg = dataclasses.replace(cfg, dtype=dtype)
        consistency["%s, %d layers" % (name, cfg.n_layers)] = agreement(
            *teacher_forced(model, seq, P))
    layer_by_layer["fp64"] = layerwise(model, seq, P, SERVE_TOL)
    log("serve path [%s]: decode logits against the forward at rtol = atol = %g: %s; each layer "
        "against the forward's, fed the forward's input: %s"
        % (card, SERVE_TOL, json.dumps(consistency), json.dumps(layer_by_layer)))
    ok = layer_by_layer["fp64"]["ratio"] <= 1 and all(c["finite"] for c in consistency.values())
    del model
    torch.cuda.empty_cache()
    checks_s = time.perf_counter() - t0_phase - served_s
    t1 = time.perf_counter()
    families = smoke_families(seed)
    families_s = time.perf_counter() - t1
    result = {
        "card": card, "arch": cfg.name, "params": n_params, "param_bytes": param_bytes,
        "param_count": cfg.param_count(), "init_s": init_s, "batch": B, "prompt": P,
        "new_tokens": N, "max_len": max_len, "cache_bytes": cache_bytes,
        "prefill_ms": prefill_ms, "prefill_first_ms": prefill_first_ms,
        "decode_ms": {"p50": float(np.percentile(step_ms, 50)),
                      "p99": float(np.percentile(step_ms, 99)),
                      "mean": float(np.mean(step_ms)), "steps": step_ms},
        "decode_tokens_per_s": B * N / (sum(step_ms) / 1e3),
        "quiet_ms": {"p50": float(np.percentile(quiet_ms, 50)), "steps": quiet_ms},
        "loop_s": loop_s, "loop_tokens_per_s": B * N / loop_s,
        "reads": reads_in_loop, "reads_all": read,
        "profiled": {"steps": SERVE_PROFILED, "wall_s": prof_s, "device_busy_ms": busy_ms,
                     "device_idle_share": 1 - busy_ms / (prof_s * 1e3) if busy_ms else None,
                     "step_ms_p50": float(np.percentile(prof_ms, 50)),
                     "device_ops": [{"name": k, "ms": ms, "count": c}
                                    for k, ms, c in device_ops[:12]],
                     "device_op_count": sum(e[2] for e in device_ops)},
        "max_memory_allocated": peak, "init_max_memory_allocated": init_peak,
        "consistency": consistency,
        "layer_by_layer": layer_by_layer,
        "engine": {k: stats[k] for k in ("requests", "batches", "dispatches", "fallbacks",
                                         "errors")},
        "launches": launches, "families": families,
        "seconds": {"served": served_s, "consistency": checks_s, "families": families_s},
    }
    if not ok:
        raise AssertionError("decode differs from the forward at rtol = atol = %g layer by layer "
                             "in fp64, or a logit is not finite: %s %s"
                             % (SERVE_TOL, json.dumps(layer_by_layer), json.dumps(consistency)))
    bad = [f for f in families if not f["ok"]]
    if bad:
        raise AssertionError("smoke-width families failed on the card: %s" % json.dumps(bad))
    return result


FAMILY_SERVE = (("xlstm-350m", 60), ("whisper-tiny", 61))  # full width, seed offsets
FAMILY_PROMPT = {"xlstm-350m": 512, "whisper-tiny": 64}
FAMILY_NEW = 32  # greedy decode steps
FP64_TOL = 1e-6  # rtol = atol: a form or a layer against another, both in fp64


def _family_blocks(model):
    """The xLSTM's blocks in the order the forward runs them: (name, block
    function, its parameters)."""
    from repro_torch.models import xlstm

    H = model.cfg.n_heads
    for g, (p_m, p_s) in enumerate(zip(model["mlstm"], model["slstm"])):
        for j in range(model.n_m):
            yield "mlstm %d.%d" % (g, j), (lambda p, x, **kw: xlstm.mlstm_block(p, x, H, **kw)), \
                p_m[j]
        yield "slstm %d" % g, (lambda p, x, **kw: xlstm.slstm_block(p, x, H, **kw)), p_s


def xlstm_forms_fp64(model, seq, prompt: int) -> dict:
    """Each xLSTM block fed the forward's input to it, in fp64: the block
    over the whole sequence (chunkwise) against the block over the prompt
    (chunkwise, returning its state) and then one recurrent step per
    position from that state. The largest allclose ratio at FP64_TOL."""
    import torch

    worst = {"ratio": -1.0, "max_abs_err": 0.0, "block": None, "position": None}
    with torch.inference_mode():
        x = model["embed"][seq]
        for name, block, p in _family_blocks(model):
            y, _ = block(p, x, return_state=True)
            _, state = block(p, x[:, :prompt], return_state=True)
            for t in range(prompt, seq.shape[1]):
                y_t, state = block(p, x[:, t : t + 1], state=state)
                ratio = allclose_ratio(y[:, t], y_t[:, 0], FP64_TOL)
                if ratio > worst["ratio"]:
                    worst = {"ratio": ratio, "block": name, "position": t,
                             "max_abs_err": float((y_t[:, 0] - y[:, t]).abs().max())}
            x = y
    return worst


def whisper_layers_fp64(model, seq, frames, prompt: int) -> dict:
    """Each Whisper decoder layer fed the forward's input to it, in fp64:
    the train-mode layer over the sequence against prefill of the prompt
    (its self K/V and cross K/V into a decode cache) and then one decode
    step per position. The largest allclose ratio at FP64_TOL."""
    import torch

    from repro_torch.models import encdec

    cfg = model.cfg
    B, S = seq.shape
    worst = {"ratio": -1.0, "max_abs_err": 0.0, "layer": None, "position": None}
    with torch.inference_mode():
        enc = encdec.encode(cfg, model, frames)
        pos = torch.arange(S, device=seq.device)[None, :].expand(B, S)
        x = model["embed"][seq] + model["pos_embed"][torch.arange(S, device=seq.device)][None]
        caches = encdec.init_decoder_caches(cfg, B, S, enc.shape[1], device=seq.device)
        for i, p in enumerate(model["decoder"]):
            y, _ = encdec.decoder_layer(cfg, p, x, pos, enc, mode="train")
            _, pre = encdec.decoder_layer(cfg, p, x[:, :prompt], pos[:, :prompt], enc,
                                          mode="prefill")
            cache = encdec._layer_cache(caches, i)  # noqa: SLF001
            for k in ("k", "v"):
                cache["attn"][k][:, :prompt] = pre["attn"][k]
            cache["cross_k"].copy_(pre["cross_k"])
            cache["cross_v"].copy_(pre["cross_v"])
            for t in range(prompt, S):
                y_t, _ = encdec.decoder_layer(cfg, p, x[:, t : t + 1], pos[:, t : t + 1], None,
                                              mode="decode", cache=cache, cache_pos=t)
                ratio = allclose_ratio(y[:, t], y_t[:, 0], FP64_TOL)
                if ratio > worst["ratio"]:
                    worst = {"ratio": ratio, "layer": i, "position": t,
                             "max_abs_err": float((y_t[:, 0] - y[:, t]).abs().max())}
            x = y
    return worst


def family_serve(arch: str, seed: int, card: str) -> dict:
    """xlstm-350m or whisper-tiny at full width on the card: 4 prompts
    (512 tokens for the xLSTM; 1500 stub frames and 64 tokens for Whisper),
    prefill, 32 greedy decode steps; decode logits against the
    teacher-forced forward of the same tokens in bf16 (reported), then the
    forms (xLSTM) or layers (Whisper) against each other in fp64 (fatal)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import make_serve_steps, prefill_to_decode_caches

    cfg = get_config(arch)
    B, P, N = SERVE_BATCH, FAMILY_PROMPT[arch], FAMILY_NEW
    max_len = P + N
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda").init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    off_card = [n for n, p in model.named_parameters() if p.device.type != "cuda"]
    if off_card or n_params != cfg.param_count():
        raise AssertionError("%s: tensors off the card %s, or %d parameters against "
                             "param_count() %d" % (arch, off_card[:4], n_params, cfg.param_count()))
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P), dtype=np.int64)).cuda()
    extra = {}
    if cfg.family == "audio":
        extra["frames"] = torch.randn((B, cfg.encoder_frames, cfg.d_model), generator=gen,
                                      device="cuda").to(cfg.dtype)
    prefill_fn, decode_fn, abstract = make_serve_steps(model, batch=B, max_len=max_len)
    torch.cuda.reset_peak_memory_stats()
    prefill_fn({"tokens": prompts, **extra})  # cuBLAS and the allocator warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, pc = prefill_fn({"tokens": prompts, **extra})
    caches = prefill_to_decode_caches(cfg, model, pc, B, max_len, P)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    del pc
    fed, step_logits, step_ms = [tok], [], []
    for t in range(N):
        t1 = time.perf_counter()
        tok, logits_d, caches = decode_fn(tok, caches, P + t)
        tok.cpu()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        step_logits.append(logits_d[:, 0])
        fed.append(tok)
    peak = torch.cuda.max_memory_allocated()
    shapes_ok = ([tuple(t.shape) for t in _cache_tensors(abstract)]
                 == [tuple(t.shape) for t in _cache_tensors(caches)])
    del caches
    seq = torch.cat([prompts] + [t.long() for t in fed[:N]], dim=1)
    with torch.inference_mode():
        full = model.logits({"tokens": seq, **extra})
        consistency = {
            "ratio": allclose_ratio(full[:, P:], torch.stack(step_logits, 1), SERVE_TOL),
            "prefill_ratio": allclose_ratio(full[:, P - 1], logits[:, 0], SERVE_TOL),
            "max_abs_err": float((torch.stack(step_logits, 1).float()
                                  - full[:, P:].float()).abs().max()),
            "finite": bool(torch.isfinite(full.float()).all()
                           and torch.isfinite(torch.stack(step_logits).float()).all()),
        }
        if cfg.family == "ssm":  # as test_serve_consistency.py: the longer prefix's prefill
            longer, _ = prefill_fn({"tokens": seq[:, : P + 1]})
            consistency["longer_prefix_ratio"] = allclose_ratio(longer[:, 0], step_logits[0],
                                                                SERVE_TOL)
    del full, step_logits
    model.to(torch.float64)
    model.cfg = dataclasses.replace(cfg, dtype=torch.float64)
    t0 = time.perf_counter()
    if cfg.family == "ssm":
        fp64 = xlstm_forms_fp64(model, seq, P)
    else:
        fp64 = whisper_layers_fp64(model, seq, extra["frames"].double(), P)
    fp64_s = time.perf_counter() - t0
    row = {
        "arch": arch, "card": card, "params": n_params, "init_s": init_s, "batch": B,
        "prompt": P, "new_tokens": N, "prefill_ms": prefill_ms,
        "decode_ms": {"p50": float(np.percentile(step_ms, 50)),
                      "p99": float(np.percentile(step_ms, 99)), "steps": step_ms},
        "decode_tokens_per_s": B * N / (sum(step_ms) / 1e3),
        "max_memory_allocated": peak, "caches_match_abstract": shapes_ok,
        "consistency_bf16": consistency, "fp64": fp64, "fp64_s": fp64_s,
    }
    del model
    torch.cuda.empty_cache()
    if not (shapes_ok and consistency["finite"] and fp64["ratio"] <= 1):
        raise AssertionError("%s at full width: decode differs from %s in fp64 at rtol = atol "
                             "= %g, a logit is not finite, or the caches differ from "
                             "caches_abstract: %s" % (arch, "the chunkwise form" if
                                                      cfg.family == "ssm" else "the forward",
                                                      FP64_TOL, json.dumps(row)))
    return row


def _cache_tensors(tree) -> list:
    """The tensors of a cache tree: dicts by key, tuples (the sLSTM state)
    in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _cache_tensors(tree[k])]
    if isinstance(tree, tuple):
        return [t for sub in tree for t in _cache_tensors(sub)]
    return [tree]


# ---------------------------------------------------------------------------
# phase 11: the train path
# ---------------------------------------------------------------------------

TRAIN_ARCH = "granite-3-2b"
TRAIN_SHARDS = 2  # make_corpus's count and size
TRAIN_SHARD_MIB = 1
TRAIN_STEPS = 12  # timed; steps 3-12 give the step time
TRAIN_PROFILED = 2  # more steps, under torch.profiler
RESTORE_LAYERS = 2  # depth of the preempt-and-restore leg (full width)
RESTORE_STEPS = 12  # the unbroken run; the broken one stops at half and restores
COMPRESSED_STEPS = 6
FAMILY_TRAIN_STEPS = 4
LOSS_TOL = 1e-3  # the restored run's losses against the unbroken run's
ACCUM_RTOL, ACCUM_ATOL = 3e-2, 3e-3  # grad_accum=2 against 1 (tests/test_train.py:61-64)


def _driver_args(work: Path, arch: str, steps: int, seed: int, *extra: str):
    from repro_torch.launch import train as launch

    return launch.build_parser().parse_args(
        ["--arch", arch, "--steps", str(steps), "--corpus", str(work / "corpus"),
         "--seed", str(seed), "--device", "cuda", *extra])


def _du(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def restore_leg(seed: int, work: Path) -> dict:
    """granite-3-2b at full width and RESTORE_LAYERS layers: an unbroken run
    of RESTORE_STEPS steps; a run from the same weights that saves a
    checkpoint at half, a fresh model (another seed) and dataset that
    restore it and run the rest; grad_accum=2 against 1 from one state; and
    COMPRESSED_STEPS steps with compressed gradients."""
    import dataclasses
    import glob

    import numpy as np
    import torch

    from repro_torch.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import GzipCorpusDataset
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_tensors
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=RESTORE_LAYERS)
    shards = sorted(glob.glob(str(work / "corpus" / "*.gz")))
    ocfg = AdamWConfig(peak_lr=3e-3, warmup_steps=5, total_steps=RESTORE_STEPS)
    half = RESTORE_STEPS // 2

    def fresh(s, **kw):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(s)
        model = build_model(cfg, device="cuda")
        params, opt = init_train_state(model, gen, **kw)
        return model, params, opt

    def dataset():
        return GzipCorpusDataset(shards, seq_len=128, batch_size=8, parallelization=4,
                                 chunk_size=256 << 10, device="cuda")

    def steps(step_fn, params, opt, ds, n, batches=None, losses=None, times=None):
        for _ in range(n):
            batch = ds.next_batch()
            if batches is not None:
                batches.append(batch["tokens"].copy())
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch)
            loss = float(m["loss"])
            if times is not None:
                times.append((time.perf_counter() - t0) * 1e3)
            if losses is not None:
                losses.append(loss)
        return params, opt

    out = {"layers": RESTORE_LAYERS, "steps": RESTORE_STEPS}
    # 1. unbroken
    model, params, opt = fresh(seed)
    ds = dataset()
    batches, losses = [], []
    steps(make_train_step(model, ocfg), params, opt, ds, RESTORE_STEPS, batches, losses)
    ds.close()
    out["params"] = sum(p.numel() for p in model.parameters())
    out["unbroken_losses"] = losses
    del model, params, opt
    # 2. the same weights, preempted at half
    model_b, params_b, opt_b = fresh(seed)
    ds = dataset()
    seen, broken = [], []
    params_b, opt_b = steps(make_train_step(model_b, ocfg), params_b, opt_b, ds, half, seen, broken)
    ckpt = work / "ckpt"
    t0 = time.perf_counter()
    save_checkpoint(str(ckpt), half, {"params": params_b, "opt": opt_b, "data": ds.state_dict()})
    out["save_s"] = time.perf_counter() - t0
    out["ckpt_bytes"] = _du(ckpt)
    ds.close()
    # 3. a fresh process's state: another seed, a new dataset, then restore
    model_c, params_c, opt_c = fresh(seed + 1)
    ds = dataset()
    t0 = time.perf_counter()
    step, state = restore_checkpoint(latest_checkpoint(str(ckpt)),
                                     {"params": params_c, "opt": opt_c, "data": ds.state_dict()})
    ds.load_state_dict(state["data"])
    opt_c = state["opt"]
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    def state(params, opt):
        return tree_tensors(params) + tree_tensors(opt["m"]) + tree_tensors(opt["v"]) + [opt["step"]]

    pairs = list(zip(state(params_b, opt_b), state(params_c, opt_c)))
    out["restored_leaves"] = len(pairs)
    out["restored_unequal"] = sum(not torch.equal(a, b) for a, b in pairs)
    out["restored_on_card"] = all(b.device.type == "cuda" for _, b in pairs)
    out["restored_step"] = step
    del model_b, params_b, opt_b, pairs
    resumed, resumed_batches = [], []
    steps(make_train_step(model_c, ocfg), params_c, opt_c, ds, RESTORE_STEPS - half,
          resumed_batches, resumed)
    ds.close()
    del model_c, params_c, opt_c
    out["broken_losses"] = broken + resumed
    out["batches_equal"] = all(np.array_equal(a, b) for a, b in
                               zip(seen + resumed_batches, batches)) and \
        len(seen + resumed_batches) == len(batches)
    out["resumed_loss_max_abs_diff"] = float(np.max(np.abs(np.array(resumed)
                                                           - np.array(losses[half:]))))
    # 4. grad_accum=2 against 1 from the same state and batch
    tensors = []
    for accum in (1, 2):
        model, params, opt = fresh(seed + 2)
        make_train_step(model, ocfg, grad_accum=accum)(params, opt, {"tokens": batches[0]})
        tensors.append(tree_tensors(params))
        del model, params, opt
    ratio = max(float(((a.detach().float() - b.detach().float()).abs()
                       / (ACCUM_ATOL + ACCUM_RTOL * b.float().abs())).max())
                for a, b in zip(*tensors))
    out["accum_ratio"] = ratio
    del tensors
    # 5. compressed gradients
    model, params, opt = fresh(seed + 3, compress_grads=True)
    ds = dataset()
    comp_losses, comp_ms = [], []
    steps(make_train_step(model, ocfg, compress_grads=True), params, opt, ds, COMPRESSED_STEPS,
          losses=comp_losses, times=comp_ms)
    ds.close()
    del model, params, opt
    out["compressed"] = {"losses": comp_losses, "step_ms": comp_ms}
    torch.cuda.empty_cache()
    return out


def train_path(seed: int, card: str) -> dict:
    """Phase 11: granite-3-2b at full width trains TRAIN_STEPS steps, then
    TRAIN_PROFILED more under torch.profiler, through
    repro_torch.launch.train.run on make_corpus shards read by
    GzipCorpusDataset(device="cuda") (the process-wide engine); then the
    preempt-and-restore leg, and xlstm-350m and whisper-tiny train."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.kernels import crc32 as kc
    from repro_torch.kernels import marker_replace as mr
    from repro_torch.kernels.engine import shared_engine
    from repro_torch.launch import train as launch

    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="train-", dir=ROOT / "build"))
    engine = shared_engine("cuda")
    before = engine.stats()
    lines = []

    def relay(line):
        lines.append(line)
        log("train path [%s]: %s" % (card, line))

    try:
        t_phase = time.perf_counter()
        args = _driver_args(work, TRAIN_ARCH, TRAIN_STEPS + TRAIN_PROFILED, seed + 70,
                            "--profile-steps", str(TRAIN_PROFILED))
        # Phase 9's base64 text in make_corpus's shard files (make_corpus
        # keeps files it finds): its 12-word text gzips a 1 MiB shard into
        # less than one 256 KiB chunk, whose window is known, so stage 2
        # would find no marker to replace.
        Path(args.corpus).mkdir(parents=True)
        for i in range(TRAIN_SHARDS):
            (Path(args.corpus) / ("shard_%03d.gz" % i)).write_bytes(
                gzip.compress(base64_corpus(seed + 70 + i, TRAIN_SHARD_MIB << 20), 6, mtime=0))
        torch.cuda.reset_peak_memory_stats()
        mr.reset_launches()
        kc.reset_launches()
        t0 = time.perf_counter()
        run = launch.run(args, log=relay)
        run_s = time.perf_counter() - t0
        launches = stage2_launches()
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        timed = [s * 1e3 for s in run["step_s"][2:TRAIN_STEPS]]  # steps 3-12
        tokens_per_step = args.batch * args.seq
        result = {
            "card": card, "arch": TRAIN_ARCH, "params": run["params"], "batch": args.batch,
            "seq": args.seq, "steps": TRAIN_STEPS, "losses": run["losses"],
            "step_ms": {"p50": float(np.percentile(timed, 50)),
                        "p99": float(np.percentile(timed, 99)),
                        "first": run["step_s"][0] * 1e3, "all": [s * 1e3 for s in run["step_s"]]},
            "tokens_per_s": tokens_per_step / (float(np.percentile(timed, 50)) / 1e3),
            "data_share": run["data_share"], "data_ms": [s * 1e3 for s in run["data_s"]],
            "max_memory_allocated": peak, "profile": run["profile"], "devices": run["devices"],
            "run_s": run_s, "launches": launches,
        }
        t0 = time.perf_counter()
        result["restore"] = restore_leg(seed + 80, work)
        result["restore_leg_s"] = time.perf_counter() - t0
        families = {}
        for i, arch in enumerate(("xlstm-350m", "whisper-tiny")):
            torch.cuda.reset_peak_memory_stats()
            fam = launch.run(_driver_args(work, arch, FAMILY_TRAIN_STEPS, seed + 90 + i),
                             log=relay)
            families[arch] = {"losses": fam["losses"], "params": fam["params"],
                              "step_ms": [s * 1e3 for s in fam["step_s"]],
                              "devices": fam["devices"],
                              "max_memory_allocated": torch.cuda.max_memory_allocated()}
            torch.cuda.empty_cache()
        result["families"] = families
        result["seconds"] = time.perf_counter() - t_phase
    finally:
        shutil.rmtree(work, ignore_errors=True)
    after = engine.stats()
    rest = result["restore"]
    losses = result["losses"] + rest["unbroken_losses"] + rest["broken_losses"] + \
        rest["compressed"]["losses"] + [x for f in families.values() for x in f["losses"]]
    on_card = all(v == ["cuda"] for d in [result["devices"]] + [f["devices"] for f in
                                                                families.values()]
                  for v in d.values())
    problems = []
    if not all(np.isfinite(losses)):
        problems.append("a loss is not finite")
    if not on_card:
        problems.append("a parameter, gradient or moment is off the card: %s" % result["devices"])
    if unlaunched(launches):
        problems.append("a kernel never launched on the train path: %s" % launches)
    if after["errors"] != before["errors"] or after["fallbacks"] != before["fallbacks"]:
        problems.append("the corpus engine erred or fell back: errors %d, fallbacks %s"
                        % (after["errors"], after["fallbacks"]))
    if rest["restored_unequal"] or not rest["restored_on_card"] or rest["restored_step"] != \
            RESTORE_STEPS // 2:
        problems.append("%d of %d restored leaves differ from the saved ones (on the card: %s, "
                        "step %d)" % (rest["restored_unequal"], rest["restored_leaves"],
                                      rest["restored_on_card"], rest["restored_step"]))
    if not rest["batches_equal"]:
        problems.append("the batches after the restore differ from the unbroken run's")
    if rest["resumed_loss_max_abs_diff"] > LOSS_TOL:
        problems.append("the restored run's losses are %g from the unbroken run's"
                        % rest["resumed_loss_max_abs_diff"])
    if rest["accum_ratio"] > 1:
        problems.append("grad_accum=2 against 1: allclose ratio %g" % rest["accum_ratio"])
    if problems:
        raise AssertionError("train path: %s; %s" % ("; ".join(problems),
                                                     json.dumps(result)[:4000]))
    return result


# ---------------------------------------------------------------------------
# phase 12: the mesh
# ---------------------------------------------------------------------------

MESH_LAYERS = 2  # the leg held to phase 11's unbroken run
MESH_STEPS = 12
MESH_FULL_STEPS = 6  # 40 layers, timed
MESH_PROFILED = 2
MESH_SERVE_NEW = 16  # greedy steps held to phase 10's
PHASE10_DECODE: dict = {}


def _tensors_on_card(tree) -> bool:
    from repro_torch.models.layers import tree_tensors

    return all(t.device.type == "cuda" for t in tree_tensors(tree))


def mesh_path(seed: int, card: str, train: dict) -> dict:
    """Phase 12: the train and serve steps on make_host_mesh(), NCCL at
    world size 1: (data, model) = (1, 1) on the card. granite-3-2b at full
    width trains through repro_torch.launch.train.run (which builds the
    mesh) at 2 layers against phase 11's unbroken run, at 40 layers for
    MESH_FULL_STEPS timed steps, and at 2 layers with compressed gradients
    through make_train_step(model, mesh, rules, ...) against phase 11's
    compressed leg; compressed_psum runs over the NCCL group; then
    make_serve_steps(model, mesh, rules, ...) greedy-decodes against phase
    10."""
    import dataclasses
    import glob
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import GzipCorpusDataset
    from repro_torch.distributed import compress, compressed_psum, decompress, default_rules
    from repro_torch.kernels import crc32 as kc
    from repro_torch.kernels import marker_replace as mr
    from repro_torch.kernels.engine import shared_engine
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.serve import make_serve_steps, prefill_to_decode_caches
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="mesh-", dir=ROOT / "build"))
    engine = shared_engine("cuda")
    before = engine.stats()
    mr.reset_launches()
    kc.reset_launches()
    t_phase = time.perf_counter()
    mesh = make_host_mesh(device="cuda")
    rules = default_rules(mesh)
    backend = dist.get_backend()
    out = {"card": card, "backend": backend, "world_size": dist.get_world_size(),
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
    relay = lambda line: log("mesh path [%s]: %s" % (card, line))  # noqa: E731
    try:
        corpus = work / "corpus"
        corpus.mkdir()
        for i in range(TRAIN_SHARDS):  # phase 11's shards, made again from the seed
            (corpus / ("shard_%03d.gz" % i)).write_bytes(
                gzip.compress(base64_corpus(seed + 70 + i, TRAIN_SHARD_MIB << 20), 6, mtime=0))
        # (a) 2 layers against phase 11's unbroken run: its seed, batches, schedule
        args = _driver_args(work, TRAIN_ARCH, MESH_STEPS, seed + 80, "--layers",
                            str(MESH_LAYERS), "--lr", "3e-3")
        short = launch.run(args, log=relay)
        ref = train["restore"]["unbroken_losses"]
        out["short"] = {"losses": short["losses"], "phase11_losses": ref,
                        "max_abs_diff": float(np.max(np.abs(np.array(short["losses"])
                                                            - np.array(ref)))),
                        "devices": short["devices"], "backend": short["backend"]}
        torch.cuda.empty_cache()
        # 40 layers, timed
        torch.cuda.reset_peak_memory_stats()
        args = _driver_args(work, TRAIN_ARCH, MESH_FULL_STEPS + MESH_PROFILED, seed + 70,
                            "--profile-steps", str(MESH_PROFILED))
        full = launch.run(args, log=relay)
        timed = [x * 1e3 for x in full["step_s"][1:MESH_FULL_STEPS]]
        out["full"] = {"params": full["params"], "losses": full["losses"],
                       "step_ms": {"p50": float(np.percentile(timed, 50)),
                                   "p99": float(np.percentile(timed, 99)),
                                   "first": full["step_s"][0] * 1e3,
                                   "all": [x * 1e3 for x in full["step_s"]]},
                       "tokens_per_s": args.batch * args.seq / (
                           float(np.percentile(timed, 50)) / 1e3),
                       "profile": full["profile"], "devices": full["devices"],
                       "data_share": full["data_share"],
                       "max_memory_allocated": torch.cuda.max_memory_allocated()}
        torch.cuda.empty_cache()
        # compressed gradients, against phase 11's compressed leg
        cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=RESTORE_LAYERS)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed + 83)
        model = build_model(cfg, device="cuda")
        params, opt = init_train_state(model, gen, compress_grads=True)
        step_fn, shardings = make_train_step(
            model, mesh, rules, AdamWConfig(peak_lr=3e-3, warmup_steps=5,
                                            total_steps=RESTORE_STEPS), compress_grads=True)
        ds = GzipCorpusDataset(sorted(glob.glob(str(corpus / "*.gz"))), seq_len=128,
                               batch_size=8, parallelization=4, chunk_size=256 << 10,
                               device="cuda")
        comp, comp_ms = [], []
        try:
            for _ in range(COMPRESSED_STEPS):
                batch = ds.next_batch()
                t0 = time.perf_counter()
                params, opt, m = step_fn(params, opt, batch)
                comp.append(float(m["loss"]))
                comp_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            ds.close()
        ref = train["restore"]["compressed"]["losses"]
        out["compressed"] = {"losses": comp, "phase11_losses": ref, "step_ms": comp_ms,
                             "max_abs_diff": float(np.max(np.abs(np.array(comp)
                                                                 - np.array(ref)))),
                             "on_card": _tensors_on_card(params) and _tensors_on_card(
                                 {k: opt[k] for k in ("m", "v", "grad_error")})}
        del model, params, opt, step_fn
        torch.cuda.empty_cache()
        # compressed_psum over the NCCL group: a gradient-sized tensor
        x = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen, device="cuda")
        q, scale = compress(x)
        got = compressed_psum(x, "data", mesh=mesh)
        torch.cuda.synchronize()
        reps = []
        for _ in range(5):
            t0 = time.perf_counter()
            compressed_psum(x, "data", mesh=mesh)
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) * 1e3)
        out["compressed_psum"] = {"shape": list(x.shape), "equal": bool(torch.equal(
            got, decompress(q, scale))), "ms_p50": float(np.percentile(reps, 50))}
        del x, q, got
        # (b) serve on the mesh, against phase 10's one-card decode
        scfg = get_config(SERVE_ARCH)
        B, P = SERVE_BATCH, SERVE_PROMPT
        max_len = P + SERVE_NEW + SERVE_QUIET + SERVE_PROFILED  # phase 10's caches
        sgen = torch.Generator(device="cuda")
        sgen.manual_seed(seed + 40)
        torch.cuda.reset_peak_memory_stats()
        model = build_model(scfg, device="cuda").init(sgen)
        prompts = torch.from_numpy(np.random.default_rng(seed + 40).integers(
            0, scfg.vocab_size, (B, P), dtype=np.int64)).cuda()
        prefill_fn, decode_fn, caches_abstract, sshard = make_serve_steps(
            model, mesh, rules, batch=B, max_len=max_len)
        params = model.param_tree()
        t0 = time.perf_counter()
        logits, pc = prefill_fn(params, {"tokens": prompts})
        caches = prefill_to_decode_caches(scfg, model, pc, B, max_len, P)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        del pc
        fed, steps, step_ms = [tok], [], []
        for t in range(MESH_SERVE_NEW):
            t1 = time.perf_counter()
            tok, lg, caches = decode_fn(params, tok, caches, P + t)
            tok.cpu()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            fed.append(tok)
            steps.append(lg[:, 0].float().cpu())
        got_logits = torch.stack(steps, dim=1)
        ref_logits = PHASE10_DECODE["logits"]
        out["serve"] = {
            "prefill_ms": prefill_ms,
            "decode_ms": {"p50": float(np.percentile(step_ms[1:], 50)),
                          "p99": float(np.percentile(step_ms[1:], 99)), "all": step_ms},
            "decode_tokens_per_s": B * (MESH_SERVE_NEW - 1) / (sum(step_ms[1:]) / 1e3),
            "tokens_equal": bool(torch.equal(torch.cat(fed[: MESH_SERVE_NEW + 1], 1).cpu(),
                                             PHASE10_DECODE["tokens"])),
            "prefill_max_abs_diff": float((logits[:, 0].float().cpu()
                                           - PHASE10_DECODE["prefill"]).abs().max()),
            "logits_max_abs_diff": float((got_logits - ref_logits).abs().max()),
            "logits_ratio": allclose_ratio(ref_logits, got_logits, SERVE_TOL),
            "params_on_card": _tensors_on_card(params),
            "caches_on_card": all(t.device.type == "cuda" for t in tree_leaves(caches)),
            "caches_match_abstract": [tuple(a.shape) for a in tree_leaves(caches_abstract)] ==
            [tuple(c.shape) for c in tree_leaves(caches)],
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
        del model, params, caches
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    after = engine.stats()
    out["launches"] = stage2_launches()
    out["engine"] = {"errors": after["errors"] - before["errors"],
                     "fallbacks_before": before["fallbacks"], "fallbacks": after["fallbacks"]}
    out["seconds"] = time.perf_counter() - t_phase
    problems = []
    if backend != "nccl":
        problems.append("the process group's backend is %s, not nccl" % backend)
    if out["short"]["max_abs_diff"] > MESH_LOSS_TOL:
        problems.append("the 2-layer losses on the mesh are %g from phase 11's"
                        % out["short"]["max_abs_diff"])
    if out["compressed"]["max_abs_diff"] > MESH_LOSS_TOL:
        problems.append("the compressed losses on the mesh are %g from phase 11's"
                        % out["compressed"]["max_abs_diff"])
    losses = out["short"]["losses"] + out["full"]["losses"] + out["compressed"]["losses"]
    if not all(np.isfinite(losses)):
        problems.append("a loss is not finite")
    for leg in (out["short"], out["full"]):
        if any(v != ["cuda"] for v in leg["devices"].values()):
            problems.append("a parameter, gradient or moment is off the card: %s"
                            % leg["devices"])
    if not out["compressed"]["on_card"]:
        problems.append("a parameter, moment or error state of the compressed leg is off the "
                        "card")
    if not out["compressed_psum"]["equal"]:
        problems.append("compressed_psum over NCCL differs from compress/decompress")
    sv = out["serve"]
    if not (sv["tokens_equal"] and sv["logits_ratio"] <= 1):
        problems.append("decode on the mesh differs from phase 10's: tokens equal %s, logits "
                        "%g of the bound" % (sv["tokens_equal"], sv["logits_ratio"]))
    if not (sv["params_on_card"] and sv["caches_on_card"] and sv["caches_match_abstract"]):
        problems.append("a served parameter or cache is off the card, or the caches differ "
                        "from caches_abstract")
    if unlaunched(out["launches"]):
        problems.append("a kernel never launched on the mesh path: %s" % out["launches"])
    if out["engine"]["errors"] or out["engine"]["fallbacks"] != before["fallbacks"]:
        problems.append("the corpus engine erred or fell back: %s" % out["engine"])
    if problems:
        raise AssertionError("mesh path: %s; %s" % ("; ".join(problems), json.dumps(out)[:4000]))
    return out


# The mesh's losses against phase 11's: phase 11's own restore bound. At
# world size 1 the two steps are one computation (measured 0 on an H100).
MESH_LOSS_TOL = 1e-3


def log_mesh(mesh: dict, card: str) -> None:
    f, prof, sv = mesh["full"], mesh["full"]["profile"], mesh["serve"]
    log("mesh path [%s]: backend %s, world size %d, mesh %s" % (
        card, mesh["backend"], mesh["world_size"], json.dumps(mesh["mesh"])))
    log("mesh path [%s]: 2 layers, %d steps: losses %s; phase 11 %s; max |diff| %.3g"
        % (card, len(mesh["short"]["losses"]), json.dumps(mesh["short"]["losses"]),
           json.dumps(mesh["short"]["phase11_losses"]), mesh["short"]["max_abs_diff"]))
    log("mesh path [%s]: %s at full width (%d parameters), %d layers: step ms p50 %.3f p99 %.3f "
        "over steps 2-%d (first %.3f), %.1f tokens/s, data share %.4f, max_memory_allocated %d; "
        "%d profiled steps, device busy %.3f ms of %.3f s (idle share %s); losses %s"
        % (card, TRAIN_ARCH, f["params"], 40, f["step_ms"]["p50"], f["step_ms"]["p99"],
           MESH_FULL_STEPS, f["step_ms"]["first"], f["tokens_per_s"], f["data_share"],
           f["max_memory_allocated"], prof["steps"], prof["device_busy_ms"], prof["wall_s"],
           prof["device_idle_share"], json.dumps(f["losses"])))
    log("mesh path [%s]: compressed, 2 layers: losses %s, phase 11 %s, max |diff| %.3g, step ms "
        "%s; compressed_psum of %s over NCCL equal to compress/decompress %s, p50 %.3f ms"
        % (card, json.dumps(mesh["compressed"]["losses"]),
           json.dumps(mesh["compressed"]["phase11_losses"]), mesh["compressed"]["max_abs_diff"],
           json.dumps(mesh["compressed"]["step_ms"]), mesh["compressed_psum"]["shape"],
           mesh["compressed_psum"]["equal"], mesh["compressed_psum"]["ms_p50"]))
    log("mesh path [%s]: serve, %d prompts of %d tokens, %d greedy steps: prefill %.3f ms, "
        "decode ms p50 %.3f p99 %.3f (%.1f tokens/s); tokens equal to phase 10's %s, logits max "
        "|diff| %.3g (%.3g of the %g bound), prefill %.3g; max_memory_allocated %d"
        % (card, SERVE_BATCH, SERVE_PROMPT, MESH_SERVE_NEW, sv["prefill_ms"],
           sv["decode_ms"]["p50"], sv["decode_ms"]["p99"], sv["decode_tokens_per_s"],
           sv["tokens_equal"], sv["logits_max_abs_diff"], sv["logits_ratio"], SERVE_TOL,
           sv["prefill_max_abs_diff"], sv["max_memory_allocated"]))
    log("mesh path [%s]: launches %s; engine %s; seconds %.3f"
        % (card, json.dumps(mesh["launches"]), json.dumps(mesh["engine"]), mesh["seconds"]))


def log_train(train: dict, card: str) -> None:
    st, prof, rest = train["step_ms"], train["profile"], train["restore"]
    log("train path [%s]: %s at full width (%d parameters), batch %d x seq %d: step ms p50 %.3f "
        "p99 %.3f over steps 3-%d (first %.3f), %.1f tokens/s, data share %.4f, "
        "max_memory_allocated %d; losses %s"
        % (card, train["arch"], train["params"], train["batch"], train["seq"], st["p50"],
           st["p99"], train["steps"], st["first"], train["tokens_per_s"], train["data_share"],
           train["max_memory_allocated"], json.dumps(train["losses"])))
    log("train path [%s]: %d profiled steps in %.3f s, device busy %.3f ms over %d device ops "
        "(idle share %s); top ops %s; launches %s; devices %s"
        % (card, prof["steps"], prof["wall_s"], prof["device_busy_ms"], prof["device_op_count"],
           prof["device_idle_share"], json.dumps(prof["device_ops"][:8]),
           json.dumps(train["launches"]), json.dumps(train["devices"])))
    log("train path [%s]: restore leg (%d layers, %d parameters): checkpoint %d bytes on disk, "
        "save %.3f s, restore %.3f s, %d leaves bit-equal, batches equal %s, resumed losses "
        "within %.3g of the unbroken run's, grad_accum 2 vs 1 ratio %.4f; unbroken %s; "
        "broken %s; compressed losses %s, step ms %s"
        % (card, rest["layers"], rest["params"], rest["ckpt_bytes"], rest["save_s"],
           rest["restore_s"], rest["restored_leaves"], rest["batches_equal"],
           rest["resumed_loss_max_abs_diff"], rest["accum_ratio"],
           json.dumps(rest["unbroken_losses"]), json.dumps(rest["broken_losses"]),
           json.dumps(rest["compressed"]["losses"]), json.dumps(rest["compressed"]["step_ms"])))
    for arch, fam in train["families"].items():
        log("train path [%s]: %s at full width (%d parameters): losses %s, step ms %s, "
            "max_memory_allocated %d" % (card, arch, fam["params"], json.dumps(fam["losses"]),
                                         json.dumps(fam["step_ms"]), fam["max_memory_allocated"]))
    log("train path [%s]: seconds %.3f (restore leg %.3f)" % (card, train["seconds"],
                                                              train["restore_leg_s"]))


def log_serve(serve: dict, card: str) -> None:
    d, prof, rd = serve["decode_ms"], serve["profiled"], serve["reads"]
    log("serve path [%s]: %s, %d prompts of %d tokens, %d greedy steps: prefill %.3f ms (first "
        "call %.3f); decode "
        "ms per step p50 %.3f p99 %.3f (%.1f tokens/s; %.1f tokens/s with the reads; p50 %.3f "
        "with no reads beside the steps); reads %d "
        "of %d bytes in %.3f s; max_memory_allocated %d (%d while drawing the weights); KV "
        "caches %d bytes"
        % (card, serve["arch"], serve["batch"], serve["prompt"], serve["new_tokens"],
           serve["prefill_ms"], serve["prefill_first_ms"], d["p50"], d["p99"],
           serve["decode_tokens_per_s"], serve["loop_tokens_per_s"], serve["quiet_ms"]["p50"],
           rd["n"], rd["bytes"], rd["s"],
           serve["max_memory_allocated"], serve["init_max_memory_allocated"],
           serve["cache_bytes"]))
    log("serve path [%s]: %d profiled steps in %.3f s (step p50 %.3f ms), device busy %.3f ms "
        "over %d device ops (idle share %s); top ops %s"
        % (card, prof["steps"], prof["wall_s"],
           prof["step_ms_p50"], prof["device_busy_ms"], prof["device_op_count"],
           prof["device_idle_share"], json.dumps(prof["device_ops"][:6])))
    log("serve path [%s]: engine %s; launches %s; seconds %s"
        % (card, json.dumps(serve["engine"]), json.dumps(serve["launches"]),
           json.dumps(serve["seconds"])))
    for row in serve["families"]:
        log("serve path [%s]: smoke width %s" % (card, json.dumps(row)))


def log_family(row: dict, card: str) -> None:
    d = row["decode_ms"]
    log("serve path [%s]: %s at full width (%d parameters), %d prompts of %d tokens: prefill "
        "%.3f ms, decode ms per step p50 %.3f p99 %.3f (%.1f tokens/s), max_memory_allocated "
        "%d; decode against the teacher-forced forward in bf16 at rtol = atol = %g: %s; in fp64 "
        "(fatal at %g): %s (%.3f s)"
        % (card, row["arch"], row["params"], row["batch"], row["prompt"], row["prefill_ms"],
           d["p50"], d["p99"], row["decode_tokens_per_s"], row["max_memory_allocated"],
           SERVE_TOL, json.dumps(row["consistency_bf16"]), FP64_TOL, json.dumps(row["fp64"]),
           row["fp64_s"]))


def log_fleet(fleet: dict, card: str) -> None:
    log("fleet path [%s]: %d peers, a %d-byte archive (gzip %d); open on the owner (its first "
        "pass) %.3f s; stream MB/s %.3f before the kill, %.3f after it (%.3f from the first "
        "chunk after it); owner killed after %d bytes, its close() %.4f s, kill to next chunk "
        "%.4f s, longest stall after the kill (the survivor's first pass) %.3f s; client %s"
        % (card, fleet["peers"], fleet["corpus_bytes"], fleet["gzip_bytes"], fleet["open_s"],
           fleet["MBps_before_kill"], fleet["MBps_after_kill"], fleet["MBps_resumed"],
           fleet["killed_at"], fleet["close_s"], fleet["gap_s"], fleet["stall_s"],
           json.dumps(fleet["client"])))
    log("fleet path [%s]: stream device busy %.3f ms of %.3f s (idle share %s); device ops %s"
        % (card, fleet["stream_device_busy_ms"], fleet["stream_s"],
           fleet["stream_device_idle_share"], json.dumps(fleet["stream_device_ops"])))
    log("fleet path [%s]: third peer warm open %.4f s (remote_hits %d); pread p50/p99 ms, all "
        "%s, by size %s; launches %s; engine requests: owner %s, survivor %s, third %s"
        % (card, fleet["warm_open_s"], fleet["remote_hits"], json.dumps(fleet["pread_all"]),
           json.dumps(fleet["pread_latency"]), json.dumps(fleet["launches"]),
           *(json.dumps(fleet["engines"][k]["requests"]) for k in ("owner", "survivor", "third"))))


def log_pipeline(pipeline: dict, card: str) -> None:
    log("pipeline path [%s]: %d shards of %d bytes (gzip %s, shard %d over http://), %d batches "
        "of %d x %d in %.3f s: %.1f tokens/s (%.3f MB/s of corpus), first batch %.3f s; restore "
        "after batch %d in %.4f s to the first batch, %d nominal tasks"
        % (card, pipeline["shards"], pipeline["corpus_bytes"][0], pipeline["gzip_bytes"],
           pipeline["http_shard"], pipeline["batches"], pipeline["batch_size"],
           pipeline["seq_len"] + 1, pipeline["epoch_s"], pipeline["tokens_per_s"],
           pipeline["corpus_MBps"], pipeline["first_batch_s"], pipeline["saved_after_batch"],
           pipeline["restore_s"], pipeline["restore_fetcher"]["nominal_tasks"]))
    log("pipeline path [%s]: epoch device busy %.3f ms (idle share %s); device ops %s; engine %s; "
        "launches %s" % (card, pipeline["epoch_device_busy_ms"],
                         pipeline["epoch_device_idle_share"],
                         json.dumps(pipeline["epoch_device_ops"]), json.dumps(pipeline["engine"]),
                         json.dumps(pipeline["launches"])))


# ---------------------------------------------------------------------------
# phase 13: remat and the roofline
# ---------------------------------------------------------------------------

REMAT_ORDER = ("none", "dots", "full", "dots", "none")  # in turns, one step each
REMAT_LAYERS = 2
REMAT_BATCH = 2
# Phase 11's shape (40 layers, 8 x 128 tokens), where the step is host-bound:
# what remat's dispatch costs the host.
HOST_BATCH, HOST_SEQ = 8, 128
HOST_ORDER = ("none", "dots", "dots", "none")
ROOF_SEQ = 4096  # SHAPES["train_4k"].seq_len
ROOF_WARM, ROOF_TIMED, ROOF_PROFILED = 2, 4, 1
ROOF_BUDGET = 72e9  # the dry-run's estimate of the one-card step must stay under this
ROOF_BATCHES = (1, 2, 3, 4)  # estimated in parallel; the largest under the budget trains
CELL_LAYERS = 2  # depth of the production cell run on the card (its CE alone is ~65 GB)
# Phase 13 (c): production cells on (16, 16), rank 0 on the card over a fake
# group of 256, each in a worker of its own: (arch, shape, layers, global
# batch or None for the shape's own). xlstm-350m keeps one group of 8 blocks
# (7 mLSTM + 1 sLSTM) and 8 of its 16 rows a rank, the cut its leg has been
# measured at. hymba-1.5b decode_32k keeps 2 layers.
CELL_LEGS = (("granite-3-2b", "train_4k", CELL_LAYERS, None),
             ("xlstm-350m", "train_4k", 8, 128),
             ("hymba-1.5b", "decode_32k", 2, None))
# hymba's leg: a prefill one turn of the 1024-slot ring and 60 tokens past
# it, then decode steps on slots 60-67, across the end of rank 0's 64 slots.
CELL_PREFILL = 1024 + 60
CELL_DECODE_STEPS = 8
PR20_GRANITE_CELL = {"flops": 4.48e13, "max_memory_allocated": 68_304_327_680}
GNORM_RTOL = 1e-4  # the embedding's backward adds with atomics on the card


def _ask(argv):
    """Start this script as a worker (``--worker``) in a process of its own."""
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--worker",
                             json.dumps(argv)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _answer(proc, timeout: float = 600.0) -> dict:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError("a phase 13 worker ran past %d s: %s" % (timeout, err[-3000:]))
    if proc.returncode != 0:
        raise AssertionError("a phase 13 worker failed (exit %d): %s"
                             % (proc.returncode, err[-4000:]))
    return json.loads(out.strip().splitlines()[-1])


@contextlib.contextmanager
def _defined_fake_collectives():
    """The fake group's collectives return at once and write nothing, so a
    gather's other blocks would be whatever memory held: here every block
    is this rank's own (as if each rank held rank 0's data), so the values
    downstream are defined and their finiteness means something. Nothing
    else changes: reductions keep this rank's partial, as they do."""
    import torch.distributed as dist

    real = (dist.all_gather, dist.reduce_scatter_tensor, dist.all_to_all_single)

    def all_gather(parts, x, *a, **kw):
        work = real[0](parts, x, *a, **kw)
        for part in parts:
            part.copy_(x)
        return work

    def reduce_scatter_tensor(out, x, *a, **kw):
        work = real[1](out, x, *a, **kw)
        out.copy_(x[: out.shape[0]])
        return work

    def all_to_all_single(out, x, *a, **kw):
        work = real[2](out, x, *a, **kw)
        out.copy_(x)
        return work

    dist.all_gather, dist.reduce_scatter_tensor, dist.all_to_all_single = (
        all_gather, reduce_scatter_tensor, all_to_all_single)
    try:
        yield
    finally:
        dist.all_gather, dist.reduce_scatter_tensor, dist.all_to_all_single = real


def _cell_shape(spec: dict):
    import dataclasses

    from repro_torch.configs import SHAPES

    shape = SHAPES[spec["shape"]]
    return dataclasses.replace(shape, global_batch=spec["batch"]) if spec.get("batch") \
        else shape


def _profiled(fn, out: dict):
    """``fn()`` once under torch.profiler and CUDA events; into ``out``:
    wall ms (to the synchronize, before the profiler stops), event ms,
    device busy ms, and the seconds the profiler took to stop and sum."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        result = fn()
        end.record()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    # The device events' durations summed as they come (key_averages() would
    # first build a Python event tree: minutes for the sLSTM's ~10^6 events).
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and e.name() != "Command Buffer Full") / 1e6
    out.update(wall_ms=(t1 - t0) * 1e3, event_ms=start.elapsed_time(end), device_busy_ms=busy,
               profiler_s=time.perf_counter() - t1)
    return result


def _serve_cell(cfg, shape, mesh, rules, gen, out: dict) -> None:
    """A prefill of CELL_PREFILL tokens and CELL_DECODE_STEPS greedy decode
    steps of the global batch through make_serve_steps on the fake group:
    the first step places the caches (the global ones are then dropped),
    the others are measured."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    from repro_torch.serve import make_serve_steps, prefill_to_decode_caches

    model = build_model(cfg, device="cuda")
    model.init(gen)
    prefill, decode, _, _ = make_serve_steps(model, mesh, rules, batch=shape.global_batch,
                                             max_len=shape.seq_len)
    params = model.param_tree()
    prompts = torch.randint(0, cfg.vocab_size, (shape.global_batch, CELL_PREFILL),
                            generator=gen, device="cuda")
    logits, pc = prefill(params, {"tokens": prompts})
    caches = prefill_to_decode_caches(cfg, model, pc, shape.global_batch, shape.seq_len,
                                      CELL_PREFILL)
    del pc
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    finite = [bool(torch.isfinite(logits).all())]
    tok, logits, caches = decode(params, tok, caches, CELL_PREFILL)
    finite.append(bool(torch.isfinite(logits).all()))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def steps():
        nonlocal tok, logits, caches
        for i in range(1, CELL_DECODE_STEPS):
            tok, logits, caches = decode(params, tok, caches, CELL_PREFILL + i)
            finite.append(bool(torch.isfinite(logits).all()))

    _profiled(steps, out)
    attn = caches["layers"]["attn"]
    out.update(measured="decode steps 2-%d" % CELL_DECODE_STEPS,
               max_memory_allocated=torch.cuda.max_memory_allocated(), finite=all(finite),
               on_card=all(t.device.type == "cuda" for t in dryrun._tensors((params, caches))),
               ring_block={k: list(v.shape) for k, v in attn.items()},
               # the positions slots 56-71 hold: the prefill's second turn,
               # the decode steps, the first turn
               ring_pos_56_71=attn["pos"][0, 56:72].tolist())


def worker(spec: dict) -> dict:
    """What a phase 13 worker computes, in a process whose fake group is
    its own: ``estimate`` (the dry-run's count of one step on fake tensors
    on a one-card mesh, on the host), ``cell_estimate`` (the same of a
    production cell, cut as ``spec`` says), or ``cell`` (the production
    cell's rank 0 on the card: a train step, once to warm up and once
    measured, or hymba's prefill and decode steps, ``_serve_cell``)."""
    import dataclasses

    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.distributed import default_rules
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import PRODUCTION_SHAPE

    cfg = dataclasses.replace(get_config(spec["arch"]), n_layers=spec["layers"])
    if spec["kind"] == "estimate":
        shape = ShapeConfig("one_card", "train", spec["seq"], spec["batch"])
        mesh = dryrun.fake_mesh((1, 1), ("data", "model"), "cpu")
        m = dryrun.run_step(cfg, shape, mesh, device="cpu")
        return dryrun.cell_result(cfg, shape, m, 1)
    shape = _cell_shape(spec)
    if spec["kind"] == "cell_estimate":
        mesh = dryrun.production_mesh(False, "cpu")
        return dryrun.cell_result(cfg, shape, dryrun.run_step(cfg, shape, mesh, device="cpu"),
                                  256)
    mesh = dryrun.production_mesh(False, "cuda")
    import torch.distributed as dist

    out = {"backend": dist.get_backend(), "world_size": dist.get_world_size(),
           "mesh": dict(zip(*PRODUCTION_SHAPE[False][::-1])), "rows": shape.global_batch // 16}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(spec["seed"])
    rules = default_rules(mesh)
    with _defined_fake_collectives():
        if shape.kind == "decode":
            _serve_cell(cfg, shape, mesh, rules, gen, out)
            return out
        args, rows, run = dryrun.prepare_step(cfg, shape, mesh, rules, "cuda", generator=gen)
        out["on_card"] = all(t.device.type == "cuda" for t in dryrun._tensors((args, rows)))
        losses = [float(run()[2]["loss"])]  # warm: cuBLAS handles, workspaces
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        result = _profiled(run, out)
    losses.append(float(result[2]["loss"]))
    out.update(measured="train step 2 of 2", losses=losses,
               finite=all(math.isfinite(x) for x in losses),
               max_memory_allocated=torch.cuda.max_memory_allocated())
    return out


def remat_ab(seed: int, card: str, layers: int, batch: int, seq: int, order) -> dict:
    """granite-3-2b at full width and ``layers`` layers, batch x seq
    tokens: one forward and backward of the trainer's loss per policy
    untimed, then one per policy in ``order``, on the same weights and
    batch. Fatal: a
    loss or gradient norm that differs from none's, or dots' memory not
    below none's."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_tensors
    from repro_torch.train import AdamWConfig, make_train_step

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=layers)
    model = build_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 130)
    model.init(gen)
    step = make_train_step(model, AdamWConfig(total_steps=1000))
    params = model.param_tree()
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen,
                           device="cuda", dtype=torch.int32)
    # Untimed first: each policy once (cuBLAS, the allocator, the checkpoint
    # machinery's first use).
    warm_order = tuple(dict.fromkeys(order))
    runs = []
    for policy in warm_order + tuple(order):
        model.cfg = dataclasses.replace(cfg, remat_policy=policy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _, grads = step.compute_grads(params, {"tokens": tokens})
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in tree_tensors(grads)))
        runs.append({"policy": policy, "ms": ms, "loss": float(loss), "grad_norm": float(gnorm),
                     "max_memory_allocated": torch.cuda.max_memory_allocated()})
        del grads
    del model, params, step
    torch.cuda.empty_cache()
    warm, runs = runs[:len(warm_order)], runs[len(warm_order):]
    ref = next(r for r in runs if r["policy"] == "none")
    by = {p: [r for r in runs if r["policy"] == p] for p in set(order)}
    out = {"card": card, "layers": layers, "batch": batch, "seq": seq, "order": list(order),
           "warm_up": warm, "runs": runs,
           "ms_median": {p: float(np.median([r["ms"] for r in rs])) for p, rs in by.items()},
           "memory": {p: max(r["max_memory_allocated"] for r in rs) for p, rs in by.items()}}
    problems = []
    for r in warm + runs:
        if r["loss"] != ref["loss"] or not np.isfinite(r["loss"]):
            problems.append("%s: loss %r, none's %r" % (r["policy"], r["loss"], ref["loss"]))
        if abs(r["grad_norm"] - ref["grad_norm"]) > GNORM_RTOL * abs(ref["grad_norm"]):
            problems.append("%s: grad norm %r, none's %r" % (r["policy"], r["grad_norm"],
                                                             ref["grad_norm"]))
    if not out["memory"]["dots"] < out["memory"]["none"]:
        problems.append("dots' memory %d not below none's %d" % (out["memory"]["dots"],
                                                                 out["memory"]["none"]))
    if problems:
        raise AssertionError("remat A/B: %s; %s" % ("; ".join(problems), json.dumps(out)))
    return out


def _legs() -> list:
    return [{"arch": arch, "shape": shape, "layers": n, "batch": batch}
            for arch, shape, n, batch in CELL_LEGS]


def start_cell_estimates() -> list:
    """The dry-run's estimate of each of phase 13 (c)'s cut cells, each in a
    worker process on the host, started now and read by
    ``production_cells``."""
    return [_ask(dict(leg, kind="cell_estimate")) for leg in _legs()]


def production_cells(seed: int, estimates: list) -> list:
    """Phase 13 (c): each of CELL_LEGS on the card, one worker after
    another, beside its estimate (``start_cell_estimates``)."""
    cells = []
    for n, (leg, proc) in enumerate(zip(_legs(), estimates)):
        t0 = time.perf_counter()
        ce = _answer(proc, timeout=900)
        t1 = time.perf_counter()
        cell = _answer(_ask(dict(leg, kind="cell", seed=seed + 131 + n)), timeout=900)
        cell.update(leg, estimate_wait_s=t1 - t0, worker_s=time.perf_counter() - t1,
                    estimate_peak_bytes=ce["memory"]["peak_bytes"],
                    estimate_argument_bytes=ce["memory"]["argument_size_in_bytes"],
                    t_compute_ms=ce["roofline"]["t_compute"] * 1e3,
                    t_memory_ms=ce["roofline"]["t_memory"] * 1e3,
                    t_collective_ms=ce["roofline"]["t_collective"] * 1e3,
                    flops=ce["cost"]["flops"], bytes=ce["cost"]["bytes accessed"])
        cells.append(cell)
    return cells


def roofline_path(seed: int, card: str, cell_estimates: list) -> dict:
    """Phase 13: (a) remat A/B, at seq ROOF_SEQ and at phase 11's shape;
    (b) granite-3-2b at its 40 layers and
    sequence ROOF_SEQ through repro_torch.launch.train.run on phase 11's
    shards with the config's remat, at the largest batch whose dry-run
    estimate (mesh (1, 1)) stays under ROOF_BUDGET, against that estimate;
    (c) the production cells of CELL_LEGS on the card, each against the
    dry-run's estimate of it (``cell_estimates``: ``start_cell_estimates``,
    started before phase 11 so the host has made them by now)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import crc32 as kc
    from repro_torch.kernels import marker_replace as mr
    from repro_torch.kernels.engine import shared_engine
    from repro_torch.launch import roofline
    from repro_torch.launch import train as launch

    t_phase = time.perf_counter()
    layers = get_config(TRAIN_ARCH).n_layers
    estimates = {b: _ask({"kind": "estimate", "arch": TRAIN_ARCH, "layers": layers,
                          "seq": ROOF_SEQ, "batch": b}) for b in ROOF_BATCHES}
    out = {"card": card,
           "remat": remat_ab(seed, card, REMAT_LAYERS, REMAT_BATCH, ROOF_SEQ, REMAT_ORDER),
           "remat_host": remat_ab(seed, card, layers, HOST_BATCH, HOST_SEQ, HOST_ORDER)}
    parts = {"a": time.perf_counter() - t_phase}
    estimates = {b: _answer(p) for b, p in estimates.items()}
    fitting = [b for b, e in estimates.items() if e["memory"]["peak_bytes"] < ROOF_BUDGET]
    if not fitting:
        raise AssertionError("no batch of %s fits %g bytes by the dry-run: %s" % (
            ROOF_BATCHES, ROOF_BUDGET, {b: e["memory"] for b, e in estimates.items()}))
    batch = max(fitting)
    est = estimates[batch]
    out["estimates"] = {b: {"peak_bytes": e["memory"]["peak_bytes"], "flops": e["cost"]["flops"],
                            "roofline": e["roofline"]} for b, e in estimates.items()}

    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="roofline-", dir=ROOT / "build"))
    engine = shared_engine("cuda")
    before = engine.stats()
    relay = lambda line: log("roofline path [%s]: %s" % (card, line))  # noqa: E731
    try:
        corpus = work / "corpus"
        corpus.mkdir()
        for i in range(TRAIN_SHARDS):  # phase 11's shards, made again from the seed
            (corpus / ("shard_%03d.gz" % i)).write_bytes(
                gzip.compress(base64_corpus(seed + 70 + i, TRAIN_SHARD_MIB << 20), 6, mtime=0))
        args = _driver_args(work, TRAIN_ARCH, ROOF_WARM + ROOF_TIMED + ROOF_PROFILED, seed + 70,
                            "--seq", str(ROOF_SEQ), "--batch", str(batch),
                            "--profile-steps", str(ROOF_PROFILED))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mr.reset_launches()
        kc.reset_launches()
        run = launch.run(args, log=relay)
        launches = stage2_launches()
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    after = engine.stats()
    timed = [s * 1e3 for s in run["step_s"][ROOF_WARM:ROOF_WARM + ROOF_TIMED]]
    p50 = float(np.percentile(timed, 50))
    terms = est["roofline"]
    out["train"] = {
        "arch": TRAIN_ARCH, "layers": layers, "params": run["params"], "batch": batch,
        "seq": ROOF_SEQ, "remat_policy": get_config(TRAIN_ARCH).remat_policy,
        "losses": run["losses"], "step_ms": {"p50": p50, "all": [s * 1e3 for s in run["step_s"]]},
        "tokens_per_s": batch * ROOF_SEQ / (p50 / 1e3),
        "max_memory_allocated": peak, "estimate_peak_bytes": est["memory"]["peak_bytes"],
        "estimate_argument_bytes": est["memory"]["argument_size_in_bytes"],
        "flops": est["cost"]["flops"], "achieved_tflops": est["cost"]["flops"] / (p50 / 1e3) / 1e12,
        "peak_share": est["cost"]["flops"] / (p50 / 1e3) / roofline.PEAK_FLOPS,
        "t_compute_ms": terms["t_compute"] * 1e3, "t_memory_ms": terms["t_memory"] * 1e3,
        "t_collective_ms": terms["t_collective"] * 1e3, "dominant": terms["dominant"],
        "launches": launches, "devices": run["devices"], "data_share": run["data_share"],
        "profile": run["profile"],
    }
    torch.cuda.synchronize()
    parts["b"] = time.perf_counter() - t_phase - parts["a"]
    out["cells"] = production_cells(seed, cell_estimates)
    parts["c"] = time.perf_counter() - t_phase - parts["a"] - parts["b"]
    out["seconds_by_part"] = parts
    out["launches"] = launches
    out["engine"] = {"errors": after["errors"] - before["errors"], "fallbacks": after["fallbacks"]}
    out["seconds"] = time.perf_counter() - t_phase
    problems = []
    if not all(np.isfinite(run["losses"])):
        problems.append("a loss is not finite: %s" % run["losses"])
    if unlaunched(launches):
        problems.append("a kernel never launched on the roofline path: %s" % launches)
    if any(v != ["cuda"] for v in run["devices"].values()):
        problems.append("a parameter, gradient or moment is off the card: %s" % run["devices"])
    if after["errors"] != before["errors"] or after["fallbacks"] != before["fallbacks"]:
        problems.append("the corpus engine erred or fell back")
    for cell in out["cells"]:
        if cell["backend"] != "fake" or cell["world_size"] != 256 or not cell["on_card"]:
            problems.append("a production cell did not run on the card over a fake group of "
                            "256: %s" % json.dumps(cell))
        if not cell["finite"]:
            problems.append("a production cell's loss or logits are not finite: %s"
                            % json.dumps(cell))
    if problems:
        raise AssertionError("roofline path: %s; %s" % ("; ".join(problems),
                                                        json.dumps(out)[:4000]))
    return out


def log_roofline(r: dict, card: str) -> None:
    t = r["train"]
    for a in (r["remat"], r["remat_host"]):
        log("roofline path [%s]: (a) remat A/B, %s at full width, %d layers, batch %d x seq %d, "
            "in turns %s after one untimed each: max_memory_allocated %s; ms median %s; runs %s"
            % (card, TRAIN_ARCH, a["layers"], a["batch"], a["seq"], "/".join(a["order"]),
               json.dumps(a["memory"]), json.dumps(a["ms_median"]), json.dumps(a["runs"])))
    log("roofline path [%s]: (b) dry-run estimates of the one-card step at %d layers, seq %d, by "
        "batch: %s" % (card, t["layers"], t["seq"], json.dumps(
            {b: e["peak_bytes"] for b, e in r["estimates"].items()})))
    log("roofline path [%s]: (b) %s, %d layers, %s remat, batch %d x seq %d: step ms p50 %.3f "
        "(all %s), %.1f tokens/s; max_memory_allocated %d against the dry-run's %d; %.4g "
        "FLOP a step, %.2f TFLOP/s achieved, %.4f of 989; roofline terms ms: compute %.3f, "
        "memory %.3f (unfused eager bytes), collective %.3f; losses %s; launches %s"
        % (card, TRAIN_ARCH, t["layers"], t["remat_policy"], t["batch"], t["seq"],
           t["step_ms"]["p50"], json.dumps(t["step_ms"]["all"]), t["tokens_per_s"],
           t["max_memory_allocated"], t["estimate_peak_bytes"], t["flops"], t["achieved_tflops"],
           t["peak_share"], t["t_compute_ms"], t["t_memory_ms"], t["t_collective_ms"],
           json.dumps(t["losses"]), json.dumps(t["launches"])))
    prof = t["profile"]
    log("roofline path [%s]: (b) %d profiled step: device busy %.3f ms of %.3f s (idle share %s) "
        "over %d device ops; top ops %s" % (card, prof["steps"], prof["device_busy_ms"],
                                            prof["wall_s"], prof["device_idle_share"],
                                            prof["device_op_count"],
                                            json.dumps(prof["device_ops"][:8])))
    for c in r["cells"]:
        cuts = "%d layers" % c["layers"]
        if c["batch"]:
            cuts += ", global batch %d (%d rows a rank)" % (c["batch"], c["rows"])
        log("roofline path [%s]: (c) %s %s cut to %s; rank 0 of (16, 16) over a %s group of %d "
            "on the card, %s: max_memory_allocated %d against the dry-run's %d (arguments %d); "
            "device busy %.3f ms, events %.3f ms, wall %.3f ms; dry-run %.6g FLOP, %.6g bytes, "
            "terms ms: compute %.3f, memory %.3f, collective %.3f; %s"
            % (card, c["arch"], c["shape"], cuts, c["backend"], c["world_size"], c["measured"],
               c["max_memory_allocated"], c["estimate_peak_bytes"], c["estimate_argument_bytes"],
               c["device_busy_ms"], c["event_ms"], c["wall_ms"], c["flops"], c["bytes"],
               c["t_compute_ms"], c["t_memory_ms"], c["t_collective_ms"],
               json.dumps({k: c[k] for k in ("losses", "ring_block", "ring_pos_56_71",
                                             "estimate_wait_s", "worker_s", "profiler_s")
                           if k in c})))
        if c["arch"] == TRAIN_ARCH:
            log("roofline path [%s]: (c) %s against PR 20's leg: %.6g FLOP against %.6g, "
                "max_memory_allocated %d against %d" % (
                    card, c["arch"], c["flops"], PR20_GRANITE_CELL["flops"],
                    c["max_memory_allocated"], PR20_GRANITE_CELL["max_memory_allocated"]))
    log("roofline path [%s]: seconds %.3f (by part %s)" % (card, r["seconds"],
                                                        json.dumps(r["seconds_by_part"])))


# ---------------------------------------------------------------------------
# phase 14: routing and examples
# ---------------------------------------------------------------------------

ROUTING_READ_MIB = 4
ROUTING_PREADS = 64
ROUTING_SEED = 140  # offset of the read's corpus seed
EXAMPLES = ("quickstart_torch", "serve_gateway_torch", "serve_fleet_torch")


def load_sweep_tool():
    """``tools/engine_sweep.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("engine_sweep",
                                                  ROOT / "tools" / "engine_sweep.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def start_examples() -> dict:
    """The port's three examples on the card, each in a process of its own,
    all started together: name -> (process, start time)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return {name: (subprocess.Popen([sys.executable, str(ROOT / "examples" / (name + ".py")),
                                     "--device", "cuda"], env=env, cwd=str(ROOT),
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                   time.perf_counter())
            for name in EXAMPLES}


def finish_examples(procs: dict, timeout: float = 600.0) -> dict:
    """Waits for every example (killing any still running on an error):
    name -> exit code, wall seconds and the tail of its output."""
    out = {}
    try:
        for name, (proc, t0) in procs.items():
            text, _ = proc.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
            out[name] = {"rc": proc.returncode, "wall_s": time.perf_counter() - t0,
                         "tail": text[-2000:]}
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def probe_sizes(threshold, rng) -> list:
    """Two seeded request sizes: one below the threshold and one at or above
    it, with where each must land; a None threshold sends both to the host."""
    if threshold is None:
        return [(int(rng.integers(1, 8192)), "host"), (int(rng.integers(1 << 20, 2 << 20)), "host")]
    below = [(int(rng.integers(max(1, threshold // 2), threshold)), "host")] if threshold > 1 else []
    return below + [(threshold + int(rng.integers(0, 8192)), "card")]


def routing_path(seed: int, card: str) -> dict:
    """Phase 14: the engine sweep on the card beside the committed artifact,
    an engine routed by that artifact (``crossover="auto"``) held to where
    each request must land and to the host path and zlib, a read through
    it, and the port's three examples on the card."""
    import numpy as np

    from repro_torch.core import ParallelGzipReader
    from repro_torch.core.markers import replace_markers as host_replace
    from repro_torch.kernels import crc32 as kc
    from repro_torch.kernels import marker_replace as mr
    from repro_torch.kernels import precode_check as pc
    from repro_torch.kernels.engine import SWEEP_ARTIFACT, TorchDecodeEngine, derive_crossover

    t_phase = time.perf_counter()
    for kernel in (mr, kc, pc):
        kernel.reset_launches()
    out = {}

    # (a) the sweep, with its own defaults (the committed artifact's data).
    tool = load_sweep_tool()
    committed = json.loads((ROOT / SWEEP_ARTIFACT).read_text())
    t0 = time.perf_counter()
    rows = tool.sweep("cuda", repeats=committed["repeats"])
    out["sweep"] = {"rows": rows, "crossover": derive_crossover(rows),
                    "seconds": time.perf_counter() - t0,
                    "launches": stage2_launches()}
    out["committed"] = {"card": committed["card"]["nvidia_smi"], "commit": committed["commit"],
                        "rows": committed["results"], "crossover": committed["crossover"]}
    want_names = {r["name"] for r in committed["results"]}
    if {r["name"] for r in rows} != want_names:
        raise AssertionError("the sweep's rows are not the artifact's: %s"
                             % sorted({r["name"] for r in rows} ^ want_names))

    # (c) starts here, in the background, while (b) runs.
    examples = start_examples()
    try:
        # (b) routing by the committed artifact.
        t0 = time.perf_counter()
        rng = np.random.default_rng(seed + ROUTING_SEED)
        problems = []
        with shared_engine_untouched(), TorchDecodeEngine(crossover="auto") as eng:
            want = derive_crossover(committed["results"])
            if eng.crossover != want or want != committed["crossover"]:
                raise AssertionError("crossover='auto' gave %s; the artifact's rows give %s and "
                                     "it records %s" % (eng.crossover, want,
                                                        committed["crossover"]))
            window = rng.integers(0, 256, 32768, dtype=np.uint8).tobytes()
            probes = []
            for kind in ("replace", "crc"):
                for n, where in probe_sizes(eng.crossover[kind], rng):
                    before = (eng.stats()["fallbacks"][kind],
                              sum(v for k, v in eng.dispatch_shapes().items() if k[0] == kind))
                    if kind == "replace":
                        syms = rng.integers(0, 33024, n, dtype=np.int64).astype(np.uint16)
                        exact = np.array_equal(eng.replace_markers(syms, window),
                                               host_replace(syms, window))
                    else:
                        blob = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                        exact = eng.crc32(blob) == zlib.crc32(blob)
                    after = (eng.stats()["fallbacks"][kind],
                             sum(v for k, v in eng.dispatch_shapes().items() if k[0] == kind))
                    landed = ("host" if after[0] == before[0] + 1 and after[1] == before[1]
                              else "card" if after[0] == before[0] and after[1] > before[1]
                              else "unclear")
                    probes.append({"kind": kind, "bytes": n, "want": where, "landed": landed,
                                   "exact": bool(exact)})
                    if landed != where or not exact:
                        problems.append("a %s request of %d bytes landed on the %s (want %s), "
                                        "exact %s" % (kind, n, landed, where, exact))
            out["probes"] = probes
            probe_stats = eng.stats()

            corpus = base64_corpus(seed + ROUTING_SEED, ROUTING_READ_MIB << 20)
            gz = gzip.compress(corpus, 6, mtime=0)
            t_read = time.perf_counter()
            workers = min(16, os.cpu_count() or 1)
            with ParallelGzipReader(gz, chunk_size=1 << 20, parallelization=workers,
                                    resolver=eng) as r:
                if r.read() != corpus:
                    problems.append("the read through the routed engine differs from the corpus")
                read_s = time.perf_counter() - t_read
                for _ in range(ROUTING_PREADS):
                    off = int(rng.integers(0, len(corpus)))
                    size = int(rng.integers(0, 64 << 10))
                    if r.pread(off, size) != corpus[off : off + size]:
                        problems.append("pread(%d, %d) differs" % (off, size))
            stats = eng.stats()
            out["read"] = {
                "corpus_bytes": len(corpus), "gzip_bytes": len(gz), "read_s": read_s,
                "MBps": len(corpus) / read_s / 1e6, "preads": ROUTING_PREADS,
                "requests": {k: stats["requests"][k] - probe_stats["requests"][k]
                             for k in stats["requests"]},
                "fallbacks": {k: stats["fallbacks"][k] - probe_stats["fallbacks"][k]
                              for k in stats["fallbacks"]},
                "errors": stats["errors"],
            }
            out["engine"] = {"crossover": eng.crossover, "requests": stats["requests"],
                             "fallbacks": stats["fallbacks"], "batches": stats["batches"],
                             "errors": stats["errors"],
                             "shapes": {"%s:%d:%d" % k: v
                                        for k, v in eng.dispatch_shapes().items()}}
            if stats["errors"]:
                problems.append("the routed engine erred: %s" % stats["errors"])
        out["routed_s"] = time.perf_counter() - t0
    finally:
        # (c) the examples' results.
        out["examples"] = finish_examples(examples)
    for name, ex in out["examples"].items():
        if ex["rc"] != 0:
            problems.append("examples/%s.py --device cuda exited %s: %s"
                            % (name, ex["rc"], ex["tail"][-1500:]))
    out["launches"] = dict(stage2_launches(), precode_check=pc.launches)
    if min(out["launches"]["marker_replace"], out["launches"]["crc32"]) < 1:
        problems.append("a stage-2 kernel never launched in the phase: %s" % out["launches"])
    out["seconds"] = time.perf_counter() - t_phase
    if problems:
        raise AssertionError("routing path: %s; %s" % ("; ".join(problems),
                                                      json.dumps(out)[:4000]))
    return out


def log_routing(r: dict, card: str) -> None:
    s = r["sweep"]
    log("routing path [%s]: (a) engine sweep on the card in %.3f s (launches %s):"
        % (card, s["seconds"], json.dumps(s["launches"])))
    committed = {row["name"]: row for row in r["committed"]["rows"]}
    for row in s["rows"]:
        old = committed.get(row["name"], {})
        log("  %-40s %12.3f us  %-44s | committed %12s us  %s"
            % (row["name"], row["value_us"], row["derived"], old.get("value_us"),
               old.get("derived")))
    log("routing path [%s]: (a) crossover bytes from this run %s; committed (%s, %s) %s"
        % (card, json.dumps(s["crossover"]), r["committed"]["card"], r["committed"]["commit"],
           json.dumps(r["committed"]["crossover"])))
    for p in r["probes"]:
        log("routing path [%s]: (b) %s request of %d bytes: want %s, landed %s, exact %s"
            % (card, p["kind"], p["bytes"], p["want"], p["landed"], p["exact"]))
    rd = r["read"]
    log("routing path [%s]: (b) %d-byte base64 corpus (gzip %d) read exact through "
        "crossover='auto' in %.3f s (%.3f MB/s), %d preads exact; the read's requests %s, "
        "fallbacks %s; engine %s"
        % (card, rd["corpus_bytes"], rd["gzip_bytes"], rd["read_s"], rd["MBps"], rd["preads"],
           json.dumps(rd["requests"]), json.dumps(rd["fallbacks"]), json.dumps(r["engine"])))
    for name, ex in r["examples"].items():
        log("routing path [%s]: (c) examples/%s.py --device cuda: exit %d, wall %.3f s"
            % (card, name, ex["rc"], ex["wall_s"]))
    log("routing path [%s]: launches %s; (b) %.3f s; seconds %.3f"
        % (card, json.dumps(r["launches"]), r["routed_s"], r["seconds"]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mib", type=int, default=16, help="corpus size of the main path")
    ap.add_argument("--out", help="also write every result to this JSON file")
    ap.add_argument("--worker", help=argparse.SUPPRESS)  # phase 13's processes
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.worker:
        print(json.dumps(worker(json.loads(args.worker))))
        return 0
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
    at_path = [marker_case(rep[1], rep[2], gen, device),
               crc_case(crc[1], crc[2], gen, device, fold=True)]
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
    with shared_engine_untouched():
        service = service_path(args.seed, card)
    service["launches"] = stage2_launches()
    if unlaunched(service["launches"]):
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

    with shared_engine_untouched():
        fleet = fleet_path(args.seed, card)
    if unlaunched(fleet["launches"]):
        raise AssertionError("a kernel never launched on the fleet path: %s" % fleet["launches"])
    log_fleet(fleet, card)

    pipeline = pipeline_path(args.seed, card)
    if unlaunched(pipeline["launches"]):
        raise AssertionError("a kernel never launched on the pipeline path: %s"
                             % pipeline["launches"])
    log_pipeline(pipeline, card)

    with shared_engine_untouched():
        serve = serve_path(args.seed, card)
    log_serve(serve, card)
    serve["full_width_families"] = [family_serve(arch, args.seed + offset, card)
                                    for arch, offset in FAMILY_SERVE]
    for row in serve["full_width_families"]:
        log_family(row, card)

    cell_estimates = start_cell_estimates()  # phase 13 (c)'s, on the host meanwhile
    train = train_path(args.seed, card)
    log_train(train, card)

    mesh = mesh_path(args.seed, card, train)
    log_mesh(mesh, card)

    roof = roofline_path(args.seed, card, cell_estimates)
    log_roofline(roof, card)
    import torch.distributed as dist

    dist.destroy_process_group()  # the NCCL group phases 11-13 started

    routing = routing_path(args.seed, card)
    log_routing(routing, card)

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
    # And every path's launches, each counted from 0 (the precheck runs on
    # the ops path only).
    by_path = {"main": path["launches"], "ops": ops["launches"], "service": service["launches"],
               "fleet": fleet["launches"], "pipeline": pipeline["launches"],
               "serve": serve["launches"], "train": train["launches"],
               "mesh": mesh["launches"], "roofline": roof["launches"],
               "routing": routing["launches"]}
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
            "launches_by_path": {p: n.get(name, 0) for p, n in by_path.items()},
        })
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "card": card, "build_s": build_s, "launch_floor_ms": floor_ms, "kernel_rows": rows,
            "at_path": at_path, "main_path": path, "precode_rows": precode_rows, "ops_path": ops,
            "service_path": service, "fleet_path": fleet, "pipeline_path": pipeline,
            "serve_path": serve, "train_path": train, "mesh_path": mesh,
            "roofline_path": roof, "routing_path": routing, "kernels": kernels,
        }, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
