"""Whole cold reads in a closed loop: one reader at a time, a fresh
``ParallelGzipReader`` for each pass over the file, ``read(call bytes)``
until the file ends. The window is whole passes: it closes when the pass
during which its length ran out ends (a fresh reader fills its pipeline
before its first byte, so a pass cut short would weigh that fill by where
the cut fell). Every delivered byte is compared with the text after the
window.

After the window the same reader settings read one copy of the file whose
trailer was altered (its CRC32 or its size, one bit, drawn from the seed):
the configuration's second guarantee holds only if that read raises."""

from __future__ import annotations

import numpy as np

from .. import inputs
from ..harness import span
from ..reference.gzip_bytes import (TRAILER_FIELDS, control_decompress, corrupt_trailer,
                                    mismatched_bytes)
from .gzip_common import add_counts, delta, make_file, reader_kwargs


def small(cfg, tr):
    """The cell's configuration and traffic at the host tests' size."""
    return (dict(cfg, decompressed_bytes=300_000, chunk_size=64 << 10, index_spacing=64 << 10,
                 parallelization=2),
            dict(tr, warmup_bytes=150_000, read_call_bytes=100_000))


def altered_trailer(seed: int):
    """(field, bit) of the trailer that the seed's check alters."""
    rng = np.random.default_rng(inputs.stream(seed, "trailer"))
    return sorted(TRAILER_FIELDS)[int(rng.integers(2))], int(rng.integers(32))


def control(manifest, cell, cfg, tr, seed: int, **_) -> dict:
    """zlib in the program's place, checking neither CRC nor size, on the
    file with one bit of its deflate stream flipped and on the copy with
    its trailer altered (which it reads without raising)."""
    text, archive = make_file(seed, cfg)
    rng = np.random.default_rng(inputs.stream(seed, "control-flip"))
    data = control_decompress(archive, int(rng.integers(len(archive) // 4, len(archive) // 2)))
    delivered = control_decompress(corrupt_trailer(archive, *altered_trailer(seed)))
    return {"zlib_no_crc_flipped_bit": {
        "mismatched_bytes": mismatched_bytes(text, 0, data, len(text)),
        "altered_trailer_not_refused": int(len(delivered) > 0)}}


def run(run) -> None:
    import torch
    from repro_torch.core.reader import ParallelGzipReader
    from repro_torch.kernels.engine import TorchDecodeEngine

    cfg, tr = run.config, run.traffic
    text, archive = make_file(run.seed, cfg)
    path = str(run.write_scratch("file.gz", archive))
    kw = reader_kwargs(cfg)
    call = int(tr["read_call_bytes"])
    engine = TorchDecodeEngine(device=run.device)
    run.mark("inputs, engine and kernels")
    try:
        # Warm-up: a smaller file of the same kind through the same path, so
        # the kernels are loaded and each stage has run once.
        warm_text, warm_archive = make_file(run.seed, cfg, "warm", tr["warmup_bytes"])
        warm_path = str(run.write_scratch("warm.gz", warm_archive))
        with ParallelGzipReader(warm_path, resolver=engine, **kw) as r:
            if r.read() != warm_text:
                run.errors.append("the warm-up read differs from its text")
        run.mark("warm-up read")
        eng0, shapes0 = engine.stats(), engine.dispatch_shapes()
        fetcher: dict = {}
        deliveries, ends = [], []  # (offset, bytes); bytes delivered by each finished pass
        calls = failed = 0
        reader = None
        run.start_window()
        try:
            while not run.expired():
                reader, pos = ParallelGzipReader(path, resolver=engine, **kw), 0
                while True:
                    with span("pb.read"):
                        data = reader.read(call)
                    calls += 1
                    if not data:
                        break
                    deliveries.append((pos, data))
                    pos += len(data)
                ends.append(pos)
                add_counts(fetcher, reader.stats()["fetcher"])
                reader.close()
                reader = None
        except Exception as exc:  # a read that raises (a CRC error included) fails
            failed += 1
            run.errors.append("read raised %r" % (exc,))
        run.stop_window()
        eng1, shapes1 = engine.stats(), engine.dispatch_shapes()
        run.finish_trace()
        run.memory_peak_bytes = torch.cuda.max_memory_allocated() if run.device != "cpu" else 0
        if reader is not None:
            reader.close()
        field, bit = altered_trailer(run.seed)
        bad_path = str(run.write_scratch("altered.gz", corrupt_trailer(archive, field, bit)))
        not_refused, refusal = 1, None
        try:
            with ParallelGzipReader(bad_path, resolver=engine, **kw) as r:
                while r.read(call):
                    pass
        except Exception as exc:  # any refusal: the same read of the intact file passed
            not_refused, refusal = 0, repr(exc)
    finally:
        engine.shutdown()

    bad = 0
    for offset, data in deliveries:
        n = mismatched_bytes(text, offset, data, len(data))
        bad += n
        failed += bool(n)
    bad += sum(abs(len(text) - end) for end in ends)
    run.attempted, run.failed = calls, failed
    run.data.update(
        bytes=sum(len(d) for _, d in deliveries), fetcher=fetcher,
        engine={k: eng1[k] - eng0[k] for k in ("tiles_dispatched", "tiles_padded", "dispatches",
                                               "crc_bytes")},
        shapes=delta(shapes1, shapes0))
    run.data["notes"] = {"read_calls": calls, "passes": len(ends),
                         "altered_trailer": "%s bit %d: %s" % (field, bit, refusal)}
    run.check("mismatched_bytes", bad)
    run.check("failed_reads", failed)
    run.check("altered_trailer_not_refused", not_refused)
