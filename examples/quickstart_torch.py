"""Quickstart on PyTorch: parallel gzip decompression, random access, and
the seek index.

The counterpart of ``examples/quickstart.py``, step for step, on
``repro_torch``: stage 2 (marker resolution and CRC32) runs on the card by
default (``--device cpu`` runs the kernels' plain versions on the host).

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse
import gzip
import io
import time

import numpy as np

from repro_torch.core import GzipIndex, ParallelGzipReader


def make_corpus():
    """The reference's corpus: 800 000 seeded words, two gzip members."""
    rng = np.random.default_rng(7)
    words = [b"lorem", b"ipsum", b"dolor", b"sit", b"amet", b"rapidgzip"]
    doc = b" ".join(words[i] for i in rng.integers(0, len(words), 800_000))
    compressed = gzip.compress(doc[: len(doc) // 2], 6) + gzip.compress(doc[len(doc) // 2 :], 9)
    return doc, compressed


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where stage 2 of every read runs")
    args = ap.parse_args()

    # -- make a multi-member gzip file -------------------------------------
    doc, compressed = make_corpus()
    print(f"corpus: {len(doc):,} bytes -> {len(compressed):,} compressed "
          f"(ratio {len(doc)/len(compressed):.2f}, 2 gzip members)")

    # -- 1. parallel decompression (speculative two-stage + prefetch) ------
    t0 = time.perf_counter()
    with ParallelGzipReader(compressed, parallelization=4, chunk_size=256 << 10,
                            device=args.device) as reader:
        out = reader.read()
        assert out == doc
        stats = reader.stats()["fetcher"]
        print(f"first pass: {time.perf_counter()-t0:.2f}s | speculative tasks: "
              f"{stats['nominal_tasks']}, exact: {stats['exact_tasks']}, "
              f"false positives absorbed: {stats['false_positive_starts']}, "
              f"marker chunks: {stats['chunks_with_markers']}")

        # -- 2. export the seek index (built on the fly) -------------------
        buf = io.BytesIO()
        reader.export_index(buf)
        print(f"seek index: {len(reader.index)} points, {len(buf.getvalue()):,} bytes")

    # -- 3. O(1) random access through the index ---------------------------
    index = GzipIndex.from_bytes(buf.getvalue())
    with ParallelGzipReader(compressed, parallelization=4, index=index,
                            device=args.device) as reader:
        t0 = time.perf_counter()
        reader.seek(700_000)
        sample = reader.read(64)
        dt = time.perf_counter() - t0
        assert sample == doc[700_000:700_064]
        print(f"random access at offset 700k: {dt*1e3:.1f} ms -> {sample[:32]!r}...")
        print(f"zlib delegations (index fast path): "
              f"{reader.stats()['fetcher']['zlib_delegations']}")


if __name__ == "__main__":
    main()
