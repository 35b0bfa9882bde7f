"""rapidgzip on PyTorch and CUDA: parallel decompression and seeking in gzip
files, with stage 2 (marker replacement and CRC32) on an NVIDIA Hopper card.

Layout mirrors the JAX package ``repro`` module for module:

  * ``core`` — the host stack (block finder, two-stage deflate decoder, seek
    index, chunk fetcher, ``ParallelGzipReader``), copied so that only the
    import lines differ from the reference;
  * ``obs`` — spans, histograms and Prometheus text used by ``core`` and
    ``service``;
  * ``kernels`` — hand-written CUDA C++ kernels for ``sm_90a`` behind
    ``TorchDecodeEngine``, each with its plain PyTorch version;
  * ``service`` — the archive service (``ArchiveServer``, its async facade
    and the HTTP gateway), whose readers share one server-owned engine.

Nothing here imports ``jax`` or ``repro``. Entry points run stage 2 on the
card unless the caller passes ``device="cpu"``.
"""
