"""Kernels for Hopper, written by hand in CUDA C++.

Each kernel ships three layers:
  * ``csrc/<name>.cu`` — the kernel for ``sm_90a`` with a plain C entry,
    compiled by ``nvcc`` at first use (``_build.py``) and bound with ctypes;
  * ``<name>.py`` — the wrapper (checks, output allocation, launch counter)
    and the plain PyTorch version, which runs for CPU tensors;
  * ``ref.py`` — the constant tables.

``engine.TorchDecodeEngine`` batches the reader's stage-2 requests onto them;
``ops`` is the per-call API (``crc32_parallel``, ``precode_candidates``,
``marker_replace``). Unlike ``repro.kernels``, the package does not
re-export ``ops.marker_replace``: the name stays the module
``kernels/marker_replace.py``, so callers use
``repro_torch.kernels.ops.marker_replace``. Nothing here builds or loads a
kernel at import time.
"""

from .engine import EngineClosedError, TorchDecodeEngine, shared_engine
from .ops import crc32_parallel, precode_candidates

__all__ = [
    "EngineClosedError",
    "TorchDecodeEngine",
    "crc32_parallel",
    "precode_candidates",
    "shared_engine",
]
