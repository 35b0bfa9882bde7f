"""Build and load the hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, and loaded with ``ctypes``. No
PyTorch headers are included, so a build takes seconds, not minutes.

Libraries land in ``build/repro_torch_kernels/`` at the root of the
checkout. A library's file name carries a hash of its source and flags, so
an edited source is rebuilt on first use and a stale library is never
loaded. Builds happen at first use, never at import: a CPU-only host has no
``nvcc``. The hashing, the atomic build and the loading are
``repro_torch._native.LibrarySet``'s, shared with the host decoder
(``csrc/inflate.cpp``), which ``core`` builds through ``_native`` without
this package.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path
from typing import Iterable

import torch

from .. import _native
from .._native import CSRC, build_dir  # noqa: F401  (re-exported)

SOURCES = ("marker_replace", "crc32", "precode_check")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index: a card (``"cuda"``,
    where the kernels run; raises without one) or the host (``"cpu"``,
    where the plain versions run)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device=%r needs a CUDA device; pass device='cpu' to run the "
                               "plain versions" % str(device))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError("device must be 'cuda' or 'cpu', got %r" % str(device))
    return dev


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_CUDA = _native.LibrarySet(".cu", NVCC_FLAGS, nvcc)


def library_path(name: str) -> Path:
    return _CUDA.library_path(name)


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns the wall seconds spent (0 when all were built)."""
    return _CUDA.build(names)


def build_log(name: str) -> str:
    """What nvcc and ptxas printed for ``name`` (registers, shared memory)."""
    return _CUDA.build_log(name)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    return _CUDA.load(name)


def entry(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry ``symbol`` of ``csrc/<name>.cu``. Every pointer and the stream
    must be declared ``c_void_p``: ctypes would otherwise pass a 32-bit int
    and cut the pointer. Entries return ``cudaGetLastError()``."""
    return _CUDA.entry(name, symbol, argtypes)
