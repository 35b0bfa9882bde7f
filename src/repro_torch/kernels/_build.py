"""Build and load the hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, and loaded with ``ctypes``. No
PyTorch headers are included, so a build takes seconds, not minutes.

Libraries land in ``build/repro_torch_kernels/`` at the root of the
checkout. A library's file name carries a hash of its source and flags, so
an edited source is rebuilt on first use and a stale library is never
loaded. Builds happen at first use, never at import: a CPU-only host has no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("marker_replace", "crc32", "precode_check")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[tuple, ctypes._CFuncPtr] = {}


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


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}_{digest}.so"


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns the wall seconds spent (0 when all were built)."""
    t0 = time.perf_counter()
    with _lock:
        todo = [n for n in names if not library_path(n).exists()]
        if not todo:
            return 0.0
        compiler = nvcc()
        build_dir().mkdir(parents=True, exist_ok=True)
        procs = []
        for name in todo:
            out = library_path(name)
            tmp = out.with_suffix(".so.tmp%d" % os.getpid())
            with open(out.with_suffix(".log"), "w") as log:
                cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
                procs.append((name, out, tmp, subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT
                )))
        failed = []
        for name, out, tmp, proc in procs:
            if proc.wait() == 0:
                os.replace(tmp, out)  # atomic: a reader never sees half a file
            else:
                failed.append(f"nvcc failed for {name}.cu:\n{build_log(name)}")
        if failed:
            raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """What nvcc and ptxas printed for ``name`` (registers, shared memory)."""
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                _libs[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry ``symbol`` of ``csrc/<name>.cu``. Every pointer and the stream
    must be declared ``c_void_p``: ctypes would otherwise pass a 32-bit int
    and cut the pointer. Entries return ``cudaGetLastError()``."""
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name, symbol] = fn
    return fn
