"""Build and load the port's compiled libraries; imports no torch.

A ``LibrarySet`` compiles the sources of ``kernels/csrc/`` with one suffix
by one compiler, each into its own shared library with a plain C interface,
loaded with ``ctypes.CDLL`` (whose calls release the GIL). Libraries land in
``build/repro_torch_kernels/`` at the root of the checkout, under a file name
that carries a hash of the source and flags, so an edited source is rebuilt
on first use and a stale library is never loaded. A build writes a temporary
file and renames it into place, so a reader never sees half a library.
Builds happen at first use, never at import.

``HOST`` is the set of host C++ sources (``inflate.cpp``: stage 1's deflate
decoder), built by ``$CXX``, else ``g++``, which the CPU-only hosts have as
well as every host with ``nvcc``. ``core`` reaches it from here and never
imports ``kernels``; ``kernels/_build.py`` builds the CUDA sources with the
same ``LibrarySet``.
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
from typing import Callable, Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "kernels" / "csrc"
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")


def build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "repro_torch_kernels"


def cxx() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++``, else ``c++``."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no host C++ compiler ($CXX, g++ or c++) found: the stage-1 "
                       "decoder (csrc/inflate.cpp) cannot be built")


class LibrarySet:
    """The libraries built from ``CSRC/<name><suffix>`` by ``compiler()``
    with ``flags``."""

    def __init__(self, suffix: str, flags: Tuple[str, ...], compiler: Callable[[], str]):
        self.suffix = suffix
        self.flags = flags
        self.compiler = compiler
        self._lock = threading.Lock()
        self._libs: Dict[str, ctypes.CDLL] = {}
        self._entries: Dict[tuple, ctypes._CFuncPtr] = {}

    def source_path(self, name: str) -> Path:
        return CSRC / f"{name}{self.suffix}"

    def library_path(self, name: str) -> Path:
        src = self.source_path(name).read_bytes()
        digest = hashlib.sha256(src + " ".join(self.flags).encode()).hexdigest()[:16]
        return build_dir() / f"lib{name}_{digest}.so"

    def build(self, names: Iterable[str]) -> float:
        """Compile every missing library, one compiler process per source,
        all started together. Returns the wall seconds spent (0 when all
        were built)."""
        t0 = time.perf_counter()
        with self._lock:
            todo = [n for n in names if not self.library_path(n).exists()]
            if not todo:
                return 0.0
            compiler = self.compiler()
            build_dir().mkdir(parents=True, exist_ok=True)
            procs = []
            for name in todo:
                out = self.library_path(name)
                tmp = out.with_suffix(".so.tmp%d" % os.getpid())
                with open(out.with_suffix(".log"), "w") as log:
                    cmd = [compiler, *self.flags, "-o", str(tmp), str(self.source_path(name))]
                    procs.append((name, out, tmp, subprocess.Popen(
                        cmd, stdout=log, stderr=subprocess.STDOUT
                    )))
            failed = []
            for name, out, tmp, proc in procs:
                if proc.wait() == 0:
                    os.replace(tmp, out)  # atomic: a reader never sees half a file
                else:
                    failed.append(f"{os.path.basename(compiler)} failed for "
                                  f"{self.source_path(name).name}:\n{self.build_log(name)}")
            if failed:
                raise RuntimeError("\n".join(failed))
        return time.perf_counter() - t0

    def build_log(self, name: str) -> str:
        """What the compiler printed for ``name`` (for ``nvcc``, ptxas's
        registers and shared memory too)."""
        path = self.library_path(name).with_suffix(".log")
        return path.read_text() if path.exists() else ""

    def load(self, name: str) -> ctypes.CDLL:
        """The loaded library for ``name``, built on first use."""
        lib = self._libs.get(name)
        if lib is None:
            self.build([name])
            with self._lock:
                lib = self._libs.get(name)
                if lib is None:
                    lib = ctypes.CDLL(str(self.library_path(name)))
                    self._libs[name] = lib
        return lib

    def entry(self, name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
        """C entry ``symbol`` of library ``name``, returning an ``int``.
        Every pointer must be declared ``c_void_p``: ctypes would otherwise
        pass a 32-bit int and cut the pointer."""
        fn = self._entries.get((name, symbol))
        if fn is None:
            fn = getattr(self.load(name), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self._entries[name, symbol] = fn
        return fn


#: The host C++ sources.
HOST_SOURCES = ("inflate",)
HOST = LibrarySet(".cpp", CXX_FLAGS, cxx)
