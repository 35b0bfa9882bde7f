"""repro_torch stands alone: it imports neither jax nor the JAX package.

One subprocess blocks both and imports every module of the port; a static
pass checks every import statement of the port and of ``chip_smoke.py``.
The host modules the port copied must stay byte-identical to the reference
(their imports are all relative), so a fix in one is seen in both.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"

PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))

# Copies whose every line, imports included, equals the reference's.
VERBATIM = [
    "core/bitreader.py", "core/block_finder.py", "core/cache.py",
    "core/chunk_fetcher.py", "core/codec.py", "core/crc32.py",
    "core/deflate.py", "core/errors.py", "core/filereader.py",
    "core/gzip_format.py", "core/huffman.py", "core/index.py",
    "core/markers.py", "core/prefetch.py", "core/remote.py", "core/synth.py",
    "core/zlib_bridge.py", "obs/hist.py", "obs/prom.py", "obs/sanitize.py",
    "obs/trace.py", "service/async_server.py", "service/cache_pool.py",
    "service/index_store.py", "service/metrics.py", "service/scheduler.py",
    "service/gateway/__init__.py", "service/gateway/admission.py",
    "service/gateway/client.py", "service/gateway/server.py",
]


def test_every_module_imports_with_jax_and_repro_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m, mod in sys.modules.items()\n"
        "       if mod is not None and m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= len(PORT_FILES) - 5


def _absolute_imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("rel", PORT_FILES + ["chip_smoke.py"])
def test_no_import_of_jax_or_repro(rel):
    for mod in _absolute_imports(ROOT / rel):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), "%s imports %s" % (rel, mod)


@pytest.mark.parametrize("rel", VERBATIM)
def test_host_copy_matches_reference(rel):
    assert (PORT / rel).read_bytes() == (REF / rel).read_bytes()


def test_kernel_sources_are_in_the_package():
    from repro_torch.kernels import _build

    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert _build.library_path("crc32").parent == _build.build_dir()
