"""The port's examples on the CPU, against the reference's.

``examples/quickstart_torch.py``, ``serve_gateway_torch.py`` and
``serve_fleet_torch.py`` each run with ``--device cpu`` in a subprocess and
exit 0, so their asserts hold: the bytes read back (the whole corpus, a
seek through the index, a stream finished on the failover peer) equal the
corpus. Each makes the reference example's corpus (its sizes and seeds),
and what depends on the data alone prints as the reference's does. Without
a card, the default ``--device cuda`` raises.

Measured on this repository's 8-core CPU host, one test at a time: the
quickstart pair about 10 s (port and reference side by side), the gateway
about 6 s, the fleet about 45 s (its 8.4 MB archive through the
pure-Python stage 1).
"""

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ["quickstart", "serve_gateway", "serve_fleet"]


def start(name, tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path),
               JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, str(ROOT / "examples" / (name + ".py")), *args],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=str(tmp_path))


def finish(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    return proc.returncode, out, err


def load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / (name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def data_lines(name, out):
    """The lines of ``out`` that depend on the corpus alone (no timings,
    ports, paths or ETags)."""
    if name == "quickstart":
        keep = [line for line in out.splitlines()
                if line.startswith(("corpus:", "seek index:"))]
        keep += [line.split("->", 1)[1] for line in out.splitlines()
                 if line.startswith("random access")]
        return keep
    if name == "serve_gateway":
        return [line for line in out.splitlines() if line.startswith(
            ("pread(", "chunked full stream", "gateway-backed dataset batch"))]
    return [re.sub(r"http://\S+", "PEER", line) for line in out.splitlines()
            if "bit-identical" in line or "membership:" in line or "index_was_warm" in line]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(name, tmp_path):
    proc = start(name + "_torch", tmp_path, "--device", "cpu")
    ref = start(name, tmp_path) if name == "quickstart" else None
    rc, out, err = finish(proc)
    assert rc == 0, err[-4000:]
    lines = data_lines(name, out)
    assert lines, out
    if ref is not None:  # the reference's run beside it: the same corpus, index and seek
        rc_ref, out_ref, err_ref = finish(ref)
        assert rc_ref == 0, err_ref[-4000:]
        assert lines == data_lines(name, out_ref)
    if name == "serve_gateway":
        assert "chunked full stream -> 524288 bytes" in out
        assert "fallbacks replace=0 crc=0" in out
    if name == "serve_fleet":
        assert "bit-identical (failovers=1, resumed=1)" in out
        assert "index_was_warm=True, speculative tasks=0 (index fetched from a peer: 1 hit)" \
            in out
        assert "membership: 2/3 peers alive" in out


@pytest.mark.parametrize("name", ["serve_gateway", "serve_fleet"])
def test_example_makes_the_reference_corpus(name, tmp_path):
    import gzip

    port, ref = load(name + "_torch"), load(name)
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    got, want = port.make_corpus(str(tmp_path / "port")), ref.make_corpus(str(tmp_path / "ref"))
    if name == "serve_gateway":
        got = [gzip.decompress(Path(p).read_bytes()) for p in got]
        want = [gzip.decompress(Path(p).read_bytes()) for p in want]
        assert [len(d) for d in got] == [512 << 10] * 2
    else:
        assert sorted(got) == sorted(want) == ["big", "small-0", "small-1"]
        for key in got:
            assert gzip.decompress(Path(got[key][0]).read_bytes()) == got[key][1]
        got = {k: v[1] for k, v in got.items()}
        want = {k: v[1] for k, v in want.items()}
    assert got == want


def test_quickstart_makes_the_reference_corpus():
    doc, compressed = load("quickstart_torch").make_corpus()
    import gzip

    assert gzip.decompress(compressed) == doc and len(doc) == 4_930_377


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_needs_a_card_by_default(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    rc, out, err = finish(start(name + "_torch", tmp_path), timeout=300)
    assert rc != 0 and "needs a CUDA device" in err, (rc, err[-2000:])
