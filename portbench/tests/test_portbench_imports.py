"""The import rule: nothing under portbench/ imports JAX, the JAX package
or its benchmarks, by top-level name compared whole; the references import
nothing of the program either."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


MODULES = sorted(PB.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(PB)))
def test_no_forbidden_import(path):
    found = top_level_imports(path)
    assert not found & FORBIDDEN, found & FORBIDDEN
    if "reference" in path.parts:
        assert "repro_torch" not in found and "portbench" not in found


def test_comparison_is_by_whole_name():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.core".split(".")[0] in FORBIDDEN


def test_run_refuses_a_loaded_jax():
    from portbench import run

    assert run.forbidden_loaded(["jax.numpy", "repro_torch.core", "os"]) == ["jax"]
    assert run.forbidden_loaded(["repro.core", "benchmarks.run"]) == ["benchmarks", "repro"]
    assert run.forbidden_loaded(["repro_torch", "portbench.run"]) == []


def test_run_without_a_card_prints_no_result(tmp_path):
    root = PB.parent
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "read.b64-gzip",
                           "--seed", "4000000007", "--seconds", "1", "--trace", "0"],
                          cwd=root, capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                               "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_without_the_program_prints_no_result(tmp_path):
    import shutil

    shutil.copytree(PB, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(PB.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "read.b64-gzip",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
