"""Nothing the benchmark runs imports JAX, the JAX package, bench.py,
chip_smoke.py or tools/; the reference imports nothing of the program.
Module names are compared by their whole top-level name: garden_tpu_torch
begins with garden_tpu."""

import ast
import subprocess
import sys

import pytest

from benchmark import harness

NEVER = {"jax", "jaxlib", "flax", "garden_tpu", "bench", "chip_smoke", "tools"}
FILES = sorted(p for p in harness.BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_names(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_no_forbidden_import(path):
    names = top_names(path)
    assert not names & NEVER, names & NEVER
    if "reference" in path.relative_to(harness.BENCH).parts:
        assert "garden_tpu_torch" not in names


def test_a_run_loads_no_jax_module():
    code = ("import sys; sys.path.insert(0, '.');"
            "from benchmark import harness;"
            "import benchmark.entries.combined_step, benchmark.entries.physics_tick,"
            " benchmark.entries.world_batch, garden_tpu_torch.entry,"
            " garden_tpu_torch.parallel.worlds;"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "garden_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxlibrary", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax.numpy"]
