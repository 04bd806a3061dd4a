"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level names; the reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
PORT = "visuelle2_tpu_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    for name in _imports(path):
        assert name.split(".")[0] not in (PORT, "jax", "jaxlib", "flax", "optax",
                                          "visuelle2_tpu"), name


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_file_imports_jax(path):
    for name in _imports(path):
        assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "optax", "visuelle2_tpu")


def test_whole_names_are_compared():
    from benchmark import core

    assert core.forbidden_modules(["visuelle2_tpu_torch", "visuelle2_tpu_torch.models",
                                   "jaxtyping", "flaxen"]) == []
    assert core.forbidden_modules(["visuelle2_tpu.models", "jax._src", "optax"]) == [
        "jax", "optax", "visuelle2_tpu"]


def test_a_run_loads_no_jax():
    """A whole serving run on the CPU, then the process's modules."""
    code = ("import runpy, sys; sys.argv = ['rehearse', '--workload', 'gated_v4.serve.mixed',"
            " '--seconds', '1'];\n"
            "try:\n    runpy.run_path('benchmark/tests/rehearse.py', run_name='__main__')\n"
            "except SystemExit as e:\n    assert not e.code, e.code\n"
            "found = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'optax', 'visuelle2_tpu'})\n"
            "print('LOADED', found, 'visuelle2_tpu_torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED [] True" in out.stdout, out.stdout[-2000:]
