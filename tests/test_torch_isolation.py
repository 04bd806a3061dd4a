"""The port stands alone: no jax, no flax, nothing of ``visuelle2_tpu``; and
its entry points never run on the CPU unless asked."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "visuelle2_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "visuelle2_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module):
    top = module.split(".")[0]
    return top in FORBIDDEN  # "visuelle2_tpu_torch" is its own top-level name


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = {str(f.relative_to(ROOT)): m for f in files
           for m in _imported_modules(f) if _forbidden(m)}
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import visuelle2_tpu_torch, visuelle2_tpu_torch.convert\n"
        "import visuelle2_tpu_torch.models, visuelle2_tpu_torch.eval.export\n"
        "import visuelle2_tpu_torch.eval.server\n"
        "from visuelle2_tpu_torch.models import build\n"
        "for name in ('gated_v4', 'gated_v2', 'gtm', 'm4ft', 'gated_v1', 'gated_v3',\n"
        "             'cross_attn_rnn_21', 'cross_attn_rnn_210', 'cross_attn_rnn_demand'):\n"
        "    build(name, device='cpu', image_arch='tiny', embedding_dim=16,"
        " hidden_dim=16, **({'attention_dim': 16} if 'cross' in name else {}))\n"
        "import visuelle2_tpu_torch.ops.cuda.gru_seq\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(n for n in new if n.split('.')[0] in %r)\n"
        "assert 'jax' not in sys.modules and not bad, bad\n"
        "print('ok')\n" % (FORBIDDEN,))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_need_cuda_unless_asked(monkeypatch):
    from visuelle2_tpu_torch.eval.export import make_forecaster
    from visuelle2_tpu_torch.models import build

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build("gated_v4", image_arch="tiny", embedding_dim=16, hidden_dim=16)
    model = build("gated_v4", device="cpu", image_arch="tiny", embedding_dim=16,
                  hidden_dim=16)
    assert next(model.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_forecaster(model, {"ts": torch.zeros(2, 12).numpy()})
