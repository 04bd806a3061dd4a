"""The port stands alone: no jax, no flax, nothing of ``visuelle2_tpu``; no
pandas, and PIL only inside the functions that decode or write JPEGs (the
card's machine has neither); and its entry points never run on the CPU
unless asked."""

import ast
import os
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


def _module_level_imports(node, in_function=False):
    """(module, imported inside a function?) for every import under ``node``."""
    for child in ast.iter_child_nodes(node):
        inside = in_function or isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                                   ast.Lambda))
        if isinstance(child, ast.Import):
            yield from ((alias.name, inside) for alias in child.names)
        elif isinstance(child, ast.ImportFrom) and child.level == 0:
            yield child.module, inside
        yield from _module_level_imports(child, inside)


def test_port_sources_import_no_pandas_and_pil_only_in_functions():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    imports = {str(f.relative_to(ROOT)): list(_module_level_imports(
        ast.parse(f.read_text(), filename=str(f)))) for f in files}
    pandas = {f: m for f, found in imports.items() for m, _ in found
              if m.split(".")[0] == "pandas"}
    pil_top = {f: m for f, found in imports.items() for m, inside in found
               if m.split(".")[0] == "PIL" and not inside}
    assert not pandas and not pil_top, (pandas, pil_top)
    pil_users = sorted(f for f, found in imports.items()
                       if any(m.split(".")[0] == "PIL" for m, _ in found))
    assert pil_users == ["visuelle2_tpu_torch/data/images.py",
                         "visuelle2_tpu_torch/data/synthetic.py"], pil_users


def test_scoring_runs_where_pandas_and_pil_cannot_be_imported(tmp_path):
    """In a process where ``import pandas`` and ``import PIL`` fail, as on the
    card's machine: the CLIs import, a dataset is written without JPEGs, its
    image cache from numpy, and ``forecast_transformer`` scores it."""
    code = (
        "import importlib.machinery as mach, sys\n"
        "class Hidden(mach.PathFinder):  # pandas and PIL are not installed\n"
        "    @classmethod\n"
        "    def find_spec(cls, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('pandas', 'PIL'):\n"
        "            return None\n"
        "        return mach.PathFinder.find_spec(name, path, target)\n"
        "sys.meta_path = [Hidden if f is mach.PathFinder else f for f in sys.meta_path]\n"
        "for m in [m for m in sys.modules if m.split('.')[0] in ('pandas', 'PIL')]:\n"
        "    del sys.modules[m]\n"
        "import numpy as np\n"
        "import visuelle2_tpu_torch.cli.forecast_transformer as ft\n"
        "import visuelle2_tpu_torch.cli.forecast_dl\n"
        "from visuelle2_tpu_torch.data.images import ImageStore\n"
        "from visuelle2_tpu_torch.data.pipeline import load_visuelle2\n"
        "from visuelle2_tpu_torch.data.synthetic import make_synthetic_dataset\n"
        "try:\n"
        "    import pandas\n"
        "    raise SystemExit('pandas imported')\n"
        "except ImportError:\n"
        "    pass\n"
        "d = make_synthetic_dataset(sys.argv[1], num_train=4, num_test=12, image_size=32,\n"
        "                           write_images=False, rows_per_image=4)\n"
        "paths = load_visuelle2(d, 'test', demand=True, output_len=12).image_paths\n"
        "unique, row_to_img = ImageStore.unique_paths(paths)\n"
        "pixels = np.random.default_rng(0).integers(0, 256, (len(unique), 32, 32, 3), np.uint8)\n"
        "ImageStore(pixels, row_to_img).write_cache(ImageStore.cache_path(d, 'test', 32), paths)\n"
        "r = ft.main(['--dataset_path', d, '--model', 'gated_v4', '--device', 'cpu',\n"
        "             '--image_arch', 'tiny', '--image_size', '32', '--batch_size', '8',\n"
        "             '--embedding_dim', '16', '--hidden_dim', '16'])\n"
        "assert r.num_forecasts == 12 and np.isfinite(r.wape), r\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('pandas', 'PIL', 'jax'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    # One torch thread: the suite's other workers share the cores.
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "d")], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


@pytest.mark.parametrize("cli", ["forecast_transformer", "forecast_dl"])
def test_forecast_clis_need_cuda_unless_asked(cli, tmp_path):
    """``python -m visuelle2_tpu_torch.cli.<cli>`` raises without a card
    (``--device`` is ``cuda`` by default) and writes no file."""
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "import runpy\n"
            f"sys.argv = ['{cli}', '--metrics_out', 'm.json']\n"
            f"runpy.run_module('visuelle2_tpu_torch.cli.{cli}', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr, out.stderr[-2000:]
    assert list(tmp_path.iterdir()) == []


def test_train_cli_needs_cuda_unless_asked(tmp_path):
    """``python -m visuelle2_tpu_torch.cli.train_transformer`` raises without
    a card (``--device`` is ``cuda`` by default) and writes no file."""
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "import runpy\n"
            "sys.argv = ['train_transformer', '--ckpt_dir', 'ck']\n"
            "runpy.run_module('visuelle2_tpu_torch.cli.train_transformer', "
            "run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr, out.stderr[-2000:]
    assert list(tmp_path.iterdir()) == []


def test_train_dl_needs_cuda_unless_asked(tmp_path):
    """``python -m visuelle2_tpu_torch.cli.train_dl`` raises without a card
    (``--device`` is ``cuda`` by default) and writes no file."""
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "import runpy\n"
            "sys.argv = ['train_dl', '--demand', '1', '--ckpt_dir', 'ck']\n"
            "runpy.run_module('visuelle2_tpu_torch.cli.train_dl', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr, out.stderr[-2000:]
    assert list(tmp_path.iterdir()) == []


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
        "import visuelle2_tpu_torch.ops.cuda.probe_gemm, visuelle2_tpu_torch.ops.cuda.read_reduce\n"
        "import visuelle2_tpu_torch.perf.timing, visuelle2_tpu_torch.perf.roofline\n"
        "import visuelle2_tpu_torch.perf.convfloor, visuelle2_tpu_torch.perf.convfloor_v2\n"
        "import visuelle2_tpu_torch.perf.gemm_split, visuelle2_tpu_torch.perf.gru_split\n"
        "import visuelle2_tpu_torch.perf.additive_split, visuelle2_tpu_torch.perf.gated_split\n"
        "import visuelle2_tpu_torch.cli.forecast_transformer, visuelle2_tpu_torch.cli.forecast_dl\n"
        "import visuelle2_tpu_torch.data.synthetic, visuelle2_tpu_torch.eval.forecast\n"
        "import visuelle2_tpu_torch.cli.train_transformer, visuelle2_tpu_torch.ops.dropout\n"
        "import visuelle2_tpu_torch.cli.train_dl\n"
        "import visuelle2_tpu_torch.train.optim, visuelle2_tpu_torch.train.loop\n"
        "import visuelle2_tpu_torch.train.checkpoint, visuelle2_tpu_torch.train.hparams\n"
        "import visuelle2_tpu_torch.utils.tracing\n"
        "import visuelle2_tpu_torch.models.pretrained, visuelle2_tpu_torch.eval.client\n"
        "import visuelle2_tpu_torch.cli.export, visuelle2_tpu_torch.cli.serve\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(n for n in new if n.split('.')[0] in %r)\n"
        "assert 'jax' not in sys.modules and not bad, bad\n"
        "print('ok')\n" % (FORBIDDEN,))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_need_cuda_unless_asked(monkeypatch, tmp_path):
    from visuelle2_tpu_torch.eval.export import export_forecaster, load_forecaster, make_forecaster
    from visuelle2_tpu_torch.models import build

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build("gated_v4", image_arch="tiny", embedding_dim=16, hidden_dim=16)
    model = build("gated_v4", device="cpu", image_arch="tiny", embedding_dim=16,
                  hidden_dim=16)
    assert next(model.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_forecaster(model, {"ts": torch.zeros(2, 12).numpy()})
    path = str(tmp_path / "m.v2torch")
    export_forecaster(model, {"ts": torch.zeros(2, 12).numpy()}, path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_forecaster(path)


@pytest.mark.parametrize("cli,argv", [
    ("serve", ["--artifact", "m.v2torch"]),
    ("export", ["--model", "gated_v4", "--ckpt_path", "ck", "--out", "m.v2torch",
                "--vocab", "5,6,5"])])
def test_serve_and_export_clis_need_cuda_unless_asked(cli, argv, tmp_path):
    """``python -m visuelle2_tpu_torch.cli.serve`` / ``.export`` raise without
    a card (``--device`` is ``cuda`` by default) and write no file."""
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "import runpy\n"
            f"sys.argv = ['{cli}', *{argv!r}]\n"
            f"runpy.run_module('visuelle2_tpu_torch.cli.{cli}', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr, out.stderr[-2000:]
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("module", ["roofline", "convfloor_v2", "convfloor", "gemm_split",
                                    "gru_split", "gated_split"])
def test_harness_clis_need_cuda(module, tmp_path):
    """``python -m visuelle2_tpu_torch.perf.<module>`` raises without a card
    and, with no ``--out``, writes no file."""
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "import runpy\n"
            f"sys.argv = ['{module}']\n"
            f"runpy.run_module('visuelle2_tpu_torch.perf.{module}', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr, out.stderr[-2000:]
    assert list(tmp_path.iterdir()) == []
