"""What every cell shares: finding a cell's files by name, the environment
a run sets before it loads the port, the device record, the result line
and the look for JAX in the finished process.

A cell's files, all found from the names in ``BENCHMARK.json``:

* ``configs/<config>.json`` (named by the configuration's ``file``): the
  sizes as run, the port's registry name and build arguments, the
  precisions (the reference's and the control's, files of
  ``reference/precisions/``), the vocabulary, the training settings, the
  weight rules and any preparation steps (``prepare/<step>.py``);
* ``reference/families/<registry>.py``: the model family's plain forward
  and its work outside the backbone, found by the registry name;
* ``yardstick/backbones/<image_arch>_<image_size>.json``: the backbone's
  convolutions;
* ``traffic/<traffic>.json``: the traffic's parameters and the ``driver``
  (``drivers/<driver>.py``) that generates it;
* ``workloads/<cell>.json``: the cell's correctness limits;
* ``metrics/<metric>.py``: one reader a per-layer metric (``read(ctx)``).
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "visuelle2_tpu")
# Build and kernel caches at fixed paths inside the checkout, so that only
# a checkout's first run builds (the port's own CUDA library already goes
# to build/visuelle2_tpu_torch/).
CACHE_DIRS = {
    "TRITON_CACHE_DIR": "build/benchmark/triton",
    "TORCHINDUCTOR_CACHE_DIR": "build/benchmark/inductor",
    "TORCH_EXTENSIONS_DIR": "build/benchmark/torch_extensions",
    "CUDA_CACHE_PATH": "build/benchmark/nv_compute_cache",
}


def set_environment() -> None:
    """Before torch is imported: the caches inside the checkout, and no
    library loading JAX on its own."""
    for key, rel in CACHE_DIRS.items():
        path = ROOT / rel
        path.mkdir(parents=True, exist_ok=True)
        os.environ[key] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_spec(name: str, spec: Optional[dict] = None) -> dict:
    """Everything a cell runs by: its ``BENCHMARK.json`` entry, its
    configuration, traffic and limits, and the metrics it reports."""
    spec = spec or benchmark_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    cell = cells[name]
    config_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = load_json(ROOT / config_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "workloads" / f"{name}.json")
    return {
        "name": name, "chips": cell["chips"], "config_name": cell["config"],
        "config": config, "traffic": traffic, "limits": limits["limits"],
        "end_to_end": [m for m in spec["end_to_end"] if _reports(m, name)],
        "per_layer": [m for m in spec["per_layer"] if _reports(m, name)],
    }


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_driver(name: str):
    return load_file(HERE / "drivers" / f"{name}.py", f"benchmark_driver_{name}")


def read_metric(name: str, ctx) -> Optional[float]:
    """A per-layer metric's reader, ``metrics/<name>.py``; None when it
    finds nothing to read."""
    mod = load_file(HERE / "metrics" / f"{name}.py",
                    "benchmark_metric_" + name.replace(".", "_"))
    return mod.read(ctx)


def load_file(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(names=None) -> list:
    """Top-level names among ``names`` (``sys.modules`` by default) equal to
    a JAX package's, compared whole (``visuelle2_tpu_torch`` is not
    ``visuelle2_tpu``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def device_record(torch, count: int) -> dict:
    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
           "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                        for i in range(count)))}
    limit = power_limit()
    if limit is not None:
        rec["power_limit_w"] = limit
    return rec


def power_limit() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def quantile(values, q: float) -> float:
    """The ``q`` quantile of ``values`` by linear interpolation."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = q * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def metric(value: float, unit: str) -> dict:
    return {"value": float(value), "unit": unit}


def emit(result: dict, checks: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output, ``checks`` its last key."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    line = dict(result)
    line["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
