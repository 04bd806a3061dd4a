"""The control: the reference one precision below the configuration's
(``reference/precisions/fp8_tf32.py``: float8 where the model rounds to
bfloat16, TF32 heads) put in the program's place.

On the CPU at a tiny size the control's reading of a cell's first number
sits well above the program's.  On the card (marked ``cuda``) the control
at the cell's own size fails the cell's limits on three seeds, through
``control.py``, which records the readings the limits were set from."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
# The number a cell's control reads farthest above the program at the tiny
# size.  Training's is the first gradient: past warm-up a step moves the
# parameters a hundredth of their RMS, so steps 2-3's losses carry the first
# update's bfloat16 sign flips at the tiny size too.
FIRST = {"serve": "forecast_rms_gap", "train": "grad_gap"}


def _readings(stderr: str, prefix: str) -> dict:
    line = [ln for ln in stderr.splitlines() if ln.startswith(prefix)][-1]
    return {k: float(v) for k, v in (kv.split("=") for kv in line.split()[1:])}


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program_on_cpu(cell):
    out = subprocess.run([sys.executable, "benchmark/tests/rehearse.py", "--workload", cell,
                          "--control", "1"], cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    number = FIRST[cell.split(".")[1]]
    control = _readings(out.stderr, "control ")[number]
    assert control >= 3 * line["checks"][number]["value"], (control, line["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits_on_the_card(cell, tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is read at the cell's own size")
    out_file = tmp_path / "control.json"
    out = subprocess.run([sys.executable, "benchmark/control.py", "--workload", cell,
                          "--seeds", "3", "--control-seeds", "3", "--fault-seeds", "0",
                          "--out", str(out_file)], cwd=ROOT, capture_output=True, text=True,
                         timeout=3000)
    assert out.returncode == 0, out.stderr[-3000:]
    limits = json.loads((ROOT / "benchmark" / "workloads" / f"{cell}.json").read_text())["limits"]
    runs = json.loads(out_file.read_text())["runs"]
    for r in runs:
        assert all(r["readings"][k] <= v for k, v in limits.items()), r
        assert any(r["control"][k] > v for k, v in limits.items()), r
