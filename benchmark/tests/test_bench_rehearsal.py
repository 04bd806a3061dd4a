"""Each cell's run end to end on the CPU at a tiny size (``rehearse.py``):
a well-formed last line, ``correct`` true; and with the timed path broken
underneath, ``correct`` false, once for each fault the cell can have."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
KINDS = {w["name"]: w["traffic"].split(".")[0] for w in SPEC["workloads"]}
# The faults a cell can have: an answer altered where it is produced
# (serving); a step that leaves its state unchanged, half of the batch left
# out with the mean over the rest, and an update applied with the wrong
# sign (training).  One card: no exchange.
FAULTS = {"serve": ["answer"], "train": ["state_unchanged", "half_batch", "update_sign"]}


def rehearse(cell, *extra):
    out = subprocess.run([sys.executable, "benchmark/tests/rehearse.py", "--workload", cell,
                          *extra], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    return line, out.stderr


def well_formed(line, metrics):
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        assert key in line["device"]
    assert set(line["metrics"]) <= set(metrics)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}, name


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell):
    line, err = rehearse(cell)
    e2e = [m["name"] for m in SPEC["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    well_formed(line, e2e)
    assert set(line["metrics"]) == set(e2e)
    assert line["correct"] is True, (line, err[-2000:])
    assert line["attempted"] > 0 and line["failed"] == 0
    # The compared numbers are standard error's last lines.
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_is_well_formed(cell):
    line, _ = rehearse(cell, "--trace", "1", "--seconds", "6")
    layer = [m["name"] for m in SPEC["per_layer"] if "workloads" not in m or cell in m["workloads"]]
    well_formed(line, layer)
    # On the CPU no device metric is written: only host counters and spans.
    for name in line["metrics"]:
        source = {m["name"]: m["source"] for m in SPEC["per_layer"]}[name]
        assert source != "device_trace", name


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS[KINDS[c]]])
def test_broken_timed_path_is_not_correct(cell, fault):
    line, err = rehearse(cell, "--fault", fault)
    assert line["correct"] is False, (line, err[-2000:])
