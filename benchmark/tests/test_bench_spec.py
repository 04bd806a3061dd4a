"""BENCHMARK.json against the benchmark's contract, and every name it gives
found as a file of its own."""

import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT_MAX = 200
# A full check: 2 + 14 runs a cell, each run_seconds + 60 s, 2 x 90 s of
# compile a cell, 1,200 s spare, within 43,200 s at the 24 cells allowed.
MAX_CELLS, BUDGET_S = 24, 43200


def _names():
    out = [c["name"] for c in SPEC["configs"]]
    for w in SPEC["workloads"]:
        out += [w["name"], w["config"], w["traffic"]]
    out += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    out += [k for c in SPEC["configs"] for k in c["reduced"]]
    return out


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_name_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert 0 < len(metric["layer"]) <= TEXT_MAX and "\n" not in metric["layer"]
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert (HERE / "metrics" / f"{metric['name']}.py").is_file()


def test_unique_names_and_keys():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert "setup_s" in metrics
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        cell = w["name"]
        reports = {n for n, m in e2e.items() if "workloads" not in m or cell in m["workloads"]}
        assert "setup_s" in reports and len(reports) >= 2, cell
        layer = [m for m in SPEC["per_layer"] if "workloads" not in m or cell in m["workloads"]]
        assert layer, cell
        for m in layer:
            assert m["moves"] in reports, (cell, m["name"])


def test_cells_find_their_files():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert 0 < len(c["source"]) <= TEXT_MAX and 0 < len(c["why"]) <= TEXT_MAX
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"]
    pairs = set()
    for w in SPEC["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert 0 < len(w["why"]) <= TEXT_MAX
        traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert (HERE / "drivers" / f"{traffic['driver']}.py").is_file()
        assert (HERE / "workloads" / f"{w['name']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(SPEC["workloads"])
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == set(configs)


def test_command_and_window():
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    r = SPEC["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    assert MAX_CELLS * (14 * (r + 60) + 2 * 90) + 2 * (r + 60) + 1200 <= BUDGET_S


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_a_configuration_finds_its_files_by_name(entry):
    """The reference family, the precisions, the backbone's table and the
    preparation steps are files named from the configuration: a new
    configuration adds files and edits none."""
    body = json.loads((ROOT / entry["file"]).read_text())
    family = HERE / "reference" / "families" / f"{body['model']['registry']}.py"
    assert family.is_file()
    for name in body["precision"].values():
        assert (HERE / "reference" / "precisions" / f"{name}.py").is_file()
    arch = body["model"]["image_arch"]
    assert (HERE / "yardstick" / "backbones" / f"{arch}_{body['image_size']}.json").is_file()
    for step in body.get("prepare", []):
        assert (HERE / "prepare" / f"{step['step']}.py").is_file()


def test_preparation_steps_run_in_order(tmp_path, monkeypatch):
    from benchmark import program

    for name in ("first", "second"):
        (tmp_path / f"{name}.py").write_text(
            "def apply(model, step, ctx):\n"
            f"    ctx.setdefault('ran', []).append(('{name}', step['arg']))\n"
            f"    return model + ['{name}']\n")
    monkeypatch.setattr(program, "PREPARE", tmp_path)
    ctx = {}
    config = {"prepare": [{"step": "first", "arg": 1}, {"step": "second", "arg": 2}]}
    assert program.prepare([], config, ctx) == ["first", "second"]
    assert ctx["ran"] == [("first", 1), ("second", 2)]
    assert program.prepare(["m"], {}, {}) == ["m"]
