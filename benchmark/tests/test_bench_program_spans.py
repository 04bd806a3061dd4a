"""The readers of the program's own spans and counters (``spans.py`` and
the thirteen ``metrics/*.py`` that use it) on a recorder filled by hand:
medians in ms, decode steps summed by their forward, gaps on one thread,
the fill ratio, and nothing under ten records or without the recorder."""

import json
import types
from pathlib import Path

import pytest

from benchmark import core, spans
from visuelle2_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
MS = 1_000_000  # ns
# Each reader of a span's median and the span it reads.
MEDIANS = {
    "queue_wait_ms.serve": "batcher.queue", "batcher_pack_ms.serve": "batcher.pack",
    "fn_upload_ms.serve": "forecast.upload", "fn_forward_host_ms.serve": "forecast.forward",
    "fn_download_ms.serve": "forecast.download", "step_upload_ms.train": "train.upload",
    "step_forward_host_ms.train": "train.forward",
    "step_backward_host_ms.train": "train.backward",
    "optimizer_host_ms.train": "train.optimizer", "loader_batch_ms.train": "loader.batch",
}
READERS = sorted(MEDIANS) + ["dispatch_gap_ms.serve", "dispatch_fill.serve",
                             "decode_host_ms.serve"]


@pytest.fixture()
def rec(monkeypatch):
    r = tracing.Recorder()
    monkeypatch.setattr(spans, "recorder", lambda: r)
    return r


def read(name):
    return core.read_metric(name, None)


def test_thirteen_readers_with_their_entries():
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    assert len(READERS) == 13
    for name in READERS:
        m = entries[name]
        assert m["source"] == ("program_counter" if name == "dispatch_fill.serve"
                               else "program_span")
        assert m["workloads"] and all(w.split(".")[-2] == name.split(".")[-1]
                                      for w in m["workloads"]), name


@pytest.mark.parametrize("metric", sorted(MEDIANS))
def test_the_median_in_ms(rec, metric):
    name = MEDIANS[metric]
    for i in range(9):
        rec.add(name, 1000 * MS, 1000 * MS + (i + 1) * MS)
    rec.add("other", 0, 500 * MS)
    assert read(metric) is None  # nine records
    rec.add(name, 5 * MS, 105 * MS)
    assert read(metric) == pytest.approx(5.5)  # 1..9 and 100 ms


def test_decode_steps_summed_by_their_forward(rec):
    def fill(forwards):
        rec.reset()
        for f in range(forwards):  # forward f (span 1000 + f): 12 steps of f + 1 ms
            for s in range(12):
                rec._append(("decode.step", 12 * f + s + 1, 1000 + f, 1, 0, (f + 1) * MS, None))

    fill(10)
    assert read("decode_host_ms.serve") == pytest.approx(12 * 5.5)
    fill(9)
    assert read("decode_host_ms.serve") is None


def test_gaps_between_calls_on_one_thread(rec):
    t = 0
    for i in range(11):  # ten gaps of 1..10 ms on thread 1
        rec._append(("batcher.call", i + 1, 0, 1, t, t + 50 * MS, None))
        t += 50 * MS + (i + 1) * MS
    # Another thread's calls interleave and make no gap with these.
    rec._append(("batcher.call", 99, 0, 2, 3 * MS, 4 * MS, None))
    assert read("dispatch_gap_ms.serve") == pytest.approx(5.5)


def test_fill_from_the_row_counters(rec):
    for i in range(10):
        rec.add("batcher.call", 0, MS)
    rec.count("batcher.rows", 300)
    rec.count("batcher.padded_rows", 100)
    assert read("dispatch_fill.serve") == pytest.approx(75.0)
    rec.reset()
    for i in range(9):
        rec.add("batcher.call", 0, MS)
    rec.count("batcher.rows", 300)
    assert read("dispatch_fill.serve") is None


@pytest.mark.parametrize("metric", READERS)
def test_nothing_without_the_recorder(monkeypatch, metric):
    """A program whose tracing module has no recorder (``trace`` and
    ``annotate`` alone, as before the recorder) gives no reading and no
    error."""
    import visuelle2_tpu_torch.utils as utils

    monkeypatch.setattr(utils, "tracing", types.SimpleNamespace(trace=None, annotate=None))
    assert spans.recorder() is None
    assert read(metric) is None


def test_the_process_recorder_is_found_and_left_as_it_is():
    tracing.reset()
    try:
        for i in range(10):
            with tracing.span("loader.batch"):
                pass
        held = tracing.records()
        assert read("loader_batch_ms.train") is not None
        assert tracing.records() == held
    finally:
        tracing.reset()
