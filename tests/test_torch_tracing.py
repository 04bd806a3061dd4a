"""The port's spans and counters (``visuelle2_tpu_torch/utils/tracing.py``) on
the CPU at tiny sizes: the recorder (nesting, parents and stacks a thread,
the ring's bound, recording off), each span once a boundary in the batcher,
the served call, the decode loop, the train step and the loader; spans
invisible to ``torch.profiler``; and the ``trace`` export on the
profiler's clock.  The same device operations with recording on and off on
the card: ``tests/test_torch_cuda.py``.
"""

import collections
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from visuelle2_tpu_torch.data.images import ImageStore
from visuelle2_tpu_torch.data.loader import BatchLoader
from visuelle2_tpu_torch.data.pipeline import Visuelle2Arrays
from visuelle2_tpu_torch.eval.export import make_forecaster
from visuelle2_tpu_torch.eval.server import MicroBatcher
from visuelle2_tpu_torch.models import VocabSizes, build
from visuelle2_tpu_torch.train.loop import TrainConfig, Trainer
from visuelle2_tpu_torch.utils import tracing

OUT_LEN = 12
PORT_PREFIXES = ("batcher.", "forecast.", "decode.", "train.", "loader.")
TRAIN_PHASES = ("train.upload", "train.forward", "train.backward", "train.optimizer")


@pytest.fixture(autouse=True)
def _fresh_recorder():
    tracing.enable(True)
    tracing.reset()
    yield
    tracing.enable(True)
    tracing.reset()


def _demand(seed=0):
    torch.manual_seed(seed)
    return build("cross_attn_rnn_demand", device="cpu", image_arch="tiny",
                 vocab=VocabSizes(5, 6, 5, 126), attention_dim=16, embedding_dim=16,
                 hidden_dim=16, generator=torch.Generator().manual_seed(seed))


def _rows(n, seed=3, size=32):
    rng = np.random.default_rng(seed)
    return {
        "ts": rng.random((n, OUT_LEN)).astype(np.float32),
        "cat": rng.integers(0, 5, n).astype(np.int32),
        "col": rng.integers(0, 6, n).astype(np.int32),
        "fab": rng.integers(0, 5, n).astype(np.int32),
        "store": rng.integers(0, 126, n).astype(np.int32),
        "temporal": rng.random((n, 4)).astype(np.float32),
        "gtrends": rng.random((n, 3, 52)).astype(np.float32),
        "images": rng.integers(0, 255, (n, size, size, 3)).astype(np.uint8),
        "mask": np.ones(n, np.float32),
    }


def _tensors(rows):
    return {k: torch.from_numpy(v) for k, v in rows.items()}


def _loader(n=24, batch=8, native_prefetch=False):
    r = _rows(n, seed=5)
    arrays = Visuelle2Arrays(demand=True, output_len=OUT_LEN, cat=r["cat"], col=r["col"],
                             fab=r["fab"], store=r["store"], temporal=r["temporal"],
                             gtrends=r["gtrends"], image_paths=np.zeros(n, object), ts=r["ts"])
    return BatchLoader(arrays, ImageStore(r["images"]), batch, shuffle=True, seed=0,
                       drop_remainder=True, native_prefetch=native_prefetch)


def _within(child, parent):
    return parent[4] <= child[4] <= child[5] <= parent[5]


# ------------------------------------------------------------ the recorder

def test_nesting_parents_and_a_stack_per_thread():
    rec = tracing.Recorder()
    together = threading.Barrier(16, timeout=60)  # all 16 alive: 16 thread ids

    def work():
        together.wait()
        for _ in range(40):
            with rec.span("outer"):
                with rec.span("inner"):
                    pass
                with rec.span("inner"):
                    with rec.span("leaf"):
                        pass
        together.wait()

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    recs = rec.records()
    by_id = {r[1]: r for r in recs}
    assert len(recs) == len(by_id) == 16 * 40 * 4 and rec.overwritten == 0
    assert len({r[3] for r in recs}) == 16
    parent_of = {"inner": "outer", "leaf": "inner"}
    for name, _, parent, tid, t0, t1, tags in recs:
        assert t0 <= t1 and tags is None
        if name == "outer":
            assert parent == 0
        else:
            p = by_id[parent]
            assert p[0] == parent_of[name] and p[3] == tid and p[4] <= t0 and t1 <= p[5]


def test_the_ring_keeps_the_newest_and_counts_what_it_dropped():
    rec = tracing.Recorder(capacity=8)
    for i in range(20):
        rec.add("s", i, i + 1, i=i)
    assert [r[6]["i"] for r in rec.records()] == list(range(12, 20))
    assert rec.overwritten == 12
    rec.reset()
    assert rec.records() == [] and rec.overwritten == 0 and rec.counters() == {}


def test_recording_off_records_nothing():
    tracing.enable(False)
    assert tracing.span("a") is tracing.span("b")  # one shared no-op
    with tracing.span("a"):
        with tracing.span("b"):
            pass
    tracing.add("q", 0, 1, call=3)
    tracing.count("c", 3)
    assert tracing.records() == [] and tracing.counters() == {}
    tracing.enable(True)
    with tracing.span("a"):
        pass
    assert [r[0] for r in tracing.records()] == ["a"]


def test_added_spans_counters_and_the_epoch_clock():
    t = tracing.now()
    tracing.add("q", t, t + 5, call=7)
    (rec,) = tracing.records("q")
    assert rec[0] == "q" and rec[2] == 0 and rec[3] == threading.get_ident()
    assert rec[4:] == (t, t + 5, {"call": 7})
    tracing.count("c")
    tracing.count("c", 4)
    assert tracing.counters() == {"c": 5}
    assert abs(tracing.to_epoch_ns(time.perf_counter_ns()) - time.time_ns()) < 5_000_000


# ------------------------------------------------------ spans at boundaries

def test_batcher_queue_pack_call_and_rows():
    B = 8

    def fn(batch):
        time.sleep(0.002)
        return batch["ts"] * 2.0

    batcher = MicroBatcher(fn, ["mask", "ts"], {"mask": (B,), "ts": (B, OUT_LEN)},
                           {"mask": "float32", "ts": "float32"})
    sizes = [1, 3, 8, 2, 5, 7, 4, 6] * 2
    results, errors = {}, []

    def client(c):
        try:
            for j, k in enumerate(sizes[c % 4::4]):
                rows = _rows(k, seed=100 * c + j)
                out = batcher.submit({"mask": rows["mask"], "ts": rows["ts"]})
                results[(c, j)] = (out, rows["ts"])
        except Exception as e:  # a failed client fails the test below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    batcher.close()
    assert not any(t.is_alive() for t in threads) and not errors
    for out, ts in results.values():
        np.testing.assert_array_equal(out, ts * 2.0)

    queue, packs = tracing.records("batcher.queue"), tracing.records("batcher.pack")
    calls = tracing.records("batcher.call")
    assert len(queue) == len(results) and len(calls) == len(packs) == batcher.dispatches
    call_by_id = {r[1]: r for r in calls}
    per_call = collections.Counter(q[6]["call"] for q in queue)
    assert set(per_call) == set(call_by_id)
    for q in queue:
        assert q[4] <= q[5] <= call_by_id[q[6]["call"]][4]
    for pack, call in zip(packs, calls):  # the worker: pack, then call
        assert pack[3] == call[3] and pack[5] <= call[4]
    c = tracing.counters()
    assert c["batcher.rows"] == sum(len(ts) for _, ts in results.values())
    assert c["batcher.rows"] + c["batcher.padded_rows"] == batcher.dispatches * B


def test_served_call_phases_and_decode_steps_under_the_forward():
    batch = _rows(4)
    fn, _ = make_forecaster(_demand(), batch, device="cpu")
    tracing.reset()
    for _ in range(3):
        fn(batch)
    up, fwd, down = (tracing.records(f"forecast.{n}") for n in ("upload", "forward", "download"))
    assert len(up) == len(fwd) == len(down) == 3
    steps = tracing.records("decode.step")
    assert len(steps) == 3 * OUT_LEN
    for u, f, d in zip(up, fwd, down):
        assert u[2] == f[2] == d[2] == 0
        assert u[5] <= f[4] and f[5] <= d[4]
        kids = [s for s in steps if s[2] == f[1]]
        assert len(kids) == OUT_LEN and all(_within(s, f) for s in kids)


@pytest.mark.parametrize("native_prefetch", [False, True])
def test_train_phases_once_a_step_and_one_loader_batch_a_batch(native_prefetch):
    loader = _loader(native_prefetch=native_prefetch)
    trainer = Trainer(_demand(), TrainConfig(seed=0))
    state = trainer.init_state()
    tracing.reset()
    n = 0
    for batch in loader:
        state, _ = trainer.train_step(state, batch)
        n += 1
    assert n == 3
    loads, steps = tracing.records("loader.batch"), tracing.records("train.step")
    assert len(loads) == len(steps) == 3
    for load, step in zip(loads, steps):  # closed before the batch is handed over
        assert load[5] <= step[4] and load[2] == 0
    for phase in TRAIN_PHASES:
        recs = tracing.records(phase)
        assert [r[2] for r in recs] == [s[1] for s in steps], phase
        assert all(_within(r, s) for r, s in zip(recs, steps)), phase
    for i, step in enumerate(steps):  # in order inside the step
        t = [tracing.records(p)[i] for p in TRAIN_PHASES]
        assert all(a[5] <= b[4] for a, b in zip(t, t[1:]))
    forwards = {r[1] for r in tracing.records("train.forward")}
    decode = collections.Counter(r[2] for r in tracing.records("decode.step"))
    assert set(decode) == forwards and set(decode.values()) == {OUT_LEN}

    # Accumulation: one step, one update, a phase a microbatch.
    tracing.reset()
    state, _ = trainer.accum_train_step(state, [_tensors(_rows(4, seed=s)) for s in (1, 2)])
    (step,) = tracing.records("train.step")
    got = {p: [r[2] for r in tracing.records(p)] for p in TRAIN_PHASES}
    assert got == {"train.upload": [step[1]] * 2, "train.forward": [step[1]] * 2,
                   "train.backward": [step[1]] * 2, "train.optimizer": [step[1]]}


def _profiled_names(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return collections.Counter(e.name() for e in prof.profiler.kineto_results.events())


def test_the_profiler_sees_no_port_span_and_the_same_operations():
    batch = _rows(4)
    fn, _ = make_forecaster(_demand(), batch, device="cpu")
    trainer = Trainer(_demand(1), TrainConfig(seed=0))
    state = trainer.init_state()
    train_batch = _tensors(_rows(4, seed=9))

    def work():
        fn(batch)
        trainer.train_step(state, train_batch)
        for _ in zip(range(1), _loader()):
            pass

    work()  # warm
    tracing.reset()
    on = _profiled_names(work)
    port = {r[0] for r in tracing.records()}
    assert {"forecast.forward", "decode.step", "train.optimizer", "loader.batch"} <= port
    assert not [n for n in on if n in port or n.startswith(PORT_PREFIXES)]
    held = len(tracing.records())
    tracing.enable(False)
    off = _profiled_names(work)
    assert len(tracing.records()) == held
    assert on == off


def test_trace_writes_the_spans_beside_the_profilers_events(tmp_path):
    trainer = Trainer(_demand(), TrainConfig(seed=0))
    state = trainer.init_state()
    batch = _tensors(_rows(4, seed=9))
    state, _ = trainer.train_step(state, batch)  # warm
    with tracing.trace(str(tmp_path)):
        state, _ = trainer.train_step(state, batch)
    (path,) = list(tmp_path.iterdir())
    events = json.loads(path.read_text())["traceEvents"]
    port = [e for e in events if e.get("pid") == tracing.SPANS_PID and e["ph"] == "X"]
    names = collections.Counter(e["name"] for e in port)
    assert names == {"train.step": 1, **{p: 1 for p in TRAIN_PHASES}, "decode.step": OUT_LEN}
    (mine,) = [e for e in port if e["name"] == "train.optimizer"]
    (theirs,) = [e for e in events if e.get("name") == "Optimizer.step#Adafactor.step"]
    assert abs(mine["ts"] - theirs["ts"]) < 1000  # µs
    assert abs(mine["ts"] + mine["dur"] - theirs["ts"] - theirs["dur"]) < 1000
