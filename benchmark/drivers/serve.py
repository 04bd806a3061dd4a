"""Served forecasts: closed-loop clients over ``MicroBatcher`` and the
``make_forecaster`` callable, in one process, with no sockets.

The traffic file gives ``clients`` closed-loop clients, each sending its
next request when the last returns.  A request holds k products: k runs
through a fixed table of ``size_table`` sizes, log-uniform on
``rows_min``..``rows_max`` at evenly spaced quantiles, which the seed only
permutes; the clients take the requests in turn from one shared counter,
cycling through the table, so every seed offers the same work in another
order.  Each request's rows are drawn from a seeded pool of ``pool``
products, and the requests are made in set-up.  Latency runs from
``submit`` to the return of its rows.  The clients start ``warm_s`` before
the window; a request counts when it returns inside the window.

After the window the program is freed and the reference recomputes a
sample of the answers: the largest request returned in the window and
others drawn from the seed, ``check_rows`` rows in all, from the same
weights and products, in float32 (``answer_gap``).
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import threading
import time

import numpy as np
import torch

from benchmark import core, data, program, trace
from benchmark import weights as W
from benchmark.reference import model as ref
from benchmark.reference.precision import backends


def size_table(t: dict) -> np.ndarray:
    q = (np.arange(t["size_table"]) + 0.5) / t["size_table"]
    k = np.floor(np.exp(np.log(t["rows_min"]) + q * np.log((t["rows_max"] + 1) / t["rows_min"])))
    return np.clip(k, t["rows_min"], t["rows_max"]).astype(np.int64)


class _Clients:
    """The closed-loop clients and what each request did.  The requests are
    made in set-up, ``size_table`` of them in the seed's order; the clients
    take them in turn from one shared counter, cycling through the table, so
    every seed offers the same requests in another order."""

    def __init__(self, batcher, requests, n_clients):
        self.batcher, self.requests = batcher, requests
        self.counter = itertools.count()
        self.stop = threading.Event()
        self.records = [[] for _ in range(n_clients)]
        self.threads = [threading.Thread(target=self._loop, args=(c,), daemon=True)
                        for c in range(n_clients)]

    def _loop(self, c):
        while not self.stop.is_set():
            i = next(self.counter) % len(self.requests)
            t = time.perf_counter()
            try:
                out, err = self.batcher.submit(self.requests[i][1]), None
            except Exception as e:  # a failed request counts as missing
                out, err = None, repr(e)
            self.records[c].append((t, time.perf_counter(), i, out, err))

    def start(self):
        for th in self.threads:
            th.start()

    def finish(self, timeout: float = 120.0):
        self.stop.set()
        deadline = time.perf_counter() + timeout
        for th in self.threads:
            th.join(max(0.0, deadline - time.perf_counter()))
        return not any(th.is_alive() for th in self.threads)


def make_requests(t: dict, pool: dict, seed: int) -> list:
    """``size_table`` requests [(product indices, arrays)]: the sizes in the
    seed's order, each request's products drawn from the pool by its own
    generator."""
    sizes = np.random.default_rng(W.sub_seed(seed, 3)).permutation(size_table(t))
    n_pool = len(pool["ts"])
    out = []
    for i, k in enumerate(sizes):
        idx = np.random.default_rng([W.sub_seed(seed, 2), i]).integers(0, n_pool, int(k))
        out.append((idx, data.rows(pool, idx)))
    return out


def run(cell: dict, seed: int, seconds: float, traced: bool, t_process: float,
        opts: dict = None) -> tuple:
    """One run of a serving cell -> (result, checks).  ``opts``: the CPU
    rehearsal's ``device``, build ``overrides``, ``image_size``,
    ``export_batch``, ``pool``, ``clients``, ``fault``."""
    from visuelle2_tpu_torch.eval.export import make_forecaster
    from visuelle2_tpu_torch.eval.server import MicroBatcher

    opts = opts or {}
    cfg, t = cell["config"], dict(cell["traffic"])
    t.update({k: opts[k] for k in ("clients", "pool", "size_table") if k in opts})
    device = torch.device(opts.get("device", "cuda"))
    B = opts.get("export_batch", cfg["export_batch"])
    t["rows_max"] = min(t["rows_max"], B)
    size = opts.get("image_size", cfg["image_size"])
    overrides = opts.get("overrides")

    model = program.build_model(cfg, device, overrides=overrides)
    pool = data.make_products(t["pool"], size, cfg["vocab"], seed, device,
                              cfg["model"].get("output_len", cfg["model"].get("out_len")))
    weights = serving_weights(cfg, W.layout_of(model), pool, seed, device, overrides)
    W.load_into(model, weights)
    weights = {k: v.cpu() for k, v in weights.items()}  # the reference's, after the window
    model = program.prepare(model, cfg, {"device": device, "seed": seed, "products": pool})
    fn, header = make_forecaster(model, data.rows(pool, np.arange(B) % t["pool"]),
                                 device=device)
    handles, span_modules = [], cfg.get("spans", {})
    if traced:
        trace.use_markers(device)
        for name, spec in span_modules.items():
            for path in spec["modules"]:
                handles += trace.hook_module(program.module(model, path), name)
    calls = []  # (start, end, real rows) of every served call
    fault = opts.get("fault")
    # The profiler records the thread that starts it: the batcher's worker
    # starts and stops it between two calls (see ``_profile``).
    prof = {"state": "warm" if traced else "off"}

    def served(batch):
        _profile(prof, device, time.perf_counter())
        t_call = time.perf_counter()
        with trace.span("forecast_fn") if traced else contextlib.nullcontext():
            out = fn(batch)
        if fault == "answer":
            out = out.copy()
            out[:, -1] += 1.0
        t_end = time.perf_counter()
        calls.append((t_call, t_end, int(np.asarray(batch["mask"]).sum())))
        _profile(prof, device, t_end)
        return out

    batcher = MicroBatcher(served, header["keys"],
                           {k: tuple(v) for k, v in header["shapes"].items()},
                           header["dtypes"])
    # Warm the one shape the cell uses, full export batches, on the worker.
    for _ in range(2):
        batcher.submit(data.rows(pool, np.arange(B) % t["pool"]))
    calls.clear()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    requests = make_requests(t, pool, seed)
    clients = _Clients(batcher, requests, t["clients"])
    clients.start()
    time.sleep(t["warm_s"])
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    if traced:
        span_s = min(t["trace_s"], seconds / 3)
        gap = (seconds - 2 * span_s) / 3
        prof.update(at=t0 + gap, span_s=span_s, gap=gap, state="due_device")
    time.sleep(seconds)
    t1 = time.perf_counter()
    finished = clients.finish()
    if prof["state"] in ("on_device", "on"):
        # A stretch still open at the window's close ends on the worker,
        # the thread that started it, at one more call.
        prof["span_s"] = 0.0
        batcher.submit(requests[0][1])
    batcher.close()

    records = [r for rs in clients.records for r in rs]
    done = [r for r in records if t0 <= r[1] <= t1]
    ok = [(t_, e_, requests[i][0], out) for t_, e_, i, out, err in done if err is None]
    failed = [r for r in done if r[4] is not None] + ([] if finished else [None])
    rows = sum(len(r[2]) for r in ok)
    window = t1 - t0
    device_rec = (core.device_record(torch, 1) if device.type == "cuda"
                  else {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0})
    result = {"correct": False, "attempted": len(done), "failed": len(failed)}
    # The host's counters leave out the profiled stretches and the
    # profiler's stops, which hold the worker while they collect the events:
    # the calls inside the window and outside them, and the gaps between
    # two such calls in a row.
    cuts = prof.get("cuts", [])
    kept = [c for c in calls if t0 <= c[0] and c[1] <= t1
            and not any(a <= c[1] and c[0] <= b for a, b in cuts)]
    gaps = [b[0] - a[1] for a, b in zip(kept, kept[1:])
            if not any(a[1] <= y and x <= b[0] for x, y in cuts)]
    counters = {
        "rows": rows, "requests": len(ok), "export_batch": B,
        "calls": [(c[1] - c[0], c[2]) for c in kept], "gaps_s": gaps,
        "latencies_ms": [1e3 * (r[1] - r[0]) for r in ok
                         if not any(a <= r[1] and r[0] <= b for a, b in cuts)],
    }
    trace_rec = None
    if prof["state"] == "done":
        trace_rec = trace.reduce(prof.pop("prof"), prof["p1"] - prof["p0"],
                                 work_span="forecast_fn")
        trace_rec["faults"] = trace.check_spans(trace_rec, ["forecast_fn", *span_modules])
        d0, d1 = prof["d0"], prof["d1"]
        trace_rec["device"] = trace.reduce(prof.pop("prof_device"), d1 - d0)
        trace_rec["device"]["real_rows"] = sum(c[2] for c in calls if d0 <= c[0] and c[1] <= d1)
    trace.remove(handles)
    trace.use_markers(torch.device("cpu"))

    metrics, extra = {}, {}
    if not traced:
        metrics["forecasts_per_s"] = core.metric(rows / window, "forecasts/s")
        metrics["setup_s"] = core.metric(setup_s, "s")
    else:
        ctx = Ctx(cell, counters, trace_rec, B)
        for m in cell["per_layer"]:
            v = core.read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = core.metric(v, m["unit"])
        if trace_rec is not None:
            extra["trace_dropped"] = trace_rec["dropped"]
            device_rec["busy_s"] = trace_rec["device"]["busy_s"]
            device_rec["window_s"] = trace_rec["device"]["window_s"]
            extra["breakdown"] = {"device_ops": trace_rec["device"]["top_ops"],
                                  "idle_gaps": trace_rec["idle_gaps"]}
    result.update(metrics=metrics, device=device_rec, **extra)

    # Correctness, after the window: the program freed, the reference on
    # the same weights and products.
    del fn, batcher, model, clients.batcher
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sample = sample_answers(ok, t["check_rows"], seed)
    readings = answer_gap(cfg, weights, pool, sample, device, overrides, False, B)
    checks = {k: {"value": readings[k], "limit": v} for k, v in cell["limits"].items()}
    faults = []
    if not finished:
        faults.append("a client never returned")
    if failed:
        faults.append(f"{len(failed)} requests failed")
    if not ok:
        faults.append("no request returned in the window")
    if traced and (trace_rec is None or trace_rec["faults"]):
        faults.append("trace: " + "; ".join(trace_rec["faults"] if trace_rec else
                                            ["the profiled stretch did not close"]))
    result["correct"] = bool(not faults and all(c["value"] <= c["limit"]
                                                 for c in checks.values()))
    result["faults"] = faults
    if opts.get("control"):
        result["_control"] = answer_gap(cfg, weights, pool, sample, device, overrides, True, B)
    return result, checks


def _profile(prof: dict, device, now: float) -> None:
    """Between two served calls on the worker: warm the profiler on the
    first call; in the window profile one stretch of the device alone (the
    busy time, undisturbed by recording the host), then one of the device
    and the host (the spans), each ``span_s`` long, ``gap`` apart."""
    state = prof["state"]
    if state == "warm":
        trace.warm_profiler(device)
        prof["state"] = "off"
    elif state == "due_device" and now >= prof["at"]:
        prof["prof_device"] = trace.start_profiler(device, host=False)
        prof["d0"], prof["state"] = time.perf_counter(), "on_device"
    elif state == "on_device" and now >= prof["d0"] + prof["span_s"]:
        prof["d1"] = trace.stop_profiler(prof["prof_device"], device)
        prof["cuts"] = [(prof["d0"], time.perf_counter())]
        prof["at"], prof["state"] = time.perf_counter() + prof["gap"], "due"
    elif state == "due" and now >= prof["at"]:
        prof["prof"] = trace.start_profiler(device)
        prof["p0"], prof["state"] = time.perf_counter(), "on"
    elif state == "on" and now >= prof["p0"] + prof["span_s"]:
        prof["p1"], prof["state"] = trace.stop_profiler(prof["prof"], device), "done"
        prof["cuts"].append((prof["p0"], time.perf_counter()))


class Ctx:
    """What a per-layer reader reads: the cell, the window's counters, the
    reduced trace (None when nothing was traced), the export batch and the
    configuration's spans."""

    def __init__(self, cell, counters, trace_rec, batch):
        self.cell, self.counters, self.trace = cell, counters, trace_rec
        self.batch = batch
        self.config = cell["config"]
        self.model = self.config["model"]
        self.spans = self.config.get("spans", {})


def sample_answers(ok: list, n_rows: int, seed: int) -> list:
    """The largest request returned in the window, then others drawn from
    the seed, until ``n_rows`` rows: [(product indices, served rows)]."""
    if not ok:
        return []
    order = np.random.default_rng(W.sub_seed(seed, 4)).permutation(len(ok))
    largest = max(range(len(ok)), key=lambda i: len(ok[i][2]))
    picked, total = [], 0
    for i in [largest] + [int(j) for j in order if j != largest]:
        if total >= n_rows:
            break
        k = min(len(ok[i][2]), n_rows - total)
        picked.append((ok[i][2][:k], np.asarray(ok[i][3])[:k]))
        total += k
    return picked


def serving_weights(cfg, layout, pool, seed, device, overrides, n_calib: int = 64) -> dict:
    """The drawn weights, the backbone's BatchNorm running statistics set to
    the batch statistics of the pool's first ``n_calib`` photos by the
    reference (``reference/model.py::calibrate_running_stats``)."""
    P = W.draw(layout, seed, cfg.get("init", []), device)
    arch = program.reference_model(cfg, overrides=overrides)["image_arch"]
    images = torch.from_numpy(pool["images"][:n_calib]).to(device)
    precision = cfg["precision"]["reference"]
    with backends(precision):
        for path in cfg["spans"]["backbone"]["modules"]:
            ref.calibrate_running_stats(P, path, images, arch, precision)
    return P


def answer_gap(cfg, weights, pool, sample, device, overrides, control, block) -> dict:
    """Over ``sample``, each against the images' effect, the RMS of the
    reference's change when every row takes the next sampled row's photo:
    ``forecast_gap``, max |served − reference|, and ``forecast_rms_gap``,
    RMS(served − reference).  With random weights the photos move a
    forecast by a few per cent of its size, and only the image path runs
    in bfloat16, so the gap is read against what the photos do.  With
    ``control`` the forecasts of the configuration's control precision
    stand for the served ones (each then against the reference)."""
    if not sample:
        return {"forecast_gap": float("inf"), "forecast_rms_gap": float("inf")}
    idx = np.concatenate([s[0] for s in sample])
    served = np.concatenate([s[1] for s in sample]).reshape(len(idx), -1)
    P = {k: v.to(device) for k, v in weights.items()}
    m = program.reference_model(cfg, overrides=overrides)
    exact = cfg["precision"]["reference"]
    want = _reference_rows(P, m, pool, idx, device, exact, block)
    moved = _reference_rows(P, m, pool, idx, device, exact, block, photos=np.roll(idx, 1))
    if control:
        served = _reference_rows(P, m, pool, idx, device, cfg["precision"]["control"], block)
    scale = max(float(np.sqrt(np.mean((moved - want) ** 2))), 1e-30)
    diff = served.astype(np.float64) - want
    return {"forecast_gap": float(np.max(np.abs(diff))) / scale,
            "forecast_rms_gap": float(np.sqrt(np.mean(diff ** 2))) / scale}


@torch.no_grad()
def _reference_rows(P, m, pool, idx, device, precision, block, photos=None):
    """The reference's forecasts of the products ``idx``, with the photos of
    ``photos`` when given."""
    out = []
    with backends(precision):
        for lo in range(0, len(idx), block):
            rows = data.rows(pool, idx[lo: lo + block])
            if photos is not None:
                rows["images"] = pool["images"][photos[lo: lo + block]]
            batch = data.to_torch(rows, device)
            f = ref.forward(P, batch, m, ref.Runtime(precision=precision))
            out.append(f.reshape(len(batch["ts"]), -1).double().cpu().numpy())
    return np.concatenate(out)
