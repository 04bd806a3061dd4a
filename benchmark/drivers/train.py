"""Training steps: ``BatchLoader`` (shuffled, the native prefetch engine on,
as the train CLIs build it) feeding ``Trainer.train_step``.

The traffic file gives the batch, the split's rows (made from the seed:
photos, attributes, trends and the 12-week series ``ts`` that Demand
training fits), the update count training resumes at, the steps the
reference follows and the steps warmed after them.  Set-up builds one
``Trainer`` and its state, sets Adafactor's update count to
``resume_count`` (as a resumed run's state holds it: past the relative-step
schedule's warm-up, 1e-6·t up to t = 10,000, the rate is 1/√t, so a step
moves the parameters by about a hundredth of their RMS and the loss with
them, where the first steps of a run move them by a millionth), and drives
it through its first ``checked_steps`` steps by the window's own call and
feed (rows of one shuffled epoch, all different); the window then runs the
same object for ``--seconds``, a new epoch whenever the loader runs dry,
and ends on a synchronise.  ``train_samples_per_s`` is the rows of every
step started in the window over the time to that synchronise.

Compared after the window, the program freed, against the reference's
steps from the same weights on the same rows (each batch's rows are told by
its ``ts``, drawn from the seed and unique): every checked step's loss; the
first gradient's norm for each trainable leaf, worked out from Adafactor's
state after one step (``v`` is (1 − β)·(g² + 1e-30) from empty moments;
a factored leaf's row moment holds its mean over the dim it drops), by the
worst leaf: the difference of the two norms over the larger of the
reference's norm of that leaf and of the median leaf; and the median
leaf's change over the checked steps, against the reference's
(``update_median_gap``).  The changes leave out leaves whose reference
gradient is under a thousandth of the median leaf's (moved by round-off
alone).  Read beside them and not compared (the cell's limits name what is
compared): the change leaf by leaf, signed, ‖Δ_program − Δ_reference‖ /
‖Δ_reference‖, the median over leaves (``update_diff_gap``); the worst
leaf's change; and the share of elements whose change has the other sign
than the reference's.  At full width the bfloat16 program's change and the
reference's take other signs in about a third of a leaf's elements (the
gradients of 23 train-mode BatchNorm blocks cancel, so rounding sets many
signs), and the control's in nearly half: the signed change cannot tell a
sound run from a fault there, while past warm-up the losses of steps 2-3
carry the update and an update of the wrong sign moves them by hundreds of
times a sound run's gap.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from benchmark import core, data, program, trace
from benchmark import weights as W
from benchmark.reference import train as ref_train
from benchmark.reference.precision import backends

EPS = 1e-30  # Adafactor's ε in s = g² + ε


def _stream(loader):
    while True:
        yield from loader


def _row_finder(ts: np.ndarray):
    table = {row.tobytes(): i for i, row in enumerate(ts)}

    def find(batch) -> np.ndarray:
        idx = [table.get(row.tobytes(), -1) for row in batch["ts"].numpy()]
        return np.asarray(idx, np.int64)

    return find


def grad_norms_from_state(optimizer, names, count0: int) -> dict:
    """Each trainable leaf's first-step gradient norm from Adafactor's
    second moments after exactly one update from empty moments at update
    count ``count0``: v = (1 − β)·(g² + ε)."""
    rest = ref_train.decay(count0)[1]
    out = {}
    for p, name in names.items():
        st = optimizer.state.get(p, {})
        if "v" in st:
            sq = st["v"].double().sum() / rest - p.numel() * EPS
        elif "v_row" in st:
            d1, d0 = ref_train.factored_dims(tuple(p.shape))
            sq = st["v_row"].double().sum() * p.shape[d0] / rest - p.numel() * EPS
        else:
            continue
        out[name] = float(torch.sqrt(torch.clamp_min(sq, 0.0)))
    return out


def run(cell: dict, seed: int, seconds: float, traced: bool, t_process: float,
        opts: dict = None) -> tuple:
    """One run of a training cell -> (result, checks).  ``opts``: the CPU
    rehearsal's ``device``, build ``overrides``, ``image_size``,
    ``batch_size``, ``rows``, ``fault``."""
    from visuelle2_tpu_torch.data.images import ImageStore
    from visuelle2_tpu_torch.data.loader import BatchLoader
    from visuelle2_tpu_torch.data.pipeline import Visuelle2Arrays
    from visuelle2_tpu_torch.train.loop import TrainConfig, Trainer

    opts = opts or {}
    cfg, t = cell["config"], cell["traffic"]
    device = torch.device(opts.get("device", "cuda"))
    B = opts.get("batch_size", t["batch_size"])
    n_rows = opts.get("rows", t["rows"])
    size = opts.get("image_size", cfg["image_size"])
    overrides = opts.get("overrides")
    out_len = cfg["model"].get("output_len", cfg["model"].get("out_len"))
    train_seed = W.sub_seed(seed, 5) % (2 ** 31)

    model = program.build_model(cfg, device, train=True, overrides=overrides)
    layout = W.layout_of(model)
    program.load_weights(model, cfg, seed, device)
    products = data.make_products(n_rows, size, cfg["vocab"], seed, device, out_len)
    model = program.prepare(model, cfg, {"device": device, "seed": seed, "products": products})
    arrays = Visuelle2Arrays(
        demand=True, output_len=out_len, cat=products["cat"], col=products["col"],
        fab=products["fab"], store=products["store"], temporal=products["temporal"],
        gtrends=products["gtrends"], image_paths=np.zeros(n_rows, object),
        ts=products["ts"])
    loader = BatchLoader(arrays, ImageStore(products["images"]), B, shuffle=True,
                         seed=train_seed, drop_remainder=True,
                         pin_memory=device.type == "cuda",
                         native_prefetch=t["native_prefetch"])
    trainer = Trainer(model, TrainConfig(seed=train_seed, grad_clip=cfg["train"]["grad_clip"],
                                         norm_scalar=cfg["train"]["norm_scalar"]))
    state = trainer.init_state()
    count0 = int(t["resume_count"])
    for group in state.optimizer.param_groups:
        group["count"] = count0
    names = {p: n for n, p in model.named_parameters() if p.requires_grad}
    fault = opts.get("fault")
    if fault == "state_unchanged":
        state.optimizer.step = lambda closure=None: None
    elif fault == "update_sign":  # p + u where the rule says p − u
        state.optimizer.step = _sign_flipped(state.optimizer.step, list(names))

    def step(batch):
        if fault == "half_batch":
            batch = dict(batch)
            batch["mask"] = batch["mask"].clone()
            batch["mask"][B // 2:] = 0.0
        nonlocal state
        state, m = trainer.train_step(state, batch)
        return m["loss"]

    find = _row_finder(products["ts"])
    stream = _stream(loader)
    checked_rows, losses, grad_norms = [], [], None
    for s in range(t["checked_steps"]):
        batch = next(stream)
        checked_rows.append(find(batch))
        losses.append(step(batch))
        if s == 0:
            grad_norms = grad_norms_from_state(state.optimizer, names, count0)
    after = {n: p.detach().to("cpu", copy=True) for p, n in names.items()}
    losses = [float(v) for v in losses]
    for _ in range(t["warm_steps"]):
        step(next(stream))
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    handles, span_modules = [], cfg.get("spans", {})
    if traced:
        trace.use_markers(device)
        for name, spec in span_modules.items():
            for path in spec["modules"]:
                handles += trace.hook_module(program.module(model, path), name)
        handles += trace.hook_optimizer(state.optimizer)
        trace.warm_profiler(device)
    span_s = min(t["trace_s"], seconds / 3)
    gap = (seconds - 2 * span_s) / 3
    # Traced: one stretch of the device alone (busy time), then one of the
    # device and the host (spans), each begun and ended at a step's edge.
    stretches, current = [], None
    steps, wait_s, wait_steps = 0, 0.0, 0
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    while True:
        if traced and current is None and len(stretches) < 2 and \
                time.perf_counter() - t0 >= gap * (len(stretches) + 1) + span_s * len(stretches):
            host = len(stretches) == 1
            current = {"prof": trace.start_profiler(device, host=host), "host": host,
                       "t0": time.perf_counter(), "steps": 0}
        tw = time.perf_counter()
        batch = next(stream)
        waited = time.perf_counter() - tw
        with trace.span("train_step") if traced else contextlib.nullcontext():
            last_loss = step(batch)
        steps += 1
        if current is not None:
            current["steps"] += 1
            if time.perf_counter() - current["t0"] >= span_s:
                current["t1"] = trace.stop_profiler(current["prof"], device)
                stretches.append(current)
                current = None
        else:  # the loader's counter leaves out the profiled steps
            wait_s += waited
            wait_steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    if current is not None:  # the window closed first
        current["t1"] = trace.stop_profiler(current["prof"], device)
        stretches.append(current)
    window = t1 - t0

    device_rec = (core.device_record(torch, 1) if device.type == "cuda"
                  else {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0})
    result = {"correct": False, "attempted": steps, "failed": 0}
    counters = {"window_s": window, "steps": steps, "rows": steps * B, "batch": B,
                "loader_wait_s": wait_s, "loader_waits": wait_steps}
    trace_rec, extra, metrics = None, {}, {}
    if len(stretches) == 2:
        dev, full = stretches
        trace_rec = trace.reduce(full["prof"], full["t1"] - full["t0"], work_span="train_step")
        trace_rec["faults"] = trace.check_spans(
            trace_rec, ["train_step", "optimizer", *span_modules])
        trace_rec["device"] = trace.reduce(dev["prof"], dev["t1"] - dev["t0"])
        trace_rec["device"]["real_rows"] = dev["steps"] * B
    del stretches, current
    trace.remove(handles)
    trace.use_markers(torch.device("cpu"))
    if not traced:
        metrics["train_samples_per_s"] = core.metric(steps * B / window, "samples/s")
        metrics["setup_s"] = core.metric(setup_s, "s")
    else:
        ctx = Ctx(cell, counters, trace_rec)
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

    del state, trainer, model, loader, stream, names
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = compare(cfg, layout, products, checked_rows, losses, grad_norms, after, seed,
                       train_seed, count0, device, overrides, False)
    readings["window_last_loss"] = float(last_loss)  # the look: training stays finite
    limits = cell["limits"]
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    faults = []
    if any((r < 0).any() for r in checked_rows):
        faults.append("a checked batch holds a row that is not the split's")
    if traced and (trace_rec is None or trace_rec["faults"]):
        faults.append("trace: " + "; ".join(trace_rec["faults"] if trace_rec else
                                            ["the profiler window did not close"]))
    result["correct"] = bool(not faults and all(c["value"] <= c["limit"]
                                                 for c in checks.values()))
    result["faults"] = faults
    result["_readings"] = readings
    if opts.get("control"):
        result["_control"] = compare(cfg, layout, products, checked_rows, losses, grad_norms,
                                     after, seed, train_seed, count0, device, overrides, True)
    return result, checks


class Ctx:
    def __init__(self, cell, counters, trace_rec):
        self.cell, self.counters, self.trace = cell, counters, trace_rec
        self.config = cell["config"]
        self.model = self.config["model"]


def _sign_flipped(step, params):
    """An optimizer step that moves each parameter by the update's opposite."""
    def flipped(closure=None):
        before = [p.detach().clone() for p in params]
        step()
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(2 * b - p)
    return flipped


def compare(cfg, layout, products, checked_rows, losses, grad_norms, after, seed, train_seed,
            count0, device, overrides, control) -> dict:
    """The reference's checked steps from the same weights and rows, and
    the gaps of the program's readings from them.  With ``control`` the
    readings of the configuration's control precision stand for the
    program's."""
    P0 = W.draw(layout, seed, cfg.get("init", []), device)
    m = program.reference_model(cfg, train=True, overrides=overrides)
    batches = [data.to_torch(data.rows(products, np.clip(r, 0, None)), device)
               for r in checked_rows]
    clip = cfg["train"]["grad_clip"]
    exact, lower = cfg["precision"]["reference"], cfg["precision"]["control"]
    with backends(exact):
        want = ref_train.train_steps(P0, batches, m, clip, train_seed, exact, count0)
    if control:
        with backends(lower):
            got = ref_train.train_steps(P0, batches, m, clip, train_seed, lower, count0)
        losses, grad_norms = got["losses"], got["grad_norms"]
        after = {k: v.cpu() for k, v in got["params"].items()}
    return gaps(want, P0, losses, grad_norms, after)


def gaps(want: dict, P0: dict, losses, grad_norms, after) -> dict:
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, want["losses"]))
    g_ref = want["grad_norms"]
    g_med = float(np.median(list(g_ref.values())))
    per_leaf = {k: (abs(grad_norms[k] - v) / max(v, g_med) if k in grad_norms
                    else float("inf")) for k, v in g_ref.items()}
    moved = [k for k, v in g_ref.items() if v >= 1e-3 * g_med]
    d_ref, d_got, diff, flips = {}, {}, {}, {}
    for k in moved:
        p0 = P0[k].double()
        dr = want["params"][k].double() - p0
        dg = after[k].to(p0.device).double() - p0
        d_ref[k] = float(torch.linalg.vector_norm(dr))
        d_got[k] = float(torch.linalg.vector_norm(dg))
        diff[k] = float(torch.linalg.vector_norm(dg - dr)) / max(d_ref[k], 1e-300)
        nonzero = dr != 0
        flips[k] = float((torch.sign(dg) != torch.sign(dr))[nonzero].double().mean()) \
            if bool(nonzero.any()) else 0.0
    d_med = float(np.median(list(d_ref.values())))
    u_gaps = {k: abs(d_got[k] - d_ref[k]) / max(d_ref[k], d_med) for k in moved}
    worst = lambda gs: max(gs, key=gs.get)
    w_leaf = worst(u_gaps)
    return {"loss_gap": float(loss_gap), "grad_gap": float(max(per_leaf.values())),
            "update_median_gap": abs(float(np.median(list(d_got.values()))) - d_med) / d_med,
            "update_diff_gap": float(np.median(list(diff.values()))),
            # The look (not compared): the change by the worst leaf, which
            # leaves are worst, and the share of elements whose change has
            # the other sign than the reference's (the worst leaf's, the
            # median leaf's).
            "update_worst_gap": float(u_gaps[w_leaf]), "update_worst_leaf": w_leaf,
            "update_worst_leaf_sign_flips": flips[w_leaf],
            "update_median_sign_flips": float(np.median(list(flips.values()))),
            "grad_worst_leaf": worst(per_leaf),
            "leaves_compared": len(moved), "leaves_left_out": len(g_ref) - len(moved)}
