"""Test-split scoring, counterpart of ``visuelle2_tpu/eval/forecast.py``.

``score_split`` runs a model over every batch of a loader and keeps only
masked partial metric sums on the device, in float64: one host sync at the
end gives WAPE and MAE.  It also reports forecasts/s (CUDA events over
distinct batches), GFLOPs per sample and the peak device memory of one
batch (``eval/profiler.py``), and the host-clock seconds of the whole
scoring pass, batch assembly and copies included.

``one_pass=True`` copies every batch of the split to the device first and
then scores with no host copy in the loop; ``False`` copies and scores one
batch at a time; ``None`` picks one-pass when the split's bytes fit
``one_pass_budget_bytes`` (a quarter of the card's memory).  The JAX
``score_split``'s ``apply_fn`` is the model itself here: the w8a8 path
scores ``models/quantized_resnet.py::quantized_model``'s copy, so the
metrics, GFLOPs and forecasts/s are that path's.

``mesh`` (``parallel/mesh.py``): each data index scores its row block of
every batch (a loader with its ``rank`` / ``world`` from
``batch_rank_world``) inside ``parallel.collectives.data_parallel`` (a
dedup batch's slots are spread over the data ranks), the sums are
all-reduced over the data group before the host reads them (with a
``model`` axis, model rank 0's, ``train/loop.py::sum_eval_sums``), and
forecasts/s counts the global rows (per chip: divided by every rank of the
mesh), as the JAX ``score_split`` does over its mesh.  A model sharded
over the ``model`` axis (``parallel/sharding.py``) gathers each sharded
weight once for the pass (``sharding.gathered``), so every rank of the mesh
calls ``score_split``.  Without one it is ``make_mesh()``: one rank with no
process group.
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import time
from typing import List, Optional

import numpy as np
import torch

from visuelle2_tpu_torch.eval.profiler import batch_flops, peak_memory_bytes
from visuelle2_tpu_torch.ops.metrics import eval_metrics, finalize_metrics
from visuelle2_tpu_torch.parallel import collectives
from visuelle2_tpu_torch.parallel import mesh as mesh_lib
from visuelle2_tpu_torch.parallel import sharding
from visuelle2_tpu_torch.train.loop import (
    SUM_KEYS,
    expand_mask,
    sum_eval_sums,
    target_and_pred,
    to_device,
)
# One-pass keeps the whole split on the device beside the weights, the
# activations and the allocator's workspace: it may take this share of the
# device's memory (of the host's on the CPU).
ONE_PASS_MEMORY_SHARE = 0.25
TIMING_WINDOWS = 3  # throughput: the median of this many timed windows


def one_pass_budget_bytes(device: torch.device) -> int:
    """Bytes the stacked split may take for ``one_pass=None`` to pick
    one-pass: ``ONE_PASS_MEMORY_SHARE`` of the card's own memory."""
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return int(ONE_PASS_MEMORY_SHARE * total)


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _flatten(tree, prefix=()):
    """``(path, tensor)`` leaves of nested dicts and sequences; the path
    parts are dict keys and list indices, as in JAX tree paths."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _flatten(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def dump_attention(model, batch, path: str) -> Optional[List[str]]:
    """Save the model's attention weights for one batch as an ``.npz``.

    Demand returns its per-step ``img`` / ``trend`` / ``multimodal`` alphas,
    each ``[T, N, L]``; the keys are the JAX tree paths ("img", ...).  Returns
    the sorted keys, or None when the model has no attention aux.
    """
    with torch.inference_mode():
        _, aux = model(to_device(batch, _model_device(model)))
    if aux is None:
        return None
    arrays = {name: t.float().cpu().numpy() for name, t in _flatten(aux)}
    np.savez(path, **arrays)
    return sorted(arrays)


@dataclasses.dataclass
class ForecastResult:
    wape: float
    mae: float
    num_forecasts: int  # masked forecast ROWS (not rows x horizon values)
    forecasts_per_sec: Optional[float] = None
    forecasts_per_sec_per_chip: Optional[float] = None  # one card: the same
    gflops_per_sample: Optional[float] = None
    # Peak allocated device bytes over one batch's forward (the H100's
    # memory is HBM too); not XLA's buffer assignment (eval/profiler.py).
    peak_hbm_bytes: Optional[int] = None
    split_seconds: Optional[float] = None  # host clock of the scoring pass
    forecasts_per_sec_windows: Optional[List[float]] = None
    forwards: int = 0  # model forwards score_split ran (probes and timing included)
    one_pass: bool = False

    def summary(self) -> str:
        parts = [f"WAPE: {self.wape:.3f}", f"MAE: {self.mae:.3f}"]
        if self.forecasts_per_sec_per_chip:
            parts.append(f"{self.forecasts_per_sec_per_chip:,.0f} forecasts/s/chip")
        if self.gflops_per_sample:
            parts.append(f"{self.gflops_per_sample:.3f} GFLOPs/sample")
        if self.peak_hbm_bytes:
            parts.append(f"peak HBM {self.peak_hbm_bytes / 2**30:.2f} GiB/batch")
        return ", ".join(parts)


def _timed_window_s(model, batches, device) -> float:
    """Seconds per forward over ``batches``: CUDA events on the card, the
    host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for b in batches:
            model(b)
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3 / len(batches)
    t0 = time.perf_counter()
    for b in batches:
        model(b)
    return (time.perf_counter() - t0) / len(batches)


def score_split(model, loader, *, mesh=None, norm_scalar: float = 53.0,
                measure_throughput: bool = True, timing_iters: int = 10,
                one_pass: Optional[bool] = None) -> ForecastResult:
    """Score a test split with ``model`` on its own device (see the module
    docstring)."""
    device = _model_device(model)
    mesh = mesh if mesh is not None else mesh_lib.make_mesh(device_type=device.type)
    with torch.inference_mode(), sharding.gathered(model), collectives.data_parallel(mesh):
        return _score(model, loader, mesh, device, norm_scalar, measure_throughput,
                      timing_iters, one_pass)


def _score(model, loader, mesh, device, norm_scalar, measure_throughput, timing_iters,
           one_pass) -> ForecastResult:
    world = mesh_lib.batch_rank_world(mesh)[1]
    chips = world * mesh_lib.model_size(mesh)
    first = next(iter(loader), None)
    if first is None:
        raise ValueError("score_split got a loader with zero batches — the split is empty")
    if one_pass is None:
        est = sum(v.nbytes for v in first.values()) * len(loader)
        one_pass = est <= one_pass_budget_bytes(device)
    forwards = 0

    def forward(batch):
        nonlocal forwards
        forwards += 1
        return model(batch)

    with torch.inference_mode():
        # Probes first, with only the weights and this batch on the device.
        b0 = to_device(first, device)
        bs = int(b0["mask"].shape[0])
        gflops = batch_flops(forward, b0) / bs / 1e9
        peak = peak_memory_bytes(forward, b0)
        del b0, first

        def step(sums, batch):
            forecast, _ = forward(batch)
            target, pred = target_and_pred(batch, forecast)
            part = eval_metrics(target, pred, expand_mask(batch, target),
                                norm_scalar=norm_scalar)
            return sums + torch.stack([part[k] for k in SUM_KEYS]).double()

        sums = torch.zeros(len(SUM_KEYS), dtype=torch.float64, device=device)
        t0 = time.perf_counter()
        if one_pass:
            batches = [to_device(b, device) for b in loader]
            for batch in batches:
                sums = step(sums, batch)
        else:
            batches = []
            for batch in loader:
                batch = to_device(batch, device)
                if len(batches) < timing_iters:
                    # Only what the throughput probe needs: keeping every
                    # batch would hold the whole split, which this path avoids.
                    batches.append(batch)
                sums = step(sums, batch)
        if mesh_lib.is_distributed(mesh):
            sum_eval_sums(sums, mesh)
        totals = dict(zip(SUM_KEYS, sums.tolist()))  # the one host sync
        split_s = time.perf_counter() - t0
        fin = finalize_metrics(totals)
        del batches[timing_iters:]

        fps = windows = None
        if measure_throughput:
            def rolled(offset):
                # Distinct inputs at every step: batch (offset + i) rolled by
                # offset + i rows.
                return [{k: torch.roll(v, offset + i, 0) for k, v in
                         batches[(offset + i) % len(batches)].items()}
                        for i in range(timing_iters)]

            for b in rolled(0):  # warm-up
                forward(b)
            timed = rolled(1)
            per_forward = [_timed_window_s(forward, timed, device)
                           for _ in range(TIMING_WINDOWS)]
            windows = [world * bs / s for s in per_forward]
            fps = world * bs / statistics.median(per_forward)

    return ForecastResult(
        wape=fin["wape"], mae=fin["mae"], num_forecasts=int(totals["rows"]),
        forecasts_per_sec=fps, forecasts_per_sec_per_chip=fps and fps / chips,
        gflops_per_sample=gflops, peak_hbm_bytes=peak, split_seconds=split_s,
        forecasts_per_sec_windows=windows, forwards=forwards, one_pass=bool(one_pass))
