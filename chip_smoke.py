#!/usr/bin/env python3
"""Card check of the PyTorch port (``visuelle2_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``visuelle2_tpu_torch/csrc`` (one nvcc
per source, all started together, sm_90a, into ``build/visuelle2_tpu_torch/``),
then, each phase printing one JSON line and any failure exiting non-zero:

1. device       — the card, its power limit, the kernel library's build time;
2. kernel       — ``fused_gated_residual`` against its plain PyTorch version
   (TF32 off, atol 1e-5) at the main-path and ragged shapes;
3. mha_kernel   — ``fused_gated_mha`` against its plain version (TF32 off,
   atol 2e-5, rtol 1e-5), both variants, gcd-masked and unmasked, at the
   gated_v2 shapes (B=128, D=64, 4 heads; 52/52 head, 1/52 and 12/52 pure)
   and at a ragged one (B=37, D=48);
4. forward      — the full-width gated_v4 demand forecaster (ResNet-101 at
   299², bf16 backbone, E=32, H=64, B=128, random weights from a seeded
   generator) through ``make_forecaster``: finite [128, 12] forecasts, two
   ``fused_gated_residual`` launches per forward, the kernel held to its
   plain version on the fusion inputs of the real forward, and the port on
   the card held to the port on the CPU in f32 at a small width;
5. serve        — the port's HTTP server answers concurrent requests,
   coalesces them, and each answer matches a direct forward of the same rows;
6. times        — gated_v4's forward time per batch by CUDA events over
   distinct batches (the median of five windows, each window reported), its
   device busy time, its split by operator and its top kernels from
   ``torch.profiler``, its FLOPs and the convolutions' rate, the serving
   callable's latency, peak device memory;
7. kernel_times — ``fused_gated_residual``'s and its plain version's device
   time per call (profiler), time per call as seen from Python (CUDA
   events), and the kernel's bound from its shapes;
8. forward_v2   — the full-width gated_v2 forecaster, as in 4: exactly three
   ``fused_gated_mha`` launches per forward (two trend-encoder layers, one
   decoder cross-attention), the kernel held to its plain version on the
   attention inputs of the real forward, and a small gated_v2 on the card
   held to the same model on the CPU in f32;
9. times_v2     — gated_v2's forward times as in 6;
10. mha_kernel_times — per variant at the main-path shape, the kernel's and
   the plain version's device time per launch and time per call, and the
   bound;
11. additive_kernel — ``fused_additive_attention`` (a 3xTF32 tensor-core
   GEMM launch and an energy/softmax/scaling launch per call) against its
   plain version (TF32 off, atol 2e-5, rtol 1e-5 on the output and α), both
   ``weight_on``, at the three CrossAttnRNN Demand shapes (B=128,
   De=Dd=A=512, L = 100 image patches, 52 trend steps, 4 fused tokens), a
   ragged one (B=37, L=13, De=48, Dd=40, A=24) and L=2; at each, the kernels
   a call launches (at most 2) and, at the Demand shapes, each launch's
   device µs and their sum;
12. gru_kernel — ``fused_gru_sequence`` (one persistent launch per call)
   against its plain step loop and cuDNN's ``torch.nn.GRU`` at the trend
   GRU's shape (B=128, T=52, I=3, H=512; atol 1e-4), at ragged small ones
   (B and H not multiples of the 32-row tile and the 16-unit slice; atol
   2e-5) and at ten row tiles on four row groups (B=300, H=512; atol 1e-4);
   at each, a second call on the same inputs gives the same bits (the sums
   take no atomics: a difference is a race in the step barrier);
12b. gru_wide — the GRU kernel's streamed layout (W_h and h through
   shared memory in k-chunks, past the resident layout's H = 724) at H =
   725, 1,024, 1,664 and 2,112 (the limit on an H100: a unit slice on each
   of its 132 SMs; B=128, T=8, I=64) against its plain version (atol
   1e-4), one launch a call, the same bits twice; the recurrence's device µs
   at H = 1,024 beside ``torch.nn.GRU``'s and the bound;
13. forward_demand — the full-width CrossAttnRNN Demand forecaster
   (ResNet-101 at 299², bf16 backbone, E=A=H=512, B=128, random weights from
   a seeded generator) through ``make_forecaster``: finite [128, 12, 1]
   forecasts, exactly 36 ``fused_additive_attention`` launches per forward
   (3 per decode step), the kernel within half its tolerance of its plain
   version on the attention inputs of the real forward, and of a second
   forward with weights and batch from another seed, and a small Demand on
   the card held to the same model on the CPU in f32;
14. forward_demand_gru — the same forecaster with its trend GRU on the
   kernel path (``GRU.use_kernel``, the port of the JAX ``use_pallas``):
   one ``fused_gru_sequence`` launch per forward, forecasts against the
   step-loop path's, and the forward time of both paths in turns;
15. forward_rnn_21_210 — CrossAttnRNN 2-1 and 2-10 (``out_len`` 10) at a
   small width on the card (tiny backbone) against the CPU in f32: 3 and 30
   launches per forward;
16. times_demand — Demand's forward times as in 6;
17. additive_kernel_times — per Demand call (L = 100, 52, 4), the kernel's
   and the plain version's device time per call, the kernel's per launch,
   launches per call and per forward, and the bounds (float32-accurate:
   the lesser of float32 FMAs and 3xTF32 products; and float32 FMAs alone);
18. gru_kernel_times — at the trend GRU's shape, the device time per call
   and time per call of the kernel path (input GEMM and the one recurrence
   launch), the recurrence kernel's own device time, of its plain version
   and of ``torch.nn.GRU``, and the bound;
19. probe_kernels — the conv-floor probe's three kernels (``matmul_bf16``,
   ``matmul_int8``, ``read_reduce``) against their plain versions: the JAX
   parity check's size and seed (``perf.convfloor.parity_check``), both
   full probe shapes (A = 720896 x 256 -> 64, B = 184320 x 512 -> 128) and
   a ragged one; int8 bit for bit equal to plain and ``torch._int_mm``,
   bf16 within one bf16 ulp beyond the f32 sums' reordering bound, the
   read probe's full-K partials within atol 1e-4 + rtol 1e-5 (every column
   of x read) and its bias reaching every partial; one launch per call;
20. convfloor_times — the roofline harness's probe (``perf.convfloor.
   measure_shape``, the path that runs these kernels) at both shapes: the
   five measurements and ``torch.sum``'s as µs, TFLOP/s and GB/s (replays
   of a CUDA graph of calls), the plain versions' µs (CUDA events), the
   profiler's device µs per kernel record, and the bounds;
21. conv_roofline — the harness's square bf16 GEMM controls, the 24
   ResNet-101 conv shapes at B=128 in bf16 with their FLOP-weighted sum
   beside the ``aten::cudnn_convolution`` ms of phase 6's gated_v4 forward,
   the artifact check, and the epilogue and chain ratios.

Then the ``kernels`` line (seven kernels), the ``nvidia-smi`` line and,
last, the ``ok`` line.  Without a CUDA device it exits non-zero before
printing any result.
"""

from __future__ import annotations

import io
import itertools
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.utils.flop_counter import FlopCounterMode

B = 128          # export batch of the main path
IMAGE = 299
KERNEL_ATOL = 1e-5   # gated residual vs plain: both f32, sums in another order
# Gated MHA vs plain: the tolerance tests/test_pallas_kernels.py holds the
# Pallas kernel to (softmax and five chained products, sums in another order).
MHA_ATOL, MHA_RTOL = 2e-5, 1e-5
F32_ATOL = 1e-4      # port on the card vs on the CPU in f32, as the CPU tests
# Served rows vs a direct forward of just those rows: the bf16 backbone runs
# at another batch size there, where cuDNN may pick other algorithms that
# round differently; bf16 keeps about 3 significant digits.
SERVE_RTOL = 5e-2
N_FWD = 3                   # forwards of each main-path run
# GRU kernel vs plain and cuDNN at the trend GRU's full width: 52 serial steps,
# each a 512-long f32 sum in another order, carry the rounding of every step
# into the next; 1e-4 is the whole-model f32 tolerance of the CPU tests, and
# the measured maximum is printed beside it.
GRU_ATOL_FULL, GRU_ATOL_SMALL = 1e-4, 2e-5
# The read probe's partials: 256 bf16 values summed in f32 in another order.
READ_ATOL, READ_RTOL = 1e-4, 1e-5
GRU_KERNEL_NAME = "gru_persistent_f32_kernel"  # csrc/gru_seq.cu, as the profiler names it
# csrc/additive_attention.cu: the grouped 3xTF32 GEMM, then the energies,
# softmax and scaling.
ADDITIVE_KERNEL_NAMES = ("gemm_3xtf32_kernel", "attend_kernel")
ADDITIVE_MAX_LAUNCHES = 2
# The streamed layout's widths (B=128, T=8, I=64), up to the limit on an H100
# SXM: one 16-unit slice on each of its 132 SMs.
GRU_WIDE = (725, 1024, 1664, 2112)
# The additive attention kernel's tensor-core sums lose more than float32
# FMAs: on a Demand forward's own inputs it must stay within half its
# tolerance, at two seeds of weights and batches.
DEMAND_ATTN_MAX_SHARE = 0.5
BF16_GEMM_TOL = "one bf16 ulp (rtol 2^-7) + 2*K*2^-24*(|x|.|w|), the f32 reordering bound"
HARNESS_TARGET_S = 0.2   # device seconds per harness measurement
CROSS_ATTN_DIMS = dict(attention_dim=512, embedding_dim=512, hidden_dim=512)


def _require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _synthetic_batch(n, image_size, seed):
    rng = np.random.default_rng(seed)
    return {
        "ts": rng.random((n, 12)).astype(np.float32),
        "cat": rng.integers(0, 5, n).astype(np.int32),
        "col": rng.integers(0, 6, n).astype(np.int32),
        "fab": rng.integers(0, 5, n).astype(np.int32),
        "store": rng.integers(0, 126, n).astype(np.int32),
        "temporal": rng.random((n, 4)).astype(np.float32),
        "gtrends": rng.random((n, 3, 52)).astype(np.float32),
        "images": rng.integers(0, 255, (n, image_size, image_size, 3)).astype(np.uint8),
        "mask": np.ones((n,), np.float32),
    }


def _to_device(batch, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _cuda_ms(fn, iters):
    """Mean time per call of ``fn()`` over ``iters`` calls, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _device_us(prof):
    """Kernel time (µs) in a profile, summed as its key_averages table does."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation)


def _gate_inputs(model, img, text, dummy):
    """The two fused-gated-residual calls of a TG-Fusion forward, as
    (x, ctx, Wx, Wc, b) tuples in the order the forward makes them."""
    fusion = model.fusion
    ctx = text.reshape(text.shape[0], -1)
    C = ctx.shape[1]
    calls = []
    for x, gate in ((dummy, fusion.dummy_gate_fc), (img, fusion.img_gate_fc)):
        calls.append((x, ctx, gate.kernel[C:], gate.kernel[:C], gate.bias))
    return calls


def _gated_mha_modules(model):
    """gated_v2's three gated-MHA modules, in the order a forward calls them."""
    enc = model.gtrend_encoder.encoder
    return [enc.layer0.self_attn, enc.layer1.self_attn, model.decoder.layer0.cross_attn]


def _call_times(fns, n_calls):
    """Device ms per call (profiler) and ms per call from Python (CUDA
    events) of each zero-argument callable in ``fns``.  The profiler can drop
    records in a window, so a call's device time is, over the kernels it
    launches, each kernel's µs per record times its records per call; a
    window whose record counts are not whole multiples of ``n_calls`` is
    taken again, up to three times."""
    for f in fns.values():
        f()
    call_ms = {name: _cuda_ms(f, n_calls) for name, f in fns.items()}
    device_ms = {}
    for name, f in fns.items():
        for _ in range(3):
            with _profile() as prof:
                for _ in range(n_calls):
                    f()
                torch.cuda.synchronize()
            records = [(e.count, e.self_device_time_total) for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                       and e.count]
            device_ms[name] = sum(max(1, round(n / n_calls)) * us / n
                                  for n, us in records) / 1e3
            if records and all(n % n_calls == 0 for n, _ in records):
                break
    _require(min(device_ms.values()) > 0, f"profiler saw no device time: {device_ms}")
    return device_ms, call_ms


def _profiled_kernels_us(fn):
    """The profiler's device µs per record of each kernel ``fn`` launches
    (name -> [records, µs per record]) over 20 calls; a window in which the
    profiler kept no kernel record is taken again, up to three times."""
    fn()
    for _ in range(3):
        with _profile() as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        records = {e.key[:60]: [e.count, e.self_device_time_total / e.count]
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation and e.count}
        if records:
            return records
    raise RuntimeError("chip_smoke: the profiler kept no kernel record in three windows")


def _kernels_per_call(per_kernel, n_calls=20):
    """Kernel launches a call from ``_profiled_kernels_us``: the kernel names
    seen, or the records a call where the profiler kept more."""
    return max(len(per_kernel), round(sum(n for n, _ in per_kernel.values()) / n_calls))


def _launch_split_us(per_kernel):
    """Each kernel's device µs per record, and their sum: a call's device µs
    where each kernel launches once a call."""
    split = {name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]: us
             for name, (_, us) in per_kernel.items()}
    return {**split, "total": sum(split.values())}


def _kernel_vs_plain_times(kernel, plain, args, kwargs, n_calls=500):
    """``_call_times`` of a kernel and its plain version on the same inputs."""
    return _call_times({"kernel": lambda: kernel(*args, **kwargs),
                        "plain": lambda: plain(*args, **kwargs)}, n_calls)


def _forward_times(model, fn, host_batches, dev, seed, kernel_groups=None):
    """Forward time at B=128 (median of five CUDA-event windows over eight
    distinct batches), device busy time and idle share, the split by
    operator and the top kernels, FLOPs, serving-callable latency and peak
    device memory; ``kernel_groups`` (name -> kernel-name substrings) adds
    the device ms per forward of each group of kernels."""
    fn_s = []
    for hb in host_batches:  # warm: the callable already ran
        t0 = time.perf_counter()
        fn(hb)
        fn_s.append(time.perf_counter() - t0)
    dev_batches = [_to_device(_synthetic_batch(B, IMAGE, seed=seed + i), dev)
                   for i in range(8)]
    with torch.inference_mode():
        for b in dev_batches[:2]:
            model(b)
        cycle = itertools.cycle(dev_batches)
        # Five windows of eight distinct batches each: their spread says how
        # far one run's forward time can be trusted.
        fwd_windows = [_cuda_ms(lambda: model(next(cycle)), len(dev_batches))
                       for _ in range(5)]
        fwd_ms = float(np.median(fwd_windows))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model(dev_batches[0])
        torch.cuda.synchronize()
        peak_bytes = torch.cuda.max_memory_allocated()
        with _profile() as prof:
            for b in dev_batches[:2]:
                model(b)
            torch.cuda.synchronize()
        fwd_device_ms = _device_us(prof) / 2e3
        with FlopCounterMode(display=False) as flops:
            model(dev_batches[1])
    by_aten = {str(op): n for op, n in flops.get_flop_counts()["Global"].items()}
    conv_flops = sum(n for op, n in by_aten.items() if "convolution" in op)
    all_ops = {e.key: e.self_device_time_total / 2e3 for e in prof.key_averages()
               if e.device_type == DeviceType.CPU and e.self_device_time_total > 0}
    by_op = sorted(all_ops.items(), key=lambda kv: -kv[1])[:10]
    by_kernel = sorted(([e.key[:100], e.self_device_time_total / 2e3, e.count // 2]
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA and not e.is_user_annotation),
                       key=lambda kv: -kv[1])[:8]
    by_group = {name: sum(e.self_device_time_total for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA
                          and any(k in e.key for k in keys)) / 2e3
                for name, keys in (kernel_groups or {}).items()}
    return {"batch": B, "forward_ms": fwd_ms, "forward_ms_windows": fwd_windows,
            "forward_device_ms_by_kernel_group": by_group,
            "forecasts_per_s": B / (fwd_ms / 1e3),
            "forward_device_busy_ms": fwd_device_ms,
            "device_idle_share": max(0.0, 1.0 - fwd_device_ms / fwd_ms),
            "forward_device_ms_by_op": dict(by_op),
            "forward_top_kernels_ms_launches": by_kernel,
            "forward_flops": flops.get_total_flops(), "conv_flops": conv_flops,
            "conv_tflops_per_s": conv_flops / 1e9 / all_ops["aten::cudnn_convolution"],
            "serving_fn_ms_incl_copies": sorted(1e3 * t for t in fn_s),
            "max_memory_allocated_bytes": peak_bytes}


def _card_vs_cpu(name, dev, batch=None, **dims):
    """A small f32 model (tiny backbone) on the card vs the same weights on
    the CPU: max abs difference of the forecasts."""
    from visuelle2_tpu_torch.models import VocabSizes, build

    small = build(name, device=dev, generator=torch.Generator().manual_seed(2),
                  image_arch="tiny", vocab=VocabSizes(5, 6, 5, 126), **dims)
    small_cpu = build(name, device="cpu", image_arch="tiny", vocab=VocabSizes(5, 6, 5, 126),
                      **dims)
    small_cpu.load_state_dict({k: v.cpu() for k, v in small.state_dict().items()})
    sb = _synthetic_batch(8, 64, seed=3) if batch is None else batch
    with torch.inference_mode():
        on_card = small(_to_device(sb, dev))[0].cpu()
        on_cpu = small_cpu(_to_device(sb, "cpu"))[0]
    return (on_card - on_cpu).abs().max().item()


def _mha_err(got, want):
    """Max abs error, and whether every element is within atol + rtol·|want|."""
    diff = (got - want).abs()
    ok = bool((diff <= MHA_ATOL + MHA_RTOL * want.abs()).all().item())
    return diff.max().item(), ok


def _additive_err(got, want):
    """``_mha_err`` over the (output, α) pair."""
    (e_out, ok_out), (e_alpha, ok_alpha) = (_mha_err(g, w) for g, w in zip(got, want))
    return max(e_out, e_alpha), ok_out and ok_alpha


def _tolerance_share(got, want):
    """The most of |got - want| / (atol + rtol·|want|) over the (output, α)
    pair: the worst element's share of its tolerance (over 1: outside)."""
    return max(((g - w).abs() / (MHA_ATOL + MHA_RTOL * w.abs())).max().item()
               for g, w in zip(got, want))


def _demand_attention_check(mods, calls, additive, additive_plain):
    """The additive attention kernel against its plain version on a Demand
    forward's own attention inputs, one entry per call length L: max abs
    error, the worst element's share of the tolerance, and |enc| and |out|
    at most.  Fails past ``DEMAND_ATTN_MAX_SHARE`` of the tolerance."""
    errs, shares, absmax = {}, {}, {}
    with torch.inference_mode():
        for mod, args in zip(mods, calls):
            got = additive(*args, weight_on=mod.weight_on)
            want = additive_plain(*args, weight_on=mod.weight_on)
            key = f"L={args[0].shape[1]}"
            errs[key], _ = _additive_err(got, want)
            shares[key] = _tolerance_share(got, want)
            absmax[key] = {"enc": args[0].abs().max().item(), "out": want[0].abs().max().item()}
    _require(max(shares.values()) <= DEMAND_ATTN_MAX_SHARE,
             f"additive attention vs plain on Demand forward inputs: {errs}, share of the "
             f"tolerance {shares} (at most {DEMAND_ATTN_MAX_SHARE}), |x| max {absmax}")
    return {"max_abs_err": errs, "tolerance_share": shares, "abs_max": absmax}


def _stfore_batch(n, image_size, seed, windows=2):
    """A windowed SO-fore batch: sales lags ``X [n, windows, 2]``."""
    b = _synthetic_batch(n, image_size, seed)
    del b["ts"]
    b["X"] = np.random.default_rng(seed).random((n, windows, 2)).astype(np.float32)
    return b


def _attention_modules(model):
    """The CrossAttnRNN decoder's additive attentions, in call order."""
    fusion = model.decoder.fusion
    return [m for m in (fusion.img_attention, fusion.ts_attention,
                        fusion.multimodal_attention) if m is not None]


def _probe_kernel_checks(dev):
    """Phase 19: the probe kernels against their plain versions (and the
    int8 one against ``torch._int_mm``), one launch per call."""
    from visuelle2_tpu_torch.ops.cuda.probe_gemm import (
        bf16_tolerance,
        matmul_bf16,
        matmul_bf16_plain,
        matmul_int8,
        matmul_int8_plain,
    )
    from visuelle2_tpu_torch.ops.cuda.read_reduce import read_reduce, read_reduce_plain
    from visuelle2_tpu_torch.perf import convfloor

    parity = convfloor.parity_check(dev)
    errs = {"bf16": parity["bf16_max_abs_err"], "int8": 0, "read": parity["read_max_abs_err"]}
    by_shape = {"jax_parity_4096x256x64": parity}
    gemm_shapes = dict(convfloor.SHAPES, ragged_10000x128x256=dict(m=10000, k=128, n=256))
    read_shapes = dict(convfloor.SHAPES, other_6144x384=dict(m=6144, k=384, n=64))
    for name, s in gemm_shapes.items():
        xb, wb, xi, wi, _ = convfloor.probe_inputs(device=dev, **s)
        counts = matmul_bf16.launches, matmul_int8.launches
        got, got_i = matmul_bf16(xb, wb), matmul_int8(xi, wi)
        torch.cuda.synchronize()
        _require((matmul_bf16.launches, matmul_int8.launches) == (counts[0] + 1, counts[1] + 1),
                 f"{name}: launch counts did not move by one")
        want = matmul_bf16_plain(xb, wb)
        diff = (got.float() - want.float()).abs()
        _require(bool((diff <= bf16_tolerance(xb, wb, want)).all()),
                 f"{name}: bf16 probe GEMM off by {diff.max().item()}")
        int8_plain = torch.equal(got_i, matmul_int8_plain(xi, wi))
        int8_int_mm = torch.equal(got_i, torch._int_mm(xi, wi))
        _require(int8_plain and int8_int_mm,
                 f"{name}: int8 probe GEMM not exact (plain {int8_plain}, _int_mm {int8_int_mm})")
        errs["bf16"] = max(errs["bf16"], diff.max().item())
        by_shape[name] = {"bf16_max_abs_err": diff.max().item(),
                          "int8_equal_plain": int8_plain, "int8_equal_int_mm": int8_int_mm}
        del xb, wb, xi, wi, got, got_i, want, diff
    for name, s in read_shapes.items():
        xb, _, _, _, _ = convfloor.probe_inputs(device=dev, **s)
        bias = torch.randn(8, 128, device=dev)
        before = read_reduce.launches
        full = read_reduce(xb, bias, full_k=True)
        torch.cuda.synchronize()
        _require(read_reduce.launches == before + 1, f"{name}: read launch count")
        want = read_reduce_plain(xb, bias, full_k=True)
        diff = (full - want).abs()
        _require(bool((diff <= READ_ATOL + READ_RTOL * want.abs()).all()),
                 f"{name}: read partials off by {diff.max().item()}")
        past_128 = diff[:, 128:].max().item()
        shift = (read_reduce(xb, bias) - read_reduce(xb, torch.zeros_like(bias))
                 - bias.repeat(s["m"] // convfloor.TILE_M, 1)).abs().max().item()
        _require(shift <= 1e-5, f"{name}: bias shift off by {shift}")
        errs["read"] = max(errs["read"], diff.max().item())
        by_shape.setdefault(name, {}).update({
            "read_max_abs_err": diff.max().item(), "read_cols_past_128_max_abs_err": past_128,
            "read_cols": s["k"], "bias_shift_max_abs_err": shift})
        del xb, full, want, diff
    return {"max_abs_err": errs, "by_shape": by_shape}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this check runs on the GPU only")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from visuelle2_tpu_torch.eval.export import make_forecaster
    from visuelle2_tpu_torch.eval.server import drain_and_close, make_server
    from visuelle2_tpu_torch.models import VocabSizes, build
    from visuelle2_tpu_torch.ops.cuda import _build, gru_seq, roofline
    from visuelle2_tpu_torch.ops.cuda.additive_attention import (
        fused_additive_attention as additive,
        fused_additive_attention_plain as additive_plain,
    )
    from visuelle2_tpu_torch.ops.cuda.gated_fusion import (
        fused_gated_residual as kernel,
        fused_gated_residual_plain as plain,
    )
    from visuelle2_tpu_torch.ops.cuda.gated_mha import (
        fused_gated_mha as mha,
        fused_gated_mha_plain as mha_plain,
    )
    from visuelle2_tpu_torch.ops.cuda.gru_seq import (
        cudnn_gru,
        fused_gru_sequence as gru_kernel,
        fused_gru_sequence_plain as gru_plain,
    )
    from visuelle2_tpu_torch.ops.cuda.probe_gemm import (
        matmul_bf16,
        matmul_bf16_plain,
        matmul_int8,
        matmul_int8_plain,
    )
    from visuelle2_tpu_torch.ops.cuda.read_reduce import read_reduce, read_reduce_plain
    from visuelle2_tpu_torch.ops.masks import gcd_block_mask
    from visuelle2_tpu_torch.perf import convfloor, convfloor_v2
    from visuelle2_tpu_torch.perf import roofline as harness_roofline

    def zero_counts():
        kernel.launches = mha.launches = additive.launches = gru_kernel.launches = 0
        matmul_bf16.launches = matmul_int8.launches = read_reduce.launches = 0

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    card = {"card": smi}

    # 1. device ---------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    _emit({"phase": "device", **card, "device": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "kernel_build_s": time.perf_counter() - t0,
           "library": os.path.relpath(_build.library_path())})

    # 2. gated residual vs plain ---------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(1)
    errs = {}
    for Bk, D, C in ((B, 32, 128), (37, 48, 96), (3, 64, 512)):
        x, ctx = (torch.randn(Bk, n, device=dev, generator=gen) for n in (D, C))
        wx = torch.randn(D, D, device=dev, generator=gen) * 0.1
        wc = torch.randn(C, D, device=dev, generator=gen) * 0.1
        b = torch.randn(D, device=dev, generator=gen)
        for residual in (True, False):
            got = kernel(x, ctx, wx, wc, b, residual=residual)
            want = plain(x, ctx, wx, wc, b, residual=residual)
            torch.cuda.synchronize()
            errs[f"{Bk}x{D}x{C}/residual={residual}"] = (got - want).abs().max().item()
    _emit({"phase": "kernel", "max_abs_err": errs, "tol": KERNEL_ATOL})
    _require(max(errs.values()) <= KERNEL_ATOL, f"kernel disagrees with plain: {errs}")

    # 3. gated MHA vs plain --------------------------------------------------------
    mha_errs, mha_bad = {}, []
    for variant, (Bk, Lq, Lk, D), masked in (
            ("head", (B, 52, 52, 64), True), ("head", (B, 52, 52, 64), False),
            ("pure", (B, 1, 52, 64), False), ("pure", (B, 12, 52, 64), False),
            ("pure", (B, 52, 52, 64), True),
            ("head", (37, 52, 52, 48), True), ("pure", (37, 12, 52, 48), False),
            ("pure", (37, 52, 52, 48), True)):
        G = D // 4 if variant == "head" else D
        query = torch.randn(Bk, Lq, D, device=dev, generator=gen)
        kv = query if Lq == Lk else torch.randn(Bk, Lk, D, device=dev, generator=gen)
        mask = gcd_block_mask(Lq, 12, device=dev) if masked else torch.zeros(Lq, Lk, device=dev)
        weights = []
        for n in (D, D, D, G, D):
            weights += [torch.randn(n, n, device=dev, generator=gen) * n ** -0.5,
                        torch.randn(n, device=dev, generator=gen) * 0.1]
        args = (query, kv, kv, mask, *weights)
        got = mha(*args, num_heads=4, variant=variant)
        want = mha_plain(*args, num_heads=4, variant=variant)
        torch.cuda.synchronize()
        key = f"{variant}/{Bk}x{Lq}x{Lk}x{D}/{'gcd' if masked else 'unmasked'}"
        mha_errs[key], ok = _mha_err(got, want)
        if not ok:
            mha_bad.append(key)
    _emit({"phase": "mha_kernel", "max_abs_err": mha_errs, "atol": MHA_ATOL,
           "rtol": MHA_RTOL})
    _require(not mha_bad, f"gated MHA kernel disagrees with plain at {mha_bad}: {mha_errs}")

    # 4. full-width gated_v4 forward through the serving callable ------------------
    model = build("gated_v4", device=dev, generator=torch.Generator().manual_seed(0),
                  vocab=VocabSizes(5, 6, 5, 126), output_len=12,
                  image_arch="resnet101", image_dtype=torch.bfloat16)
    example = _synthetic_batch(B, IMAGE, seed=1)
    fn, header = make_forecaster(model, example, device=dev)
    captured = []
    hook = model.fusion.register_forward_pre_hook(
        lambda mod, args: captured.append(args) if not captured else None)
    host_batches = [_synthetic_batch(B, IMAGE, seed=10 + i) for i in range(N_FWD)]
    zero_counts()
    outs = [fn(hb) for hb in host_batches]
    launches, v4_mha_launches = kernel.launches, mha.launches
    hook.remove()
    for out in outs:
        _require(out.shape == (B, 12) and np.isfinite(out).all(),
                 f"forecast not finite [{B}, 12]: {out.shape}")
    _require(not np.array_equal(outs[0], outs[1]), "distinct batches gave equal forecasts")
    _require(launches == 2 * N_FWD, f"{launches} kernel launches in {N_FWD} forwards")
    _require(v4_mha_launches == 0, f"gated_v4 launched the gated MHA {v4_mha_launches}×")

    with torch.inference_mode():
        main_calls = _gate_inputs(model, *captured[0])
        fusion_err = 0.0
        for residual in (True, False):
            for call in main_calls:
                got, want = kernel(*call, residual=residual), plain(*call, residual=residual)
                fusion_err = max(fusion_err, (got - want).abs().max().item())
    _require(fusion_err <= KERNEL_ATOL, f"kernel vs plain on forward inputs: {fusion_err}")

    card_vs_cpu = _card_vs_cpu("gated_v4", dev)
    _emit({"phase": "forward", **card, "model": "gated_v4", "batch": B, "image": IMAGE,
           "forwards": N_FWD, "launches": launches, "launches_per_forward": launches / N_FWD,
           "forecast_absmax": float(np.abs(outs[0]).max()),
           "fusion_inputs_max_abs_err": fusion_err,
           "f32_card_vs_cpu_max_abs_err": card_vs_cpu, "f32_tol": F32_ATOL})
    _require(card_vs_cpu <= F32_ATOL, f"port on card vs CPU in f32: {card_vs_cpu}")

    # 5. serving -----------------------------------------------------------------
    srv = make_server(fn, header, port=0)
    serve_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    serve_thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    sizes = (1, 2, 3, 1, 2, 3)
    requests = [_synthetic_batch(n, IMAGE, seed=100 + i) for i, n in enumerate(sizes)]
    replies = [None] * len(sizes)
    go = threading.Barrier(len(sizes))

    def post(i):
        buf = io.BytesIO()
        np.savez(buf, **requests[i])
        req = urllib.request.Request(url + "/forecast", data=buf.getvalue(), method="POST")
        go.wait(timeout=60)
        with urllib.request.urlopen(req, timeout=300) as resp:
            with np.load(io.BytesIO(resp.read())) as z:
                replies[i] = z["forecast"]

    zero_counts()
    try:
        clients = [threading.Thread(target=post, args=(i,)) for i in range(len(sizes))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        _require(not any(c.is_alive() for c in clients), "a request did not finish")
        with urllib.request.urlopen(url + "/health", timeout=60) as resp:
            health = json.loads(resp.read())
    finally:
        srv.shutdown()
        drain_and_close(srv)
        serve_thread.join(timeout=30)
    serve_launches = kernel.launches
    serve_errs = []
    with torch.inference_mode():
        for req, reply in zip(requests, replies):
            _require(reply is not None and reply.shape == (len(req["ts"]), 12),
                     "missing or misshapen reply")
            direct = model(_to_device(req, dev))[0].float().cpu().numpy()
            serve_errs.append(float(np.abs(reply - direct).max()
                                    / max(1.0, np.abs(direct).max())))
    _emit({"phase": "serve", **card, "requests": health["requests"],
           "dispatches": health["dispatches"], "launches": serve_launches,
           "max_rel_err_vs_direct": max(serve_errs), "rtol": SERVE_RTOL})
    _require(health["requests"] == len(sizes), f"health: {health}")
    _require(health["dispatches"] < health["requests"], f"no coalescing: {health}")
    _require(serve_launches == 2 * health["dispatches"],
             f"{serve_launches} launches in {health['dispatches']} dispatches")
    _require(max(serve_errs) <= SERVE_RTOL, f"served vs direct: {serve_errs}")

    # 6.–7. gated_v4 times, fused_gated_residual times ----------------------------
    v4_times = _forward_times(model, fn, host_batches, dev, seed=200)
    _emit({"phase": "times", **card, "model": "gated_v4", **v4_times})
    x, ctx, wx, wc, b = main_calls[1]
    with torch.inference_mode():
        device_ms, call_ms = _kernel_vs_plain_times(kernel, plain, (x, ctx, wx, wc, b), {})
    k_ms, p_ms = device_ms["kernel"], device_ms["plain"]
    Bm, D = x.shape
    C = ctx.shape[1]
    k_bytes, k_flops = roofline.gated_residual_cost(Bm, D, C)
    bound_ms, bound_by = roofline.f32_accurate_bound_ms(k_bytes, k_flops)
    bound_simt_ms = roofline.bound_ms(k_bytes, k_flops)[0]
    _emit({"phase": "kernel_times", **card,
           "kernel_shape": {"B": Bm, "D": D, "C": C},
           "kernel_device_us": 1e3 * k_ms, "plain_device_us": 1e3 * p_ms,
           "kernel_call_us": 1e3 * call_ms["kernel"], "plain_call_us": 1e3 * call_ms["plain"],
           "kernel_bytes": k_bytes, "kernel_flops": k_flops, "bound_us": 1e3 * bound_ms,
           "bound_simt_f32_us": 1e3 * bound_simt_ms,
           "library_ms": "none: no single PyTorch call computes this function"})
    del model, fn

    # 8. full-width gated_v2 forward through the serving callable ------------------
    model = build("gated_v2", device=dev, generator=torch.Generator().manual_seed(0),
                  vocab=VocabSizes(5, 6, 5, 126), output_len=12,
                  image_arch="resnet101", image_dtype=torch.bfloat16)
    fn, _ = make_forecaster(model, example, device=dev)
    attn_mods = _gated_mha_modules(model)
    attn_calls = [None] * len(attn_mods)

    def capture(i):
        def hook(mod, args, kwargs):
            if attn_calls[i] is None:
                attn_calls[i] = mod.kernel_inputs(*args, mask=kwargs.get("mask"))
        return hook

    hooks = [m.register_forward_pre_hook(capture(i), with_kwargs=True)
             for i, m in enumerate(attn_mods)]
    zero_counts()
    outs = [fn(hb) for hb in host_batches]
    mha_launches, v2_residual_launches = mha.launches, kernel.launches
    for h in hooks:
        h.remove()
    for out in outs:
        _require(out.shape == (B, 12) and np.isfinite(out).all(),
                 f"gated_v2 forecast not finite [{B}, 12]: {out.shape}")
    _require(not np.array_equal(outs[0], outs[1]), "distinct batches gave equal forecasts")
    _require(mha_launches == 3 * N_FWD,
             f"{mha_launches} gated MHA launches in {N_FWD} gated_v2 forwards")
    _require(v2_residual_launches == 0,
             f"gated_v2 launched the gated residual {v2_residual_launches}×")
    variants = [m.variant for m in attn_mods]
    with torch.inference_mode():
        attn_errs = {}
        for i, (args, variant) in enumerate(zip(attn_calls, variants)):
            got = mha(*args, num_heads=attn_mods[i].num_heads, variant=variant)
            want = mha_plain(*args, num_heads=attn_mods[i].num_heads, variant=variant)
            attn_errs[f"call{i}/{variant}"], ok = _mha_err(got, want)
            _require(ok, f"gated MHA vs plain on forward inputs: {attn_errs}")
    v2_card_vs_cpu = _card_vs_cpu("gated_v2", dev)
    _emit({"phase": "forward_v2", **card, "model": "gated_v2", "batch": B, "image": IMAGE,
           "forwards": N_FWD, "launches": mha_launches,
           "launches_per_forward": mha_launches / N_FWD,
           "attention_shapes": [list(a[0].shape) + [a[1].shape[1]] for a in attn_calls],
           "forecast_absmax": float(np.abs(outs[0]).max()),
           "attention_inputs_max_abs_err": attn_errs,
           "f32_card_vs_cpu_max_abs_err": v2_card_vs_cpu, "f32_tol": F32_ATOL})
    _require(v2_card_vs_cpu <= F32_ATOL, f"gated_v2 on card vs CPU in f32: {v2_card_vs_cpu}")

    # 9.–10. gated_v2 times, fused_gated_mha times per variant ---------------------
    _emit({"phase": "times_v2", **card, "model": "gated_v2",
           **_forward_times(model, fn, host_batches, dev, seed=300)})
    per_variant = {}
    with torch.inference_mode():
        for i in (0, 2):  # trend-encoder layer 0 ("head"), decoder ("pure")
            args, variant = attn_calls[i], variants[i]
            kw = dict(num_heads=attn_mods[i].num_heads, variant=variant)
            device_ms, call_ms = _kernel_vs_plain_times(mha, mha_plain, args, kw)
            (Bm, Lq, D), Lk = args[0].shape, args[1].shape[1]
            _require(args[1] is args[2], "key and value are one tensor on the main path")
            n_bytes, flops = roofline.gated_mha_cost(
                Bm, Lq, Lk, D, **kw, self_attention=args[0] is args[1])
            v_bound_ms, v_bound_by = roofline.f32_accurate_bound_ms(n_bytes, flops)
            per_variant[variant] = {
                "shape": {"B": args[0].shape[0], "Lq": args[0].shape[1],
                          "Lk": args[1].shape[1], "D": args[0].shape[2], "heads": kw["num_heads"]},
                "launches_per_forward": variants.count(variant),
                "kernel_device_us": 1e3 * device_ms["kernel"],
                "plain_device_us": 1e3 * device_ms["plain"],
                "kernel_call_us": 1e3 * call_ms["kernel"],
                "plain_call_us": 1e3 * call_ms["plain"],
                "bytes": n_bytes, "flops": flops, "bound_us": 1e3 * v_bound_ms,
                "bound_by": v_bound_by,
                "bound_simt_f32_us": 1e3 * roofline.bound_ms(n_bytes, flops)[0]}
    _emit({"phase": "mha_kernel_times", **card, "variants": per_variant,
           "library_ms": "none: no single PyTorch call computes the gated epilogue"})
    # The kernels line gives one launch's numbers averaged over a forward's
    # mix of launches (two "head", one "pure").
    mix = lambda key: sum(v["launches_per_forward"] * v[key] for v in per_variant.values()) \
        / sum(v["launches_per_forward"] for v in per_variant.values()) / 1e3
    mix_bytes = sum(v["launches_per_forward"] * v["bytes"] for v in per_variant.values())
    mix_flops = sum(v["launches_per_forward"] * v["flops"] for v in per_variant.values())

    del model, fn

    # 11. additive attention vs plain -----------------------------------------------
    add_errs, add_bad, add_launch_us, add_kernels_per_call = {}, [], {}, {}
    for shape in ((B, 100, 512, 512, 512), (B, 52, 512, 512, 512), (B, 4, 512, 512, 512),
                  (37, 13, 48, 40, 24), (5, 2, 16, 20, 16)):
        Bk, L, De, Dd, A = shape
        args = (torch.randn(Bk, L, De, device=dev, generator=gen),
                torch.randn(Bk, Dd, device=dev, generator=gen),
                torch.randn(De, A, device=dev, generator=gen) * De ** -0.5,
                torch.randn(Dd, A, device=dev, generator=gen) * Dd ** -0.5,
                torch.randn(A, 1, device=dev, generator=gen) * A ** -0.5,
                torch.randn(1, device=dev, generator=gen))
        for weight_on in ("inputs", "projected"):
            got = additive(*args, weight_on=weight_on)
            want = additive_plain(*args, weight_on=weight_on)
            torch.cuda.synchronize()
            key = f"{Bk}x{L}x{De}x{Dd}x{A}/{weight_on}"
            add_errs[key], ok = _additive_err(got, want)
            if not ok:
                add_bad.append(key)
            per_kernel = _profiled_kernels_us(lambda: additive(*args, weight_on=weight_on))
            add_kernels_per_call[key] = _kernels_per_call(per_kernel)
            if Bk == B:
                add_launch_us[key] = _launch_split_us(per_kernel)
    _emit({"phase": "additive_kernel", **card, "max_abs_err": add_errs, "atol": MHA_ATOL,
           "rtol": MHA_RTOL, "kernels_per_call": add_kernels_per_call,
           "device_us_per_launch": add_launch_us})
    _require(not add_bad, f"additive attention disagrees with plain at {add_bad}: {add_errs}")
    _require(max(add_kernels_per_call.values()) <= ADDITIVE_MAX_LAUNCHES,
             f"additive attention launched more than {ADDITIVE_MAX_LAUNCHES} kernels a call: "
             f"{add_kernels_per_call}")

    # 12. GRU sequence vs plain and cuDNN ---------------------------------------------
    gru_errs = {}
    for (Bk, T, I, H), atol in (((B, 52, 3, 512), GRU_ATOL_FULL), ((37, 9, 5, 24), GRU_ATOL_SMALL),
                                ((150, 6, 4, 200), GRU_ATOL_SMALL),
                                ((300, 4, 3, 512), GRU_ATOL_FULL)):
        bound = H ** -0.5
        x = torch.rand(Bk, T, I, device=dev, generator=gen)
        w = [(torch.rand(*shape, device=dev, generator=gen) * 2 - 1) * bound
             for shape in ((I, 3 * H), (H, 3 * H), (3 * H,), (3 * H,))]
        h0 = torch.randn(Bk, H, device=dev, generator=gen) * 0.5
        outs, h_last = gru_kernel(x, *w, h0)
        again, again_h = gru_kernel(x, *w, h0)
        want, want_h = gru_plain(x, *w, h0)
        library = cudnn_gru(*w)
        with torch.inference_mode():
            lib, lib_h = library(x, h0[None])
        torch.cuda.synchronize()
        key = f"{Bk}x{T}x{I}x{H}"
        gru_errs[key] = {
            "vs_plain": max((outs - want).abs().max().item(),
                            (h_last - want_h).abs().max().item()),
            "vs_cudnn": max((outs - lib).abs().max().item(),
                            (h_last - lib_h[0]).abs().max().item()),
            "atol": atol,
            "second_call_bit_identical": torch.equal(outs, again) and torch.equal(h_last, again_h)}
        _require(max(gru_errs[key]["vs_plain"], gru_errs[key]["vs_cudnn"]) <= atol,
                 f"GRU kernel disagrees at {key}: {gru_errs[key]}")
        _require(gru_errs[key]["second_call_bit_identical"],
                 f"GRU kernel: two calls on the same inputs differ at {key}")
    _emit({"phase": "gru_kernel", "max_abs_err": gru_errs})

    # 12b. the GRU kernel's streamed layout, past H = 724 ---------------------------
    wide_errs, wide_us = {}, {}
    for H in GRU_WIDE:
        Bk, T, I = B, 8, 64
        x = torch.rand(Bk, T, I, device=dev, generator=gen)
        w = [(torch.rand(*shape, device=dev, generator=gen) * 2 - 1) * H ** -0.5
             for shape in ((I, 3 * H), (H, 3 * H), (3 * H,), (3 * H,))]
        h0 = torch.randn(Bk, H, device=dev, generator=gen) * 0.5
        before = gru_kernel.launches
        outs, h_last = gru_kernel(x, *w, h0)
        again, again_h = gru_kernel(x, *w, h0)
        want, want_h = gru_plain(x, *w, h0)
        torch.cuda.synchronize()
        key = f"{Bk}x{T}x{I}x{H}"
        wide_errs[key] = {
            "vs_plain": max((outs - want).abs().max().item(),
                            (h_last - want_h).abs().max().item()),
            "launches_per_call": (gru_kernel.launches - before) / 2,
            "second_call_bit_identical": torch.equal(outs, again) and torch.equal(h_last, again_h)}
        _require(wide_errs[key]["vs_plain"] <= GRU_ATOL_FULL and
                 wide_errs[key]["second_call_bit_identical"] and
                 wide_errs[key]["launches_per_call"] == 1,
                 f"GRU kernel's streamed layout at {key}: {wide_errs[key]}")
        if H == 1024:
            library = cudnn_gru(*w)
            with torch.inference_mode():
                per_kernel = _profiled_kernels_us(lambda: gru_kernel(x, *w, h0))
                lib_device_ms, _ = _call_times({"library": lambda: library(x, h0[None])},
                                               n_calls=50)
            recurrence = [us for name, (_, us) in per_kernel.items() if GRU_KERNEL_NAME in name]
            _require(recurrence, f"the profiler saw no {GRU_KERNEL_NAME} kernel at {key}")
            cost = roofline.gru_sequence_cost(Bk, T, H)
            wide_us = {"shape": key, "recurrence_device_us": recurrence[0],
                       "library_device_us": 1e3 * lib_device_ms["library"],
                       "bound_us": 1e3 * roofline.f32_accurate_bound_ms(*cost)[0],
                       "bound_simt_f32_us": 1e3 * roofline.bound_ms(*cost)[0]}
    _emit({"phase": "gru_wide", **card, "max_abs_err": wide_errs, "atol": GRU_ATOL_FULL,
           "times": wide_us})

    # 13. full-width CrossAttnRNN Demand through the serving callable --------------
    model = build("cross_attn_rnn_demand", device=dev, generator=torch.Generator().manual_seed(0),
                  vocab=VocabSizes(5, 6, 5, 126), out_len=12, image_arch="resnet101",
                  image_dtype=torch.bfloat16, **CROSS_ATTN_DIMS)
    fn, _ = make_forecaster(model, example, device=dev)
    add_mods = _attention_modules(model)
    add_calls = [None] * len(add_mods)

    def capture_last(i):
        def hook(mod, args):
            add_calls[i] = mod.kernel_inputs(*args)  # the last decode step's inputs
        return hook

    hooks = [m.register_forward_pre_hook(capture_last(i)) for i, m in enumerate(add_mods)]
    zero_counts()
    outs = [fn(hb) for hb in host_batches]
    add_launches, demand_gru_launches = additive.launches, gru_kernel.launches
    other_launches = kernel.launches + mha.launches
    for h in hooks:
        h.remove()
    for out in outs:
        _require(out.shape == (B, 12, 1) and np.isfinite(out).all(),
                 f"Demand forecast not finite [{B}, 12, 1]: {out.shape}")
    _require(not np.array_equal(outs[0], outs[1]), "distinct batches gave equal forecasts")
    _require(add_launches == 36 * N_FWD,
             f"{add_launches} additive attention launches in {N_FWD} Demand forwards")
    _require(demand_gru_launches == 0 and other_launches == 0,
             f"Demand launched other kernels: GRU {demand_gru_launches}, {other_launches}")
    demand_attn = {"seed 0": _demand_attention_check(add_mods, add_calls, additive,
                                                     additive_plain)}
    # The same check on a second Demand, its weights and batch from another seed.
    other = build("cross_attn_rnn_demand", device=dev,
                  generator=torch.Generator().manual_seed(1), vocab=VocabSizes(5, 6, 5, 126),
                  out_len=12, image_arch="resnet101", image_dtype=torch.bfloat16,
                  **CROSS_ATTN_DIMS)
    other_mods = _attention_modules(other)
    other_calls = [None] * len(other_mods)

    def capture_other(i):
        def hook(mod, args):
            other_calls[i] = mod.kernel_inputs(*args)
        return hook

    hooks = [m.register_forward_pre_hook(capture_other(i)) for i, m in enumerate(other_mods)]
    with torch.inference_mode():
        other(_to_device(_synthetic_batch(B, IMAGE, seed=21), dev))
    for h in hooks:
        h.remove()
    demand_attn["seed 1"] = _demand_attention_check(other_mods, other_calls, additive,
                                                    additive_plain)
    del other, other_mods, other_calls
    demand_card_vs_cpu = _card_vs_cpu("cross_attn_rnn_demand", dev, attention_dim=64,
                                      embedding_dim=64, hidden_dim=64)
    _emit({"phase": "forward_demand", **card, "model": "cross_attn_rnn_demand", "batch": B,
           "image": IMAGE, **CROSS_ATTN_DIMS, "forwards": N_FWD, "launches": add_launches,
           "launches_per_forward": add_launches / N_FWD,
           "attention_shapes": [list(a[0].shape) + [a[1].shape[1]] for a in add_calls],
           "forecast_absmax": float(np.abs(outs[0]).max()),
           "attention_inputs": demand_attn, "attention_max_tolerance_share": DEMAND_ATTN_MAX_SHARE,
           "f32_card_vs_cpu_max_abs_err": demand_card_vs_cpu, "f32_tol": F32_ATOL})
    _require(demand_card_vs_cpu <= F32_ATOL, f"Demand on card vs CPU in f32: {demand_card_vs_cpu}")

    # 14. the same forecaster with the trend GRU on its kernel path ----------------
    trend_gru = model.static.trend_encoder.gru
    trend_gru.use_kernel = True
    zero_counts()
    gru_outs = [fn(hb) for hb in host_batches]
    gru_path_launches, gru_path_additive = gru_kernel.launches, additive.launches
    gru_vs_loop = max(float(np.abs(a - b).max()) for a, b in zip(gru_outs, outs))
    _require(gru_path_launches == N_FWD and gru_path_additive == 36 * N_FWD,
             f"GRU kernel path: {gru_path_launches} GRU and {gru_path_additive} additive "
             f"launches in {N_FWD} forwards")
    dev_batch = _to_device(host_batches[0], dev)
    path_ms = {"step_loop": [], "kernel": []}
    with torch.inference_mode():
        for use_kernel in (False, True, True, False):  # in turns
            trend_gru.use_kernel = use_kernel
            model(dev_batch)
            path_ms["kernel" if use_kernel else "step_loop"].append(
                _cuda_ms(lambda: model(dev_batch), 5))
    trend_gru.use_kernel = False
    _emit({"phase": "forward_demand_gru", **card, "launches": gru_path_launches,
           "launches_per_forward": gru_path_launches / N_FWD,
           "forecast_max_abs_diff_vs_step_loop": gru_vs_loop, "forward_ms": path_ms})
    # The forecasts go through a bf16 backbone either way; the GRU's two paths
    # differ by f32 rounding only.
    _require(gru_vs_loop <= F32_ATOL, f"GRU kernel path vs step loop: {gru_vs_loop}")

    # 15. CrossAttnRNN 2-1 and 2-10 on the card vs the CPU -------------------------
    window_errs, window_launches = {}, {}
    for name, extra, per_forward in (("cross_attn_rnn_21", {}, 3),
                                     ("cross_attn_rnn_210", {"out_len": 10}, 30)):
        zero_counts()
        window_errs[name] = _card_vs_cpu(name, dev, batch=_stfore_batch(8, 64, seed=4),
                                         attention_dim=48, embedding_dim=64, hidden_dim=64,
                                         **extra)
        window_launches[name] = additive.launches
        _require(additive.launches == per_forward,
                 f"{name}: {additive.launches} additive launches in one forward")
        _require(window_errs[name] <= F32_ATOL, f"{name} on card vs CPU: {window_errs[name]}")
    _emit({"phase": "forward_rnn_21_210", **card, "launches_per_forward": window_launches,
           "f32_card_vs_cpu_max_abs_err": window_errs, "f32_tol": F32_ATOL})

    # 16.–18. Demand times, additive attention times, GRU times ---------------------
    _emit({"phase": "times_demand", **card, "model": "cross_attn_rnn_demand",
           **_forward_times(model, fn, host_batches, dev, seed=400, kernel_groups={
               "fused_additive_attention": ADDITIVE_KERNEL_NAMES})})
    per_call = {}
    with torch.inference_mode():
        for mod, args in zip(add_mods, add_calls):
            kw = dict(weight_on=mod.weight_on)
            # 50 calls: the profiler dropped kernels over 200 calls (800 launches).
            device_ms, call_ms = _kernel_vs_plain_times(additive, additive_plain, args, kw,
                                                        n_calls=50)
            per_kernel = _profiled_kernels_us(lambda: additive(*args, **kw))
            (Bm, L, De), (Dd, A) = args[0].shape, args[3].shape
            n_bytes, flops = roofline.additive_attention_cost(Bm, L, De, Dd, A, mod.weight_on)
            c_bound_ms, c_bound_by = roofline.f32_accurate_bound_ms(n_bytes, flops)
            per_call[f"L={L}"] = {
                "shape": {"B": Bm, "L": L, "De": De, "Dd": Dd, "A": A,
                          "weight_on": mod.weight_on},
                "launches_per_forward": model.out_len,
                "kernel_launches_per_call": _kernels_per_call(per_kernel),
                "kernel_device_us": 1e3 * device_ms["kernel"],
                "kernel_device_us_per_launch": _launch_split_us(per_kernel),
                "plain_device_us": 1e3 * device_ms["plain"],
                "kernel_call_us": 1e3 * call_ms["kernel"],
                "plain_call_us": 1e3 * call_ms["plain"],
                "bytes": n_bytes, "flops": flops, "bound_us": 1e3 * c_bound_ms,
                "bound_by": c_bound_by,
                "bound_simt_f32_us": 1e3 * roofline.bound_ms(n_bytes, flops)[0]}
            _require(per_call[f"L={L}"]["kernel_launches_per_call"] <= ADDITIVE_MAX_LAUNCHES,
                     f"additive attention at L={L}: {per_call[f'L={L}']}")
    _emit({"phase": "additive_kernel_times", **card, "calls": per_call,
           "library_ms": "none: no single PyTorch call computes additive attention"})
    add_mix = lambda key: sum(v[key] for v in per_call.values()) / len(per_call) / 1e3
    add_mix_bound = roofline.f32_accurate_bound_ms(sum(v["bytes"] for v in per_call.values()),
                                                   sum(v["flops"] for v in per_call.values()))

    # The trend GRU's own weights and input, as the kernel path runs them.
    gru_x = dev_batch["gtrends"].transpose(1, 2).contiguous()
    gru_w = (trend_gru.w_i, trend_gru.w_h, trend_gru.b_i, trend_gru.b_h)
    library = cudnn_gru(*gru_w)
    with torch.inference_mode():
        gru_device_ms, gru_call_ms = _call_times(
            {"kernel": lambda: gru_kernel(gru_x, *gru_w),
             "plain": lambda: gru_plain(gru_x, *gru_w),
             "library": lambda: library(gru_x)}, n_calls=50)
        with _profile() as prof:
            for _ in range(20):
                gru_kernel(gru_x, *gru_w)
            torch.cuda.synchronize()
    recurrence = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and GRU_KERNEL_NAME in e.key and e.count]
    _require(recurrence, f"the profiler saw no {GRU_KERNEL_NAME} kernel")
    # Per kernel record: the profiler can drop records in a short window.
    steps_us = (sum(e.self_device_time_total for e in recurrence)
                / sum(e.count for e in recurrence))
    Bg, Tg, _ = gru_x.shape
    Hg = trend_gru.hidden_dim
    gru_bytes, gru_flops = roofline.gru_sequence_cost(Bg, Tg, Hg)
    gru_bound_ms, gru_bound_by = roofline.f32_accurate_bound_ms(gru_bytes, gru_flops)
    gru_bound_simt_ms = roofline.bound_ms(gru_bytes, gru_flops)[0]
    _emit({"phase": "gru_kernel_times", **card,
           "shape": {"B": Bg, "T": Tg, "I": gru_x.shape[2], "H": Hg},
           "kernel_device_us": 1e3 * gru_device_ms["kernel"],
           "kernel_recurrence_device_us": steps_us,
           "kernel_recurrence_records": sum(e.count for e in recurrence),
           "plain_device_us": 1e3 * gru_device_ms["plain"],
           "library_device_us": 1e3 * gru_device_ms["library"],
           "kernel_call_us": 1e3 * gru_call_ms["kernel"],
           "plain_call_us": 1e3 * gru_call_ms["plain"],
           "library_call_us": 1e3 * gru_call_ms["library"],
           "launches_per_forward_on_kernel_path": 1,
           "bytes": gru_bytes, "flops": gru_flops, "bound_us": 1e3 * gru_bound_ms,
           "bound_by": gru_bound_by, "bound_simt_f32_us": 1e3 * gru_bound_simt_ms})

    del model, fn, dev_batch, add_calls

    # 19. the conv-floor probe's kernels vs their plain versions -------------------
    probe = _probe_kernel_checks(dev)
    _emit({"phase": "probe_kernels", **probe, "bf16_tol": BF16_GEMM_TOL,
           "read_atol": READ_ATOL, "read_rtol": READ_RTOL})

    # 20. the roofline harness's probe at both shapes: the slice's main path -------
    zero_counts()
    harness = {name: convfloor.measure_shape(name, target_s=HARNESS_TARGET_S, device=dev, **s)
               for name, s in convfloor.SHAPES.items()}
    probe_launches = {"bf16": matmul_bf16.launches, "int8": matmul_int8.launches,
                      "read": read_reduce.launches}
    _require(min(probe_launches.values()) > 0, f"the harness skipped a kernel: {probe_launches}")
    _require(kernel.launches + mha.launches + additive.launches + gru_kernel.launches == 0,
             "the harness launched a model kernel")
    # Kernel and library times are the harness's (CUDA events around replays
    # of a CUDA graph of calls); the plain versions' are CUDA events over 10
    # eager calls.
    # The profiler's device time per kernel record is printed beside them:
    # it can drop records in a short window, so it is averaged per record.
    probe_us, profiled_us = {}, {}
    with torch.inference_mode():
        for name, s in convfloor.SHAPES.items():
            xb, wb, xi, wi, bias = convfloor.probe_inputs(device=dev, **s)
            h = harness[name]
            probe_us[name] = {
                "bf16_kernel": 1e6 * h["cuda_bf16"]["secs"],
                "bf16_library": 1e6 * h["cublas_bf16"]["secs"],
                "int8_kernel": 1e6 * h["cuda_int8"]["secs"],
                "int8_library": 1e6 * h["cublas_int8"]["secs"],
                "read_kernel": 1e6 * h["read_bw"]["secs"],
                "read_library": 1e6 * h["torch_sum_bw"]["secs"]}
            for kind, plain_fn in (("bf16", lambda: matmul_bf16_plain(xb, wb)),
                                   ("int8", lambda: matmul_int8_plain(xi, wi)),
                                   ("read", lambda: read_reduce_plain(xb, bias))):
                plain_fn()
                probe_us[name][f"{kind}_plain"] = 1e3 * _cuda_ms(plain_fn, 10)
            profiled_us[name] = {key: _profiled_kernels_us(fn) for key, fn in (
                ("bf16_kernel", lambda: matmul_bf16(xb, wb)),
                ("bf16_library", lambda: torch.matmul(xb, wb)),
                ("int8_kernel", lambda: matmul_int8(xi, wi)),
                ("int8_library", lambda: torch._int_mm(xi, wi)),
                ("read_kernel", lambda: read_reduce(xb, bias)),
                ("read_library", lambda: convfloor.torch_sum_partials(xb)))}
            m, k, n = s["m"], s["k"], s["n"]
            for kind, cost in (("bf16", roofline.probe_gemm_cost(m, k, n, "bf16")),
                               ("int8", roofline.probe_gemm_cost(m, k, n, "int8")),
                               ("read", roofline.read_reduce_cost(m, k))):
                b_ms, b_by = roofline.bound_ms(*cost, "f32" if kind == "read" else kind)
                probe_us[name][f"{kind}_bound"] = 1e3 * b_ms
                probe_us[name][f"{kind}_bound_by"] = b_by
            del xb, wb, xi, wi
    _emit({"phase": "convfloor_times", **card, "launches": probe_launches,
           "harness": harness, "us_per_call": probe_us,
           "profiler_device_us_per_kernel_record": profiled_us})

    # 21. the conv roofline: GEMM controls, 24 conv shapes, epilogue and chain -----
    gemms = {n: harness_roofline.measure_gemm(n, device=dev, target_s=HARNESS_TARGET_S)
             for n in (2048, 4096, 8192)}
    convs = convfloor_v2.measure_convs((), ("bf16",), HARNESS_TARGET_S, device=dev)
    weighted = convs["conv_weighted_bf16"]
    forward_conv_ms = v4_times["forward_device_ms_by_op"]["aten::cudnn_convolution"]
    _require(weighted["shapes_measured"] == 24, f"conv shapes measured: {weighted}")
    _emit({"phase": "conv_roofline", **card, "batch": harness_roofline.BATCH,
           "gemm_bf16": gemms, **convs,
           "forward_cudnn_convolution_ms": forward_conv_ms,
           "harness_over_forward_conv_x": weighted["sum_secs_per_batch_ms"] / forward_conv_ms,
           "artifact_check": convfloor_v2.measure_artifact_check(HARNESS_TARGET_S, device=dev),
           "epilogue_chain": convfloor_v2.measure_epilogue_and_chain(HARNESS_TARGET_S,
                                                                     device=dev),
           "method": convfloor.timing.METHOD})

    # kernels line, card line, result ---------------------------------------------
    big = max(convfloor.SHAPES, key=lambda nm: probe_us[nm]["bf16_kernel"])

    def probe_row(name, kind, source, replaces, err, tol):
        us = probe_us[big]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": f"scripts/perf_pallas_convfloor.py:{replaces}",
                "launches": probe_launches[kind], "max_abs_err": err, **tol,
                "shape": big, "timed_by": "CUDA events around replays of a CUDA graph of calls",
                "ms": us[f"{kind}_kernel"] / 1e3,
                "plain_ms": us[f"{kind}_plain"] / 1e3, "bound_ms": us[f"{kind}_bound"] / 1e3,
                "bound_by": us[f"{kind}_bound_by"], "library_ms": us[f"{kind}_library"] / 1e3,
                "by_shape_us": {nm: {f: v[f"{kind}_{f}"] for f in
                                     ("kernel", "plain", "library", "bound")}
                                for nm, v in probe_us.items()}}

    _emit({"kernels": [{
        "name": "fused_gated_residual", "route": "cuda",
        "source": "visuelle2_tpu_torch/csrc/gated_fusion.cu",
        "replaces": "visuelle2_tpu/ops/pallas/gated_fusion.py:59",
        "launches": launches,
        "max_abs_err": max(max(errs.values()), fusion_err), "tol": KERNEL_ATOL,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_simt_f32_ms": bound_simt_ms, "library_ms": None}, {
        "name": "fused_gated_mha", "route": "cuda",
        "source": "visuelle2_tpu_torch/csrc/gated_mha.cu",
        "replaces": "visuelle2_tpu/ops/pallas/gated_mha.py:107",
        "launches": mha_launches,
        "max_abs_err": max(max(mha_errs.values()), max(attn_errs.values())),
        "atol": MHA_ATOL, "rtol": MHA_RTOL,
        "ms": mix("kernel_device_us"), "plain_ms": mix("plain_device_us"),
        "bound_ms": mix("bound_us"),
        "bound_by": roofline.f32_accurate_bound_ms(mix_bytes, mix_flops)[1],
        "bound_simt_f32_ms": mix("bound_simt_f32_us"), "library_ms": None,
        "by_variant_us": {v: {k: per_variant[v][k] for k in
                              ("kernel_device_us", "plain_device_us", "bound_us")}
                          for v in per_variant}}, {
        "name": "fused_additive_attention", "route": "cuda",
        "source": "visuelle2_tpu_torch/csrc/additive_attention.cu",
        "replaces": "visuelle2_tpu/ops/pallas/additive_attention.py:74",
        "launches": add_launches,
        "max_abs_err": max(max(add_errs.values()), *(e for check in demand_attn.values()
                                                       for e in check["max_abs_err"].values())),
        "atol": MHA_ATOL, "rtol": MHA_RTOL,
        "ms": add_mix("kernel_device_us"), "plain_ms": add_mix("plain_device_us"),
        "bound_ms": add_mix("bound_us"), "bound_by": add_mix_bound[1],
        "bound_simt_f32_ms": add_mix("bound_simt_f32_us"), "library_ms": None,
        "launches_per_call": max(v["kernel_launches_per_call"] for v in per_call.values()),
        "by_call_us": {k: {f: v[f] for f in ("kernel_device_us", "plain_device_us",
                                             "bound_us", "bound_simt_f32_us")}
                       for k, v in per_call.items()}}, {
        "name": "fused_gru_sequence", "route": "cuda",
        "source": "visuelle2_tpu_torch/csrc/gru_seq.cu",
        "replaces": "visuelle2_tpu/ops/pallas/gru_seq.py:62",
        "launches": gru_path_launches,
        "launches_note": "the trend GRU's kernel path (GRU.use_kernel); the default "
                         "Demand path, like every JAX model, runs the step loop",
        "max_abs_err": max(max(e["vs_plain"], e["vs_cudnn"]) for e in gru_errs.values()),
        "atol": GRU_ATOL_FULL,
        "ms": gru_device_ms["kernel"], "plain_ms": gru_device_ms["plain"],
        "bound_ms": gru_bound_ms, "bound_by": gru_bound_by,
        "bound_simt_f32_ms": gru_bound_simt_ms, "library_ms": gru_device_ms["library"],
        "hidden_range_on_cuda": "H <= {} (resident layout up to {}, streamed above)".format(
            gru_seq.max_hidden(torch.cuda.get_device_properties(dev).multi_processor_count),
            gru_seq.RESIDENT_MAX_HIDDEN),
        "wide_us": wide_us},
        probe_row("probe_matmul_bf16", "bf16", "visuelle2_tpu_torch/csrc/probe_gemm_bf16.cu", 176,
                  probe["max_abs_err"]["bf16"], {"tol": BF16_GEMM_TOL}),
        probe_row("probe_matmul_int8", "int8", "visuelle2_tpu_torch/csrc/probe_gemm.cu", 209,
                  probe["max_abs_err"]["int8"], {"tol": 0}),
        probe_row("read_reduce", "read", "visuelle2_tpu_torch/csrc/read_reduce.cu", 249,
                  probe["max_abs_err"]["read"], {"atol": READ_ATOL, "rtol": READ_RTOL})]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
