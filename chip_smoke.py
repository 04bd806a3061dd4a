#!/usr/bin/env python3
"""Card check of the PyTorch port (``visuelle2_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``visuelle2_tpu_torch/csrc`` (nvcc,
sm_90a, into ``build/visuelle2_tpu_torch/``), then, each phase printing one
JSON line and any failure exiting non-zero:

1. device  — the card, its power limit, the kernel library's build time;
2. kernel  — ``fused_gated_residual`` against its plain PyTorch version
   (TF32 off, atol 1e-5) at the main-path and ragged shapes;
3. forward — the full-width gated_v4 demand forecaster (ResNet-101 at 299²,
   bf16 backbone, E=32, H=64, B=128, random weights from a seeded
   generator) through ``make_forecaster``: finite [128, 12] forecasts, two
   kernel launches per forward, the kernel held to its plain version on the
   fusion inputs of the real forward, and the port on the card held to the
   port on the CPU in f32 at a small width;
4. serve   — the port's HTTP server answers concurrent requests, coalesces
   them, and each answer matches a direct forward of the same rows;
5. times   — forward time per batch by CUDA events over distinct batches
   (the median of five windows, each window reported),
   the forward's device busy time, its split by operator and its top
   kernels from ``torch.profiler``, its FLOPs and the convolutions' rate,
   the serving callable's latency, peak device memory;
   the kernel's and the plain version's device time per call (profiler)
   and time per call as seen from Python (CUDA events), and the kernel's
   bound from its shapes.

Then the ``kernels`` line, the ``nvidia-smi`` line and, last, the ``ok``
line.  Without a CUDA device it exits non-zero before printing any result.
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
KERNEL_ATOL = 1e-5   # kernel vs plain: both f32, sums in another order
F32_ATOL = 1e-4      # port on the card vs on the CPU in f32, as the CPU tests
# Served rows vs a direct forward of just those rows: the bf16 backbone runs
# at another batch size there, where cuDNN may pick other algorithms that
# round differently; bf16 keeps about 3 significant digits.
SERVE_RTOL = 5e-2
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
F32_FLOP_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores


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


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this check runs on the GPU only")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from visuelle2_tpu_torch.eval.export import make_forecaster
    from visuelle2_tpu_torch.eval.server import drain_and_close, make_server
    from visuelle2_tpu_torch.models import VocabSizes, build
    from visuelle2_tpu_torch.ops.cuda import _build
    from visuelle2_tpu_torch.ops.cuda.gated_fusion import (
        fused_gated_residual as kernel,
        fused_gated_residual_plain as plain,
    )

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

    # 2. kernel vs plain ---------------------------------------------------------
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

    # 3. full-width forward through the serving callable -------------------------
    model = build("gated_v4", device=dev, generator=torch.Generator().manual_seed(0),
                  vocab=VocabSizes(5, 6, 5, 126), output_len=12,
                  image_arch="resnet101", image_dtype=torch.bfloat16)
    example = _synthetic_batch(B, IMAGE, seed=1)
    fn, header = make_forecaster(model, example, device=dev)
    captured = []
    hook = model.fusion.register_forward_pre_hook(
        lambda mod, args: captured.append(args) if not captured else None)
    n_fwd = 3
    host_batches = [_synthetic_batch(B, IMAGE, seed=10 + i) for i in range(n_fwd)]
    kernel.launches = 0
    outs = [fn(hb) for hb in host_batches]
    launches = kernel.launches
    hook.remove()
    for out in outs:
        _require(out.shape == (B, 12) and np.isfinite(out).all(),
                 f"forecast not finite [{B}, 12]: {out.shape}")
    _require(not np.array_equal(outs[0], outs[1]), "distinct batches gave equal forecasts")
    _require(launches == 2 * n_fwd, f"{launches} kernel launches in {n_fwd} forwards")

    with torch.inference_mode():
        main_calls = _gate_inputs(model, *captured[0])
        fusion_err = 0.0
        for residual in (True, False):
            for call in main_calls:
                got, want = kernel(*call, residual=residual), plain(*call, residual=residual)
                fusion_err = max(fusion_err, (got - want).abs().max().item())
    _require(fusion_err <= KERNEL_ATOL, f"kernel vs plain on forward inputs: {fusion_err}")

    small = build("gated_v4", device=dev, generator=torch.Generator().manual_seed(2),
                  image_arch="tiny", vocab=VocabSizes(5, 6, 5, 126))
    small_cpu = build("gated_v4", device="cpu", image_arch="tiny",
                      vocab=VocabSizes(5, 6, 5, 126))
    small_cpu.load_state_dict({k: v.cpu() for k, v in small.state_dict().items()})
    sb = _synthetic_batch(8, 64, seed=3)
    with torch.inference_mode():
        on_card = small(_to_device(sb, dev))[0].cpu()
        on_cpu = small_cpu(_to_device(sb, "cpu"))[0]
    card_vs_cpu = (on_card - on_cpu).abs().max().item()
    _emit({"phase": "forward", **card, "batch": B, "image": IMAGE, "forwards": n_fwd,
           "launches": launches, "launches_per_forward": launches / n_fwd,
           "forecast_absmax": float(np.abs(outs[0]).max()),
           "fusion_inputs_max_abs_err": fusion_err,
           "f32_card_vs_cpu_max_abs_err": card_vs_cpu, "f32_tol": F32_ATOL})
    _require(card_vs_cpu <= F32_ATOL, f"port on card vs CPU in f32: {card_vs_cpu}")

    # 4. serving -----------------------------------------------------------------
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

    kernel.launches = 0
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

    # 5. times -------------------------------------------------------------------
    fn_s = []
    for hb in host_batches:  # warm: the same callables served above
        t0 = time.perf_counter()
        fn(hb)
        fn_s.append(time.perf_counter() - t0)
    dev_batches = [_to_device(_synthetic_batch(B, IMAGE, seed=200 + i), dev)
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
        by_op = sorted(((e.key, e.self_device_time_total / 2e3)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CPU and e.self_device_time_total > 0),
                       key=lambda kv: -kv[1])[:10]
        by_kernel = sorted(([e.key[:100], e.self_device_time_total / 2e3, e.count // 2]
                            for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA and not e.is_user_annotation),
                           key=lambda kv: -kv[1])[:8]

        x, ctx, wx, wc, b = main_calls[1]
        n_calls = 500
        for f in (kernel, plain):
            f(x, ctx, wx, wc, b)
        k_call_ms = _cuda_ms(lambda: kernel(x, ctx, wx, wc, b), n_calls)
        p_call_ms = _cuda_ms(lambda: plain(x, ctx, wx, wc, b), n_calls)
        device_ms = {}
        for name, f in (("kernel", kernel), ("plain", plain)):
            with _profile() as prof:
                for _ in range(n_calls):
                    f(x, ctx, wx, wc, b)
                torch.cuda.synchronize()
            device_ms[name] = _device_us(prof) / n_calls / 1e3
    k_ms, p_ms = device_ms["kernel"], device_ms["plain"]
    _require(k_ms > 0 and p_ms > 0, f"profiler saw no device time: {device_ms}")
    Bm, D = x.shape
    C = ctx.shape[1]
    k_bytes = 4 * (Bm * D + Bm * C + D * D + C * D + D + Bm * D)
    k_flops = 2 * Bm * D * (D + C) + 4 * Bm * D
    bytes_ms, ops_ms = 1e3 * k_bytes / HBM_BYTES_PER_S, 1e3 * k_flops / F32_FLOP_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    _emit({"phase": "times", **card, "batch": B, "forward_ms": fwd_ms,
           "forward_ms_windows": fwd_windows,
           "forecasts_per_s": B / (fwd_ms / 1e3),
           "forward_device_busy_ms": fwd_device_ms,
           "device_idle_share": max(0.0, 1.0 - fwd_device_ms / fwd_ms),
           "forward_device_ms_by_op": dict(by_op),
           "forward_top_kernels_ms_launches": by_kernel,
           "forward_flops": flops.get_total_flops(), "conv_flops": conv_flops,
           "conv_tflops_per_s": conv_flops / 1e9 / dict(by_op)["aten::cudnn_convolution"],
           "serving_fn_ms_incl_copies": sorted(1e3 * t for t in fn_s),
           "max_memory_allocated_bytes": peak_bytes})
    _emit({"phase": "kernel_times", **card,
           "kernel_shape": {"B": Bm, "D": D, "C": C},
           "kernel_device_us": 1e3 * k_ms, "plain_device_us": 1e3 * p_ms,
           "kernel_call_us": 1e3 * k_call_ms, "plain_call_us": 1e3 * p_call_ms,
           "kernel_bytes": k_bytes, "kernel_flops": k_flops, "bound_us": 1e3 * bound_ms,
           "library_ms": "none: no single PyTorch call computes this function"})

    # 6. kernels line, card line, result -----------------------------------------
    _emit({"kernels": [{
        "name": "fused_gated_residual", "route": "cuda",
        "source": "visuelle2_tpu_torch/csrc/gated_fusion.cu",
        "replaces": "visuelle2_tpu/ops/pallas/gated_fusion.py:59",
        "launches": launches,
        "max_abs_err": max(max(errs.values()), fusion_err), "tol": KERNEL_ATOL,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None}]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
