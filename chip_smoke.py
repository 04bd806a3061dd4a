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
11. additive_kernel — ``fused_additive_attention`` against its plain version
   (TF32 off, atol 2e-5, rtol 1e-5 on the output and α), both ``weight_on``,
   at the three CrossAttnRNN Demand shapes (B=128, De=Dd=A=512, L = 100
   image patches, 52 trend steps, 4 fused tokens), a ragged one (B=37, L=13,
   De=48, Dd=40, A=24) and L=2;
12. gru_kernel — ``fused_gru_sequence`` against its plain step loop and
   cuDNN's ``torch.nn.GRU`` at the trend GRU's shape (B=128, T=52, I=3,
   H=512; atol 1e-4) and at a ragged small one (atol 2e-5);
13. forward_demand — the full-width CrossAttnRNN Demand forecaster
   (ResNet-101 at 299², bf16 backbone, E=A=H=512, B=128, random weights from
   a seeded generator) through ``make_forecaster``: finite [128, 12, 1]
   forecasts, exactly 36 ``fused_additive_attention`` launches per forward
   (3 per decode step), the kernel held to its plain version on the
   attention inputs of the real forward, and a small Demand on the card held
   to the same model on the CPU in f32;
14. forward_demand_gru — the same forecaster with its trend GRU on the
   kernel path (``GRU.use_kernel``, the port of the JAX ``use_pallas``):
   one ``fused_gru_sequence`` launch per forward, forecasts against the
   step-loop path's, and the forward time of both paths in turns;
15. forward_rnn_21_210 — CrossAttnRNN 2-1 and 2-10 (``out_len`` 10) at a
   small width on the card (tiny backbone) against the CPU in f32: 3 and 30
   launches per forward;
16. times_demand — Demand's forward times as in 6;
17. additive_kernel_times — per Demand call (L = 100, 52, 4), the kernel's
   and the plain version's device time per launch and time per call,
   launches per forward, and the bound;
18. gru_kernel_times — at the trend GRU's shape, the device time per call
   and time per call of the kernel path (input GEMM and the 52 step
   launches), of its plain version and of ``torch.nn.GRU``, and the bound.

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
    events) of each zero-argument callable in ``fns``."""
    for f in fns.values():
        f()
    call_ms = {name: _cuda_ms(f, n_calls) for name, f in fns.items()}
    device_ms = {}
    for name, f in fns.items():
        with _profile() as prof:
            for _ in range(n_calls):
                f()
            torch.cuda.synchronize()
        device_ms[name] = _device_us(prof) / n_calls / 1e3
    _require(min(device_ms.values()) > 0, f"profiler saw no device time: {device_ms}")
    return device_ms, call_ms


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


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this check runs on the GPU only")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from visuelle2_tpu_torch.eval.export import make_forecaster
    from visuelle2_tpu_torch.eval.server import drain_and_close, make_server
    from visuelle2_tpu_torch.models import VocabSizes, build
    from visuelle2_tpu_torch.ops.cuda import _build, roofline
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
    from visuelle2_tpu_torch.ops.masks import gcd_block_mask

    def zero_counts():
        kernel.launches = mha.launches = additive.launches = gru_kernel.launches = 0

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
    _emit({"phase": "times", **card, "model": "gated_v4",
           **_forward_times(model, fn, host_batches, dev, seed=200)})
    x, ctx, wx, wc, b = main_calls[1]
    with torch.inference_mode():
        device_ms, call_ms = _kernel_vs_plain_times(kernel, plain, (x, ctx, wx, wc, b), {})
    k_ms, p_ms = device_ms["kernel"], device_ms["plain"]
    Bm, D = x.shape
    C = ctx.shape[1]
    k_bytes, k_flops = roofline.gated_residual_cost(Bm, D, C)
    bound_ms, bound_by = roofline.bound_ms(k_bytes, k_flops)
    _emit({"phase": "kernel_times", **card,
           "kernel_shape": {"B": Bm, "D": D, "C": C},
           "kernel_device_us": 1e3 * k_ms, "plain_device_us": 1e3 * p_ms,
           "kernel_call_us": 1e3 * call_ms["kernel"], "plain_call_us": 1e3 * call_ms["plain"],
           "kernel_bytes": k_bytes, "kernel_flops": k_flops, "bound_us": 1e3 * bound_ms,
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
            v_bound_ms, v_bound_by = roofline.bound_ms(n_bytes, flops)
            per_variant[variant] = {
                "shape": {"B": args[0].shape[0], "Lq": args[0].shape[1],
                          "Lk": args[1].shape[1], "D": args[0].shape[2], "heads": kw["num_heads"]},
                "launches_per_forward": variants.count(variant),
                "kernel_device_us": 1e3 * device_ms["kernel"],
                "plain_device_us": 1e3 * device_ms["plain"],
                "kernel_call_us": 1e3 * call_ms["kernel"],
                "plain_call_us": 1e3 * call_ms["plain"],
                "bytes": n_bytes, "flops": flops, "bound_us": 1e3 * v_bound_ms,
                "bound_by": v_bound_by}
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
    add_errs, add_bad = {}, []
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
    _emit({"phase": "additive_kernel", "max_abs_err": add_errs, "atol": MHA_ATOL,
           "rtol": MHA_RTOL})
    _require(not add_bad, f"additive attention disagrees with plain at {add_bad}: {add_errs}")

    # 12. GRU sequence vs plain and cuDNN ---------------------------------------------
    gru_errs = {}
    for (Bk, T, I, H), atol in (((B, 52, 3, 512), GRU_ATOL_FULL), ((37, 9, 5, 24), GRU_ATOL_SMALL)):
        bound = H ** -0.5
        x = torch.rand(Bk, T, I, device=dev, generator=gen)
        w = [(torch.rand(*shape, device=dev, generator=gen) * 2 - 1) * bound
             for shape in ((I, 3 * H), (H, 3 * H), (3 * H,), (3 * H,))]
        h0 = torch.randn(Bk, H, device=dev, generator=gen) * 0.5
        outs, h_last = gru_kernel(x, *w, h0)
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
            "atol": atol}
        _require(max(gru_errs[key]["vs_plain"], gru_errs[key]["vs_cudnn"]) <= atol,
                 f"GRU kernel disagrees at {key}: {gru_errs[key]}")
    _emit({"phase": "gru_kernel", "max_abs_err": gru_errs})

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
    with torch.inference_mode():
        demand_attn_errs = {}
        for mod, args in zip(add_mods, add_calls):
            got = additive(*args, weight_on=mod.weight_on)
            want = additive_plain(*args, weight_on=mod.weight_on)
            key = f"L={args[0].shape[1]}"
            demand_attn_errs[key], ok = _additive_err(got, want)
            _require(ok, f"additive attention vs plain on forward inputs: {demand_attn_errs}")
    demand_card_vs_cpu = _card_vs_cpu("cross_attn_rnn_demand", dev, attention_dim=64,
                                      embedding_dim=64, hidden_dim=64)
    _emit({"phase": "forward_demand", **card, "model": "cross_attn_rnn_demand", "batch": B,
           "image": IMAGE, **CROSS_ATTN_DIMS, "forwards": N_FWD, "launches": add_launches,
           "launches_per_forward": add_launches / N_FWD,
           "attention_shapes": [list(a[0].shape) + [a[1].shape[1]] for a in add_calls],
           "forecast_absmax": float(np.abs(outs[0]).max()),
           "attention_inputs_max_abs_err": demand_attn_errs,
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
               "fused_additive_attention": tuple(
                   f"(anonymous namespace)::{k}_kernel"
                   for k in ("dec_proj", "energy", "softmax", "scale"))})})
    per_call = {}
    with torch.inference_mode():
        for mod, args in zip(add_mods, add_calls):
            kw = dict(weight_on=mod.weight_on)
            # 50 calls: the profiler dropped kernels over 200 calls (800 launches).
            device_ms, call_ms = _kernel_vs_plain_times(additive, additive_plain, args, kw,
                                                        n_calls=50)
            (Bm, L, De), (Dd, A) = args[0].shape, args[3].shape
            n_bytes, flops = roofline.additive_attention_cost(Bm, L, De, Dd, A, mod.weight_on)
            c_bound_ms, c_bound_by = roofline.bound_ms(n_bytes, flops)
            per_call[f"L={L}"] = {
                "shape": {"B": Bm, "L": L, "De": De, "Dd": Dd, "A": A,
                          "weight_on": mod.weight_on},
                "launches_per_forward": model.out_len,
                "kernel_device_us": 1e3 * device_ms["kernel"],
                "plain_device_us": 1e3 * device_ms["plain"],
                "kernel_call_us": 1e3 * call_ms["kernel"],
                "plain_call_us": 1e3 * call_ms["plain"],
                "bytes": n_bytes, "flops": flops, "bound_us": 1e3 * c_bound_ms,
                "bound_by": c_bound_by}
    _emit({"phase": "additive_kernel_times", **card, "calls": per_call,
           "library_ms": "none: no single PyTorch call computes additive attention"})
    add_mix = lambda key: sum(v[key] for v in per_call.values()) / len(per_call) / 1e3
    add_mix_bound = roofline.bound_ms(sum(v["bytes"] for v in per_call.values()),
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
    steps_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and "gru_step" in e.key) / 20
    Bg, Tg, _ = gru_x.shape
    Hg = trend_gru.hidden_dim
    gru_bytes, gru_flops = roofline.gru_sequence_cost(Bg, Tg, Hg)
    gru_bound_ms, gru_bound_by = roofline.bound_ms(gru_bytes, gru_flops)
    _emit({"phase": "gru_kernel_times", **card,
           "shape": {"B": Bg, "T": Tg, "I": gru_x.shape[2], "H": Hg},
           "kernel_device_us": 1e3 * gru_device_ms["kernel"],
           "kernel_recurrence_device_us": steps_us,
           "plain_device_us": 1e3 * gru_device_ms["plain"],
           "library_device_us": 1e3 * gru_device_ms["library"],
           "kernel_call_us": 1e3 * gru_call_ms["kernel"],
           "plain_call_us": 1e3 * gru_call_ms["plain"],
           "library_call_us": 1e3 * gru_call_ms["library"],
           "launches_per_forward_on_kernel_path": 1,
           "bytes": gru_bytes, "flops": gru_flops, "bound_us": 1e3 * gru_bound_ms,
           "bound_by": gru_bound_by})

    # 19. kernels line, card line, result -----------------------------------------
    _emit({"kernels": [{
        "name": "fused_gated_residual", "route": "cuda",
        "source": "visuelle2_tpu_torch/csrc/gated_fusion.cu",
        "replaces": "visuelle2_tpu/ops/pallas/gated_fusion.py:59",
        "launches": launches,
        "max_abs_err": max(max(errs.values()), fusion_err), "tol": KERNEL_ATOL,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}, {
        "name": "fused_gated_mha", "route": "cuda",
        "source": "visuelle2_tpu_torch/csrc/gated_mha.cu",
        "replaces": "visuelle2_tpu/ops/pallas/gated_mha.py:107",
        "launches": mha_launches,
        "max_abs_err": max(max(mha_errs.values()), max(attn_errs.values())),
        "atol": MHA_ATOL, "rtol": MHA_RTOL,
        "ms": mix("kernel_device_us"), "plain_ms": mix("plain_device_us"),
        "bound_ms": mix("bound_us"),
        "bound_by": roofline.bound_ms(mix_bytes, mix_flops)[1],
        "library_ms": None,
        "by_variant_us": {v: {k: per_variant[v][k] for k in
                              ("kernel_device_us", "plain_device_us", "bound_us")}
                          for v in per_variant}}, {
        "name": "fused_additive_attention", "route": "cuda",
        "source": "visuelle2_tpu_torch/csrc/additive_attention.cu",
        "replaces": "visuelle2_tpu/ops/pallas/additive_attention.py:74",
        "launches": add_launches,
        "max_abs_err": max(max(add_errs.values()), max(demand_attn_errs.values())),
        "atol": MHA_ATOL, "rtol": MHA_RTOL,
        "ms": add_mix("kernel_device_us"), "plain_ms": add_mix("plain_device_us"),
        "bound_ms": add_mix("bound_us"), "bound_by": add_mix_bound[1],
        "library_ms": None,
        "by_call_us": {k: {f: v[f] for f in ("kernel_device_us", "plain_device_us",
                                             "bound_us")}
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
        "library_ms": gru_device_ms["library"]}]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
