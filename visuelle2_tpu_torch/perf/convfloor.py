"""Kernel-level probe of the narrow 1x1-conv floor on the card.

The port of ``scripts/perf_pallas_convfloor.py``.  At the two narrow GEMM
shapes of the backbone's worst 1x1 convolutions (``SHAPES``), it times:

* ``cublas_bf16`` — ``torch.matmul`` of bf16 x and w (bf16 out, f32 sums);
* ``cuda_bf16``   — the port's hand-written kernel for the same product
  (``ops/cuda/probe_gemm.py::matmul_bf16``, the Pallas ``_pallas_matmul``);
* ``cublas_int8`` — ``torch._int_mm`` of int8 x and w (int32 out);
* ``cuda_int8``   — the port's int8 kernel (``matmul_int8``, the Pallas
  ``_pallas_matmul_int8``);
* ``read_bw``     — the read probe (``ops/cuda/read_reduce.py``, the Pallas
  ``_pallas_read_reduce``): x read once, in GB/s, and the rate a GEMM of
  these shapes would have at that bandwidth (``bw_roofline_tflops``);
* ``torch_sum_bw`` — its yardstick, ``torch.sum`` over the same view of x.

Each entry also holds the kernel's bound from ``ops/cuda/roofline.py``.
Timing is ``perf/timing.py``'s (CUDA events around replays of a CUDA graph
of calls; x is rotated over copies only where it is under 2x the L2, which
neither probe shape is).  The JAX script's ``--steps`` set nothing (its scans calibrate
their own length) and has no counterpart here.

    python -m visuelle2_tpu_torch.perf.convfloor [--out convfloor.json]
    python -m visuelle2_tpu_torch.perf.convfloor --parity_only

It runs on the card and raises "no CUDA device" without one; it writes a
file only where ``--out`` says.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from visuelle2_tpu_torch._device import resolve_device
from visuelle2_tpu_torch.ops.cuda import probe_gemm, read_reduce, roofline
from visuelle2_tpu_torch.perf import timing

# The two worst per-shape floors of the backbone's 1x1 convolutions at batch
# 128: s1_1x1a(+wide), 128*75*75 rows, 256 -> 64; s2_1x1a_wide, 128*38*38
# rows, 512 -> 128.  M rounded to the tile grid.
SHAPES = {
    "A_720k_256_64": dict(m=720896, k=256, n=64),
    "B_184k_512_128": dict(m=184320, k=512, n=128),
}
TILE_M = read_reduce.TILE_M  # 2048: the read probe's rows per partial


def probe_inputs(m, k, n, device):
    """The probe's operands, drawn on ``device``: x [m, k] and w [k, n] in
    bf16, their int8 versions (x·64 and w·127, rounded and clipped to ±127),
    and the read probe's (8, 128) bias."""
    gen = torch.Generator(device=device).manual_seed(7)  # the JAX probe's seed
    x = torch.randn(m, k, device=device, generator=gen) * 0.5
    w = torch.randn(k, n, device=device, generator=gen) * 0.1
    xi = torch.clamp(torch.round(x * 64), -127, 127).to(torch.int8)
    wi = torch.clamp(torch.round(w * 127), -127, 127).to(torch.int8)
    bias = torch.ones(8, 128, device=device)
    return x.to(torch.bfloat16), w.to(torch.bfloat16), xi, wi, bias


def torch_sum_partials(x):
    """The read probe's yardstick: one ``torch.sum`` of the same tiles."""
    m, k = x.shape
    return torch.sum(x.view(m // TILE_M, TILE_M // 8, 8, k), dim=1, dtype=torch.float32)


def _bf16_matmul(x, w):
    return torch.matmul(x, w)


def measure_shape(name, m, k, n, *, target_s: float = 1.5, device=None):
    """The five measurements and the yardstick at one shape."""
    dev = resolve_device(device)
    xb, wb, xi, wi, bias = probe_inputs(m, k, n, dev)
    flops = 2.0 * m * k * n
    out = {"m": m, "k": k, "n": n, "gflops": flops / 1e9}

    def timed(fn, args):
        sets = timing.input_sets(
            lambda i: args if i == 0 else (args[0].clone(), *args[1:]),
            args[0].numel() * args[0].element_size(), dev)
        return timing.seconds_per_call(fn, sets, device=dev, target_s=target_s)

    def rate(secs, kind):
        bound_s = roofline.bound_ms(*roofline.probe_gemm_cost(m, k, n, kind), kind)[0] / 1e3
        return {"secs": secs, "tflops_per_sec": flops / secs / 1e12, "bound_secs": bound_s}

    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        timing.verify_flops(_bf16_matmul, (xb, wb), flops)
        out["cublas_bf16"] = rate(timed(_bf16_matmul, (xb, wb)), "bf16")
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    out["cuda_bf16"] = rate(timed(probe_gemm.matmul_bf16, (xb, wb)), "bf16")
    # The flop counter has no formula for torch._int_mm: it counts 0.
    out["cublas_int8"] = rate(timed(torch._int_mm, (xi, wi)), "int8")
    out["cuda_int8"] = rate(timed(probe_gemm.matmul_int8, (xi, wi)), "int8")

    read_bytes = 2.0 * m * k
    read_bound_s = roofline.bound_ms(*roofline.read_reduce_cost(m, k))[0] / 1e3
    for key, fn, args in (("read_bw", read_reduce.read_reduce, (xb, bias)),
                          ("torch_sum_bw", torch_sum_partials, (xb,))):
        secs = timed(fn, args)
        out[key] = {"secs": secs, "gb_per_sec": read_bytes / secs / 1e9,
                    "bw_roofline_tflops": flops / secs / 1e12, "bound_secs": read_bound_s}
    best = max(out[v]["tflops_per_sec"] for v in ("cuda_bf16", "cuda_int8"))
    out["best_cuda_over_cublas_bf16"] = best / out["cublas_bf16"]["tflops_per_sec"]
    print(f"{name}: " + " ".join(
        f"{v}={out[v]['tflops_per_sec']:.1f}TF/s"
        for v in ("cublas_bf16", "cuda_bf16", "cublas_int8", "cuda_int8"))
        + f" read_bw={out['read_bw']['gb_per_sec']:.1f}GB/s"
        + f" torch_sum_bw={out['torch_sum_bw']['gb_per_sec']:.1f}GB/s"
        + f" best/cublas={out['best_cuda_over_cublas_bf16']:.3f}x", flush=True)
    return out


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"parity_check: {msg}")


def parity_check(device=None):
    """The three kernels against their plain versions at the JAX parity
    check's seed and sizes (``scripts/perf_pallas_convfloor.py:325-352``);
    on the CPU the wrappers take the plain versions, so this checks the
    plumbing.  Returns the largest differences; raises on a disagreement."""
    dev = resolve_device(device)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4096, 256)).astype(np.float32)
    w = rng.standard_normal((256, 64)).astype(np.float32)
    xb = torch.from_numpy(x).to(dev, torch.bfloat16)
    wb = torch.from_numpy(w).to(dev, torch.bfloat16)
    got = probe_gemm.matmul_bf16(xb, wb).float()
    want = probe_gemm.matmul_bf16_plain(xb, wb).float()
    bf16_err = (got - want).abs()
    _check(bool((bf16_err <= probe_gemm.bf16_tolerance(xb, wb, want)).all()),
           f"bf16 GEMM off by {bf16_err.max().item()}")

    xi = torch.from_numpy(np.clip(np.round(x * 16), -127, 127).astype(np.int8)).to(dev)
    wi = torch.from_numpy(np.clip(np.round(w * 16), -127, 127).astype(np.int8)).to(dev)
    got_i = probe_gemm.matmul_int8(xi, wi).cpu().numpy()
    want_i = xi.cpu().numpy().astype(np.int32) @ wi.cpu().numpy().astype(np.int32)
    _check(np.array_equal(got_i, want_i), "int8 GEMM is not exact")

    bias = torch.full((8, 128), 2.5, device=dev)
    rr = read_reduce.read_reduce(xb, bias)
    rr0 = read_reduce.read_reduce(xb, torch.zeros_like(bias))
    want_rr = read_reduce.read_reduce_plain(xb, bias)
    rr_err = (rr - want_rr).abs()
    _check(tuple(rr.shape) == (16, 128) and bool(torch.isfinite(rr).all()),
           f"read partials {tuple(rr.shape)} not finite (16, 128)")
    _check(bool((rr_err <= 1e-4 + 1e-5 * want_rr.abs()).all()),
           f"read partials off by {rr_err.max().item()}")
    # The bias must reach every partial.
    shift_err = ((rr - rr0) - 2.5).abs().max().item()
    _check(shift_err <= 1e-5, f"bias shift off by {shift_err}")
    return {"bf16_max_abs_err": bf16_err.max().item(), "int8_exact": True,
            "read_max_abs_err": rr_err.max().item(), "bias_shift_max_abs_err": shift_err}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None, help="write the results here (default: no file)")
    p.add_argument("--target_s", type=float, default=1.5)
    p.add_argument("--parity_only", action="store_true",
                   help="only hold the kernels to their plain versions on the card")
    args = p.parse_args(argv)
    dev = resolve_device(None)
    if args.parity_only:
        print(json.dumps(parity_check(dev)))
        print("parity ok")
        return None
    results = {"device": timing.device_record(dev), "tile_m": TILE_M,
               "method": timing.METHOD, "parity": parity_check(dev), "shapes": {}}
    for name, s in SHAPES.items():
        results["shapes"][name] = measure_shape(name, target_s=args.target_s, device=dev, **s)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
