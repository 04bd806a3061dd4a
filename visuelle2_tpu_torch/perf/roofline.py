"""Roofline controls on the card: what cuBLAS sustains for square bf16 GEMMs,
and each ResNet-101 convolution shape.

The port of ``scripts/perf_roofline.py``.  ``BATCH``, ``RESNET101_CONVS``
and ``conv_out_dim`` are copies of its own (the port imports nothing of
``scripts/``).  ``measure_gemm`` times ``torch.matmul`` of two n x n bf16
matrices with f32 sums (``allow_bf16_reduced_precision_reduction`` off while
it measures).  The JAX script's ``measure_conv`` perturbed the conv input
inside its scan, which ``scripts/perf_convfloor_v2.py:3-17`` found to
inflate bandwidth-bound shapes 2-4x; the port measures convolutions only by
v2's method, ``convfloor_v2.measure_conv_shape``, which this CLI calls.

    python -m visuelle2_tpu_torch.perf.roofline [--out roofline.json]

It runs on the card and raises "no CUDA device" without one; it writes a
file only where ``--out`` says.
"""

from __future__ import annotations

import argparse
import json

import torch

from visuelle2_tpu_torch._device import resolve_device
from visuelle2_tpu_torch.perf import timing

BATCH = 128

# Every distinct conv shape in ResNet-101 @299 (NHWC), with its multiplicity
# in one forward pass.  H/W are the INPUT spatial dims per torchvision
# semantics at 299 input: stem 299->150, pool->75, stage2 38, stage3 19,
# stage4 10.
RESNET101_CONVS = [
    # name, Hin, Cin, Cout, k, stride, count
    ("stem7x7", 299, 3, 64, 7, 2, 1),
    ("s1_1x1a", 75, 64, 64, 1, 1, 1),
    ("s1_1x1a_wide", 75, 256, 64, 1, 1, 2),
    ("s1_3x3", 75, 64, 64, 3, 1, 3),
    ("s1_1x1b", 75, 64, 256, 1, 1, 3),
    ("s1_proj", 75, 64, 256, 1, 1, 1),
    ("s2_1x1a", 75, 256, 128, 1, 1, 1),
    ("s2_3x3_s2", 75, 128, 128, 3, 2, 1),
    ("s2_1x1a_wide", 38, 512, 128, 1, 1, 3),
    ("s2_3x3", 38, 128, 128, 3, 1, 3),
    ("s2_1x1b", 38, 128, 512, 1, 1, 4),
    ("s2_proj", 75, 256, 512, 1, 2, 1),
    ("s3_1x1a", 38, 512, 256, 1, 1, 1),
    ("s3_3x3_s2", 38, 256, 256, 3, 2, 1),
    ("s3_1x1a_wide", 19, 1024, 256, 1, 1, 22),
    ("s3_3x3", 19, 256, 256, 3, 1, 22),
    ("s3_1x1b", 19, 256, 1024, 1, 1, 23),
    ("s3_proj", 38, 512, 1024, 1, 2, 1),
    ("s4_1x1a", 19, 1024, 512, 1, 1, 1),
    ("s4_3x3_s2", 19, 512, 512, 3, 2, 1),
    ("s4_1x1a_wide", 10, 2048, 512, 1, 1, 2),
    ("s4_3x3", 10, 512, 512, 3, 1, 2),
    ("s4_1x1b", 10, 512, 2048, 1, 1, 3),
    ("s4_proj", 19, 1024, 2048, 1, 2, 1),
]


def conv_out_dim(h, k, stride):
    pad = k // 2
    return (h + 2 * pad - k) // stride + 1


def measure_gemm(n, *, device=None, target_s: float = 1.5):
    """Sustained rate of ``torch.matmul`` on two n x n bf16 matrices (bf16
    out, f32 sums), the inputs rotated past the L2."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    b = torch.randn(n, n, device=dev, generator=gen).to(torch.bfloat16)
    sets = timing.input_sets(
        lambda i: (torch.randn(n, n, device=dev, generator=gen).to(torch.bfloat16), b),
        2 * n * n, dev)
    flops = 2.0 * n ** 3
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        timing.verify_flops(torch.matmul, sets[0], flops)
        secs = timing.seconds_per_call(torch.matmul, sets, device=dev, target_s=target_s)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    return {"secs_per_step": secs, "tflops_per_sec": flops / secs / 1e12}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write the results here (default: no file)")
    ap.add_argument("--gemm_sizes", type=int, nargs="+", default=[2048, 4096, 8192])
    ap.add_argument("--skip_convs", action="store_true")
    ap.add_argument("--conv_names", nargs="+", default=[],
                    help="measure only these conv shapes")
    opts = ap.parse_args(argv)

    from visuelle2_tpu_torch.perf import convfloor_v2

    dev = resolve_device(None)
    results = {"device": timing.device_record(dev), "batch": BATCH, "method": timing.METHOD,
               "gemm_bf16": {}, "convs": {}}
    for n in opts.gemm_sizes:
        results["gemm_bf16"][str(n)] = measure_gemm(n, device=dev)
        print(json.dumps({f"gemm{n}": results["gemm_bf16"][str(n)]}), flush=True)
    if not opts.skip_convs:
        results.update(convfloor_v2.measure_convs(opts.conv_names, ("bf16",), device=dev))
    print(json.dumps(results), flush=True)
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"-> {opts.out}")
    return results


if __name__ == "__main__":
    main()
