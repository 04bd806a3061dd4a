"""Where the probe GEMM kernels' time goes, on the card.

Each probe GEMM overlaps two pipelines, one streaming x into shared memory
and one running the tensor cores.  This tool builds each kernel from the
checkout's source whole and in variants, each with one part removed, and
times them all at both probe shapes (CUDA-event timing of replays of a CUDA
graph of calls, ``perf/timing.py``, on the inputs of ``perf.convfloor``).

bf16, ``csrc/probe_gemm_bf16.cu`` (TMA ring, wgmma):

* ``no_wgmma``   — no wgmma issued (a descriptor is folded into the sums
  instead): the TMA ring, the barriers and the epilogue's stores alone;
* ``no_x_loads`` — no TMA load of x (each stage's barrier is arrived on
  without bytes, the products run on whatever the ring holds): the
  tensor-core loop and the stores alone;
* ``no_stores``  — the epilogue's stores of out skipped (kept behind a test
  the rounded sums all but never pass, so the products stay live): the
  loads and products.

int8, ``csrc/probe_gemm.cu`` (cp.async ring, ldmatrix + mma.sync):

* ``no_products``        — each mma.sync replaced by an xor of its
  fragments into the sums, so the loads stay live: the memory pipeline and
  the fragment loads alone;
* ``no_x_loads``         — no cp.async of x (the products run on whatever
  shared memory holds): the tensor-core loop alone;
* ``no_fragment_loads``  — ldmatrix replaced by constants: the memory
  pipeline and the products without the shared-memory reads.

The variants compute wrong answers by design; they exist only to be timed.

    python -m visuelle2_tpu_torch.perf.gemm_split

It runs on the card and raises "no CUDA device" without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from visuelle2_tpu_torch._device import resolve_device
from visuelle2_tpu_torch.ops.cuda import _build, probe_gemm
from visuelle2_tpu_torch.perf import convfloor, timing, variants

SOURCES = {"bf16": _build.SRC_DIR / "probe_gemm_bf16.cu",
           "int8": _build.SRC_DIR / "probe_gemm.cu"}
VARIANTS = {
    "bf16": {
        "whole": (),
        "no_wgmma": ((
            "wgmma_tile<NW>(acc, a_desc + 2 * kk, b_desc + 128 * kk, kc | kk);",
            "acc[kk] += (float)(uint32_t)(a_desc + b_desc + kk);"),),
        "no_x_loads": (
            ("mbar_arrive_expect_tx(full_bar, kStageBytes);", "mbar_arrive(full_bar);"),
            ("tma_load_2d(&x_map, x_s + s * kStageBytes, full_bar, kc * kChunkK, tile * BM);",
             "")),
        "no_stores": ((
            "if (row < M) *reinterpret_cast<uint4*>",
            "if (row < M && w[0] == 0x12345u) *reinterpret_cast<uint4*>"),),
    },
    "int8": {
        "whole": (),
        "no_products": ((
            "mma(acc[i][j], a[i], &b[j >> 1][(j & 1) * 2]);",
            "acc[i][j][0] += (int)(a[i][j & 3] ^ b[j >> 1][j & 3]);"),),
        "no_x_loads": (
            ("if (c + kStages - 1 < total) load_chunk(c + kStages - 1);", ""),
            ("if (s < total) load_chunk(s);", "")),
        "no_fragment_loads": (
            ("ldmatrix_x4(a[i], stage", "a[i][0] = a[i][1] = a[i][2] = a[i][3] = c + i;\n"
             "        if (0) ldmatrix_x4(a[i], stage"),
            ("ldmatrix_x4(b[j], wt_s", "b[j][0] = b[j][1] = b[j][2] = b[j][3] = c + j;\n"
             "        if (0) ldmatrix_x4(b[j], wt_s")),
    },
}


def variant_sources(kind: str, text: str) -> dict:
    """Each variant's source of the ``kind`` kernel ("bf16" or "int8") from
    its source ``text``; raises if the kernel no longer holds a line a
    variant replaces."""
    return variants.variant_sources(text, VARIANTS[kind], SOURCES[kind])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--target_s", type=float, default=0.2)
    opts = ap.parse_args(argv)
    dev = resolve_device(None)
    libs = variants.build_variants({kind: (SOURCES[kind], VARIANTS[kind]) for kind in SOURCES})
    results = {"device": timing.device_record(dev), "method": timing.METHOD, "us": {}}
    for shape, s in convfloor.SHAPES.items():
        xb, wb, xi, wi, _ = convfloor.probe_inputs(device=dev, **s)
        for kind, x, w, out_dtype in (("bf16", xb, wb, torch.bfloat16),
                                      ("int8", xi, wi, torch.int32)):
            (m, k), n = x.shape, w.shape[1]
            smem = probe_gemm.smem_bytes(k, n, x.element_size())
            out = torch.empty(m, n, dtype=out_dtype, device=dev)
            row = {}
            for name, lib in libs[kind].items():
                fn = getattr(lib, f"v2t_probe_matmul_{kind}")
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int

                def call(fn=fn, name=name):
                    stream = torch.cuda.current_stream(dev).cuda_stream  # the capture's
                    code = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, smem, stream)
                    if code:
                        raise RuntimeError(f"gemm_split: {name}/{kind}: CUDA error {code}")

                secs = timing.seconds_per_call(call, [()], device=dev, target_s=opts.target_s)
                row[name] = 1e6 * secs
            results["us"][f"{shape}/{kind}"] = row
            print(json.dumps({f"{shape}/{kind}": row}), flush=True)
    return results


if __name__ == "__main__":
    main()
