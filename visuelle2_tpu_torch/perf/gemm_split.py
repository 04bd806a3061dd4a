"""Where the probe GEMM kernel's time goes, on the card.

``csrc/probe_gemm.cu`` overlaps two pipelines: cp.async streaming x into
shared memory, and the warps' ldmatrix + mma.sync loop.  This tool builds
the kernel from the checkout's source whole and in three variants, each
with one part removed, and times all four at both probe shapes (CUDA
events around back-to-back launches, the inputs of ``perf.convfloor``):

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
from visuelle2_tpu_torch.perf import convfloor, timing

SOURCE = _build.SRC_DIR / "probe_gemm.cu"
VARIANTS = {
    "whole": (),
    "no_products": ((
        "mma(acc[i][j], a[i], &b[j >> 1][(j & 1) * 2]);",
        "acc[i][j][0] += (TAcc)(a[i][j & 3] ^ b[j >> 1][j & 3]);"),),
    "no_x_loads": (
        ("if (c + kStages - 1 < total) load_chunk(c + kStages - 1);", ""),
        ("if (s < total) load_chunk(s);", "")),
    "no_fragment_loads": (
        ("ldmatrix_x4(a[i], stage", "a[i][0] = a[i][1] = a[i][2] = a[i][3] = c + i;\n"
         "        if (0) ldmatrix_x4(a[i], stage"),
        ("ldmatrix_x4(b[j], wt_s", "b[j][0] = b[j][1] = b[j][2] = b[j][3] = c + j;\n"
         "        if (0) ldmatrix_x4(b[j], wt_s")),
}


def variant_sources(text: str) -> dict:
    """Each variant's source; raises if the kernel no longer holds a line
    a variant replaces."""
    out = {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"gemm_split: {name}: {old!r} is not in {SOURCE.name}")
            src = src.replace(old, new)
        out[name] = src
    return out


def _build_variants() -> dict:
    """One shared library per variant, built side by side into the build
    directory (one nvcc each)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, cmds, libs = _build._nvcc(), [], {}
    for name, src in variant_sources(SOURCE.read_text()).items():
        cu = _build.BUILD_DIR / f"split_{name}.cu"
        cu.write_text(src)
        libs[name] = _build.BUILD_DIR / f"split_{name}.so"
        cmds.append([nvcc, *_build.COMPILE_FLAGS, "-shared", str(cu), "-o", str(libs[name])])
    _build._run_all(cmds)
    return {name: ctypes.CDLL(str(path)) for name, path in libs.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--target_s", type=float, default=0.2)
    opts = ap.parse_args(argv)
    dev = resolve_device(None)
    libs = _build_variants()
    results = {"device": timing.device_record(dev), "method": timing.METHOD, "us": {}}
    for shape, s in convfloor.SHAPES.items():
        xb, wb, xi, wi, _ = convfloor.probe_inputs(device=dev, **s)
        for kind, x, w, out_dtype in (("bf16", xb, wb, torch.bfloat16),
                                      ("int8", xi, wi, torch.int32)):
            (m, k), n = x.shape, w.shape[1]
            smem = probe_gemm.smem_bytes(k, n, x.element_size())
            out = torch.empty(m, n, dtype=out_dtype, device=dev)
            row = {}
            for name, lib in libs.items():
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
