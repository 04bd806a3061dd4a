"""Where the persistent GRU kernel's time goes, on the card.

``csrc/gru_seq.cu`` runs the whole recurrence in one launch; each step a
block reads the previous h tile from L2, walks its shared-memory W_h slice
in f32 FMAs, writes h and meets the other blocks of its row group at a
counter barrier.  This tool builds the kernel from the checkout's source
whole and in variants, each with one part removed, and times them at the
CrossAttnRNN trend GRU's shape (B=128, T=52, H=512; CUDA-event timing of
replays of a CUDA graph of calls, ``perf/timing.py``; each call zeroes the
barrier's counters, as the wrapper does):

* ``no_barrier``  — no wait at the step barrier (the blocks still arrive):
  the steps' own work without the wait for the slowest block;
* ``no_h_loads``  — the h tile not read from L2 (zeros are stored instead);
* ``no_w_loads``  — the W_h slice not read from shared memory inside the
  products (the FMAs run on values held in registers): the FMA issue and the
  h reads alone;
* ``no_products`` — the product loop removed: the loads, the epilogue and
  the barrier alone.

The variants compute wrong answers by design; they exist only to be timed.
The whole kernel's outputs are printed as a SHA-256 digest: ``--source``
builds another revision of ``csrc/gru_seq.cu`` instead (with the same entry
point), so that two revisions can be held to the same bits and timed in one
run.

    python -m visuelle2_tpu_torch.perf.gru_split [--source FILE]

It runs on the card and raises "no CUDA device" without one.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from visuelle2_tpu_torch._device import resolve_device
from visuelle2_tpu_torch.ops.cuda import _build, gru_seq
from visuelle2_tpu_torch.perf import timing, variants

SOURCE = _build.SRC_DIR / "gru_seq.cu"
VARIANTS = {
    "whole": (),
    "no_barrier": (("while (load_acquire(counter) < target) {",
                    "while (false && load_acquire(counter) < target) {"),),
    "no_h_loads": (("r < nrows ? __ldcg(reinterpret_cast<const float4*>",
                    "false ? __ldcg(reinterpret_cast<const float4*>"),),
    "no_w_loads": (("const float4 w = w4[(q * 3 + g) * kUnits + tx];",
                    "const float4 w = make_float4(tx, ty, g, q);"),),
    "no_products": (("for (int q = 0; q < nq; ++q) {", "for (int q = 0; q < 0; ++q) {"),),
}
SHAPE = dict(B=128, T=52, I=3, H=512)  # the trend GRU's


def variant_sources(text: str, source: Path = SOURCE) -> dict:
    """Each variant's source; raises if the kernel no longer holds a line a
    variant replaces."""
    return variants.variant_sources(text, VARIANTS, source)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", type=Path, default=SOURCE,
                    help="the GRU kernel source to split (default: the checkout's)")
    ap.add_argument("--target_s", type=float, default=0.2)
    opts = ap.parse_args(argv)
    dev = resolve_device(None)
    libs = variants.build_variants({"gru": (opts.source, VARIANTS)})["gru"]
    B, T, I, H = (SHAPE[k] for k in "BTIH")
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(
        rng.uniform(-H ** -0.5, H ** -0.5, s).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.random((B, T, I)).astype(np.float32)).to(dev)
    w_i, w_h, b_i, b_h = f(I, 3 * H), f(H, 3 * H), f(3 * H), f(3 * H)
    gi = torch.addmm(b_i, x.reshape(B * T, I), w_i).reshape(B, T, 3 * H)
    h0, outs, h_last = x.new_zeros(B, H), x.new_empty(B, T, H), x.new_empty(B, H)
    counters = torch.zeros(-(-B // gru_seq._ROWS), dtype=torch.int32, device=dev)
    smem = gru_seq.smem_bytes(H)
    results = {"device": timing.device_record(dev), "method": timing.METHOD, "shape": SHAPE,
               "source": str(opts.source), "us": {}}
    for name, lib in libs.items():
        fn = lib.v2t_fused_gru_sequence_f32
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call(fn=fn, name=name):
            counters.zero_()
            stream = torch.cuda.current_stream(dev).cuda_stream  # the capture's
            code = fn(gi.data_ptr(), w_h.data_ptr(), b_h.data_ptr(), h0.data_ptr(),
                      outs.data_ptr(), h_last.data_ptr(), counters.data_ptr(), B, T, H, smem,
                      stream)
            if code:
                raise RuntimeError(f"gru_split: {name}: CUDA error {code}")

        if name == "whole":
            call()
            torch.cuda.synchronize(dev)
            results["whole_outs_sha256"] = hashlib.sha256(
                outs.cpu().numpy().tobytes() + h_last.cpu().numpy().tobytes()).hexdigest()
        results["us"][name] = 1e6 * timing.seconds_per_call(call, [()], device=dev,
                                                            target_s=opts.target_s)
    print(json.dumps({k: results[k] for k in ("device", "source", "whole_outs_sha256", "us")}),
          flush=True)
    return results


if __name__ == "__main__":
    main()
