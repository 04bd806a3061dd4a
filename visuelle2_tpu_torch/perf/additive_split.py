"""Where the additive attention kernel's time goes, on the card.

At the three CrossAttnRNN Demand calls (B=128, De=Dd=A=512, "projected";
L = 100 image patches, 52 trend steps, 4 fused tokens) this tool builds the
kernel from a source whole and in variants, each with one part removed, and
times each build two ways: the whole call (CUDA-event timing of replays of a
CUDA graph of calls, ``perf/timing.py``), and each of the call's launches
alone, as the profiler's device µs per record of each kernel name.

The source is ``csrc/additive_attention.cu`` unless ``--source`` names
another revision of it (with the same entry point, and the lines the
variants replace).  The variants:

* ``no_products``  — no wgmma issued: the operands' copies into shared
  memory, their split, the chunk sums' adds and the stores of h and s;
* ``no_loads``     — no cp.async of the operands (the splits and products
  run on whatever the raw stages hold): the splits, products and stores;
* ``no_fold``      — tanh(h + s)·v replaced by the plain sum of h + s;
* ``one_product``  — only the hi·hi product of the three: what the two
  correction products cost.

The variants compute wrong answers by design; they exist only to be timed.
``--baseline FILE`` also builds another revision's whole kernel (the same
entry point and arguments, any lines) and times the two whole calls in
turns at each length, baseline, this, this, baseline: a comparison within
one run.

    python -m visuelle2_tpu_torch.perf.additive_split [--source FILE] [--baseline FILE]

It runs on the card and raises "no CUDA device" without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import numpy as np
import torch

from visuelle2_tpu_torch._device import resolve_device
from visuelle2_tpu_torch.ops.cuda import _build
from visuelle2_tpu_torch.ops.cuda import additive_attention as taa
from visuelle2_tpu_torch.perf import timing, variants

SOURCE = _build.SRC_DIR / "additive_attention.cu"
_PRODUCTS = tuple(f"wgmma_tf32<BN>(acc, core_desc({a} + 64 * ks), core_desc({b} + 64 * ks), {d});"
                  for a, b, d in (("a_lo", "b_hi", "ks"), ("a_hi", "b_lo", "1"),
                                  ("a_hi", "b_hi", "1")))
VARIANTS = {
    "whole": (),
    "no_products": tuple((line, ";") for line in _PRODUCTS),
    "no_loads": (("cp_async16(dst, src, ok ? 16 : 0);", ""),
                 ("cp_async4(dst, src, ok ? 4 : 0);", "")),
    "no_fold": (("part0 = fmaf(v_s[a], tanhf(x + s_s[a]), part0);", "part0 += x + s_s[a];"),
                ("part1 = fmaf(v_s[a], tanhf(x + s_s[a]), part1);", "part1 += x + s_s[a];")),
    # hi·hi alone, its sum started at 0 as the first product's is.
    "one_product": ((_PRODUCTS[0], ";"), (_PRODUCTS[1], ";"),
                    (_PRODUCTS[2], _PRODUCTS[2].replace(", 1);", ", ks);"))),
}
SHAPE = dict(B=128, De=512, Dd=512, A=512, weight_on="projected")  # Demand's calls
LENGTHS = (100, 52, 4)


def variant_sources(text: str, source: Path = SOURCE) -> dict:
    """Each variant's source; raises if the kernel no longer holds a line a
    variant replaces."""
    return variants.variant_sources(text, VARIANTS, source)


def _inputs(L, dev):
    B, De, Dd, A = (SHAPE[k] for k in ("B", "De", "Dd", "A"))
    rng = np.random.default_rng(L)
    f = lambda *s, scale=1.0: torch.from_numpy(
        (rng.standard_normal(s) * scale).astype(np.float32)).to(dev)
    return [f(B, L, De), f(B, Dd), f(De, A, scale=De ** -0.5), f(Dd, A, scale=Dd ** -0.5),
            f(A, 1, scale=A ** -0.5), f(1)]


def _caller(lib, args, projected: bool):
    """A zero-argument call of the variant library's entry point on
    ``args``, with the wrapper's launch plan and buffers."""
    enc, dec, we, wd, v, vb = args
    B, L, De = enc.shape
    Dd, A = wd.shape
    fn = lib.v2t_additive_attention_f32
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    plan = taa.launch_plan(B, L, De, Dd, A, projected=projected, sms=_sms(enc.device))
    ptrs = (*args, *taa.buffers(enc, A, projected, plan))
    ints = (B, L, De, Dd, A, plan["ldh"], int(projected), plan["bn"], plan["smem_attend"])

    def call():
        stream = torch.cuda.current_stream(enc.device).cuda_stream  # the capture's
        code = fn(*(t.data_ptr() for t in ptrs), *ints, stream)
        if code:
            raise RuntimeError(f"additive_split: CUDA error {code}")

    return call


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def kernel_records_us(call, dev, n_calls: int = 50) -> dict:
    """Device µs per record of each kernel name ``call`` launches, from the
    profiler over ``n_calls`` calls (per record: the profiler can drop
    records in a window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    name = lambda key: key.replace("(anonymous namespace)::", "").split("(")[0].replace(
        "void ", "")[:48]
    call()
    torch.cuda.synchronize(dev)
    for _ in range(3):  # a window in which the profiler kept no record is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n_calls):
                call()
            torch.cuda.synchronize(dev)
        records = {name(e.key): e.self_device_time_total / e.count
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation and e.count}
        if records:
            break
    return records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", type=Path, default=SOURCE,
                    help="the additive-attention source to split (default: the checkout's)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another revision's source, its whole call timed in turns with this one's")
    ap.add_argument("--target_s", type=float, default=0.2)
    opts = ap.parse_args(argv)
    dev = resolve_device(None)
    kernels = {"additive": (opts.source, VARIANTS)}
    if opts.baseline:
        kernels["baseline"] = (opts.baseline, {"whole": ()})
    built = variants.build_variants(kernels)
    libs = built["additive"]
    results = {"device": timing.device_record(dev), "method": timing.METHOD,
               "source": str(opts.source), "baseline": opts.baseline and str(opts.baseline),
               "shape": SHAPE, "us": {}, "launch_us": {}, "turns_us": {}}
    print(json.dumps({k: results[k] for k in ("device", "source", "baseline")}), flush=True)
    projected = SHAPE["weight_on"] == "projected"
    for L in LENGTHS:
        args = _inputs(L, dev)
        call_us, launch_us = {}, {}
        for name, lib in libs.items():
            call = _caller(lib, args, projected)
            call_us[name] = 1e6 * timing.seconds_per_call(call, [()], device=dev,
                                                          target_s=opts.target_s)
            launch_us[name] = kernel_records_us(call, dev)
        results["us"][f"L={L}"] = call_us
        results["launch_us"][f"L={L}"] = launch_us
        if opts.baseline:
            calls = {"baseline": _caller(built["baseline"]["whole"], args, projected),
                     "whole": _caller(libs["whole"], args, projected)}
            results["turns_us"][f"L={L}"] = [
                (name, 1e6 * timing.seconds_per_call(calls[name], [()], device=dev,
                                                     target_s=opts.target_s))
                for name in ("baseline", "whole", "whole", "baseline")]
        print(json.dumps({f"L={L}": {"call_us": call_us, "launch_us": launch_us,
                                     "turns_us": results["turns_us"].get(f"L={L}")}}),
              flush=True)
    return results


if __name__ == "__main__":
    main()
