"""Per-shape conv roofline of the port's ResNet-101 backbone on the card,
with the epilogue and chain costs.

The port of ``scripts/perf_convfloor_v2.py``.  Each convolution runs as the
port's backbone runs it: ``models/resnet.py::_conv`` (``nn.Conv2d``, no
bias) on an NHWC tensor seen as NCHW, so channels_last memory, through
cuDNN, bf16 in and bf16 out.  The input stays the same from call to call
and streams from HBM on each, as in a forward pass: an input under 2x the
card's L2 is rotated over distinct copies (``timing.input_sets``).  Data
and weights are drawn on the card from seeded generators.

Where it differs from the JAX harness:

* The JAX harness asked XLA for an f32 output and counted 4 output bytes
  per element (``scripts/perf_convfloor_v2.py:172``); the port counts its
  own output dtype (bf16 or f32), since that is what its backbone writes.
* ``_verify_no_dce`` (``cost_analysis`` FLOPs) has no counterpart in eager
  mode, where nothing is eliminated; in its place each library call
  measured is run once under ``FlopCounterMode``, which must count the
  formula's FLOPs (``timing.verify_flops``).
* f32 (``--dtypes f32``) runs with TF32 off (``cudnn.allow_tf32 = False``),
  so it measures f32 convolutions and not TF32 ones.
* The epilogue is the port's own eval ``BatchNorm`` and ReLU
  (``models/resnet.py:31-47``), so ``epilogue_overhead_x`` is the cost of
  the unfused passes the port's forward pays.

    python -m visuelle2_tpu_torch.perf.convfloor_v2 [--out convfloor_v2.json]

It runs on the card and raises "no CUDA device" without one; it writes a
file only where ``--out`` says.
"""

from __future__ import annotations

import argparse
import json

import torch

from visuelle2_tpu_torch._device import resolve_device
from visuelle2_tpu_torch.models.resnet import BatchNorm, _conv
from visuelle2_tpu_torch.perf import timing
from visuelle2_tpu_torch.perf.roofline import BATCH, RESNET101_CONVS, conv_out_dim

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def conv_flops(hin, cin, cout, k, stride, batch=BATCH):
    hout = conv_out_dim(hin, k, stride)
    return 2.0 * batch * hout * hout * k * k * cin * cout


def _conv_module(cin, cout, k, stride, dtype, dev, gen):
    conv = _conv(cin, cout, k, stride, dtype).to(dev, memory_format=torch.channels_last)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, device=dev, generator=gen) * 0.05)
    return conv.requires_grad_(False)


def _nhwc_input(batch, hin, cin, dtype, dev, gen):
    """An NHWC activation seen as NCHW (channels_last), as the backbone's."""
    x = torch.randn(batch, hin, hin, cin, device=dev, generator=gen) * 0.5
    return (x.to(dtype).permute(0, 3, 1, 2),)


def _timed(fn, make, nbytes, flops, dev, target_s):
    """Seconds per call of ``fn`` over the input sets ``make`` gives, after
    the flop counter has checked one call."""
    sets = timing.input_sets(make, nbytes, dev)
    timing.verify_flops(fn, sets[0], flops)
    return timing.seconds_per_call(fn, sets, device=dev, target_s=target_s)


def measure_conv_shape(name, hin, cin, cout, k, stride, dtypes=("bf16",), target_s=1.5,
                       *, device=None, batch=BATCH):
    """One conv shape: per dtype its seconds per call, TF/s, and the least
    traffic (input read once, output written once) and its rate."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    flops = conv_flops(hin, cin, cout, k, stride, batch)
    hout = conv_out_dim(hin, k, stride)
    out = {"hin": hin, "cin": cin, "cout": cout, "k": k, "stride": stride,
           "gflops": flops / 1e9, "out_dim": hout}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dtype in dtypes:
            dt = DTYPES[dtype]
            itemsize = torch.finfo(dt).bits // 8
            conv = _conv_module(cin, cout, k, stride, dt, dev, gen)
            in_bytes = batch * hin * hin * cin * itemsize
            out_bytes = batch * hout * hout * cout * itemsize
            with torch.inference_mode():
                secs = _timed(conv, lambda i: _nhwc_input(batch, hin, cin, dt, dev, gen),
                              in_bytes, flops, dev, target_s)
            out[dtype] = {
                "secs": secs,
                "tflops_per_sec": flops / secs / 1e12,
                "min_traffic_mb": (in_bytes + out_bytes) / 2**20,
                "achieved_gbps": (in_bytes + out_bytes) / secs / 1e9,
            }
            print(f"{name}[{dtype}]: {out[dtype]['tflops_per_sec']:.1f} TF/s "
                  f"({secs * 1e3:.3f} ms, {out[dtype]['achieved_gbps']:.1f} GB/s "
                  f"over {out[dtype]['min_traffic_mb']:.1f} MB min traffic)", flush=True)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return out


def measure_convs(conv_names=(), dtypes=("bf16",), target_s=1.5, *, device=None):
    """Every ResNet-101 shape (or those named) and the FLOP-weighted totals
    of one forward at ``BATCH``: ``{"convs": ..., "conv_weighted_<dtype>": ...}``."""
    res = {"convs": {}}
    for name, hin, cin, cout, k, stride, count in RESNET101_CONVS:
        if conv_names and name not in conv_names:
            continue
        r = measure_conv_shape(name, hin, cin, cout, k, stride, dtypes, target_s,
                               device=device)
        r["count"] = count
        res["convs"][name] = r
    for dtype in dtypes:
        have = [r for r in res["convs"].values() if dtype in r]
        if not have:
            continue
        gflops = sum(r["gflops"] * r["count"] for r in have)
        secs = sum(r[dtype]["secs"] * r["count"] for r in have)
        res[f"conv_weighted_{dtype}"] = {
            "shapes_measured": len(have),
            "total_gflops_per_batch": gflops,
            "sum_secs_per_batch_ms": secs * 1e3,
            "flop_weighted_tflops_per_sec": gflops / secs / 1e3,
        }
        print(json.dumps({f"conv_weighted_{dtype}": res[f"conv_weighted_{dtype}"]}),
              flush=True)
    return res


def measure_artifact_check(target_s=1.5, *, device=None, batch=BATCH):
    """One shape timed as measured here and as the r3 harness did it (the
    input kept in f32, scaled and cast to bf16 before every conv): the size
    of the artifact ``scripts/perf_convfloor_v2.py`` corrected."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    name, hin, cin, cout, k, stride = "s2_1x1a_wide", 38, 512, 128, 1, 1
    flops = conv_flops(hin, cin, cout, k, stride, batch)
    conv = _conv_module(cin, cout, k, stride, torch.bfloat16, dev, gen)
    nbytes = batch * hin * hin * cin

    def r3_input_perturb(xf):
        return conv((xf * (1.0 + 1e-6)).to(torch.bfloat16))

    with torch.inference_mode():
        corrected = _timed(conv, lambda i: _nhwc_input(batch, hin, cin, torch.bfloat16, dev,
                                                       gen),
                           2 * nbytes, flops, dev, target_s)
        legacy = _timed(r3_input_perturb,
                        lambda i: _nhwc_input(batch, hin, cin, torch.float32, dev, gen),
                        4 * nbytes, flops, dev, target_s)
    res = {"shape": name,
           "corrected": {"secs": corrected, "tflops_per_sec": flops / corrected / 1e12},
           "r3_input_perturb_f32base": {"secs": legacy,
                                        "tflops_per_sec": flops / legacy / 1e12},
           "inflation_x": legacy / corrected}
    print(f"artifact_check[{name}]: corrected "
          f"{res['corrected']['tflops_per_sec']:.1f} TF/s vs r3 harness "
          f"{res['r3_input_perturb_f32base']['tflops_per_sec']:.1f} TF/s "
          f"(inflation {res['inflation_x']:.2f}x)", flush=True)
    return res


def measure_epilogue_and_chain(target_s=1.5, *, device=None, batch=BATCH):
    """conv against conv + the port's eval BatchNorm + ReLU, and a
    bottleneck-like conv -> BN -> ReLU -> conv chain against the sum of its
    two convs alone: the inter-layer cost a per-shape roofline cannot see."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    hin, cin, cmid = 38, 512, 128
    dt = torch.bfloat16
    conv1 = _conv_module(cin, cmid, 1, 1, dt, dev, gen)
    conv2 = _conv_module(cmid, cin, 1, 1, dt, dev, gen)
    bn1 = BatchNorm(cmid, dt).to(dev)
    with torch.no_grad():
        bn1.weight.copy_(1.0 + 0.01 * torch.randn(cmid, device=dev, generator=gen))
        bn1.bias.copy_(0.01 * torch.randn(cmid, device=dev, generator=gen))
    f1 = conv_flops(hin, cin, cmid, 1, 1, batch)
    f2 = conv_flops(hin, cmid, cin, 1, 1, batch)

    def with_epi(x):
        return torch.relu(bn1(conv1(x)))

    def chain(x):
        return conv2(torch.relu(bn1(conv1(x))))

    def make(c):
        return lambda i: _nhwc_input(batch, hin, c, dt, dev, gen)

    n1, nm = 2 * batch * hin * hin * cin, 2 * batch * hin * hin * cmid
    with torch.inference_mode():
        s_bare = _timed(conv1, make(cin), n1, f1, dev, target_s)
        s_epi = _timed(with_epi, make(cin), n1, f1, dev, target_s)
        s_chain = _timed(chain, make(cin), n1, f1 + f2, dev, target_s)
        s_l2 = _timed(conv2, make(cmid), nm, f2, dev, target_s)
    res = {"shape": f"{hin}x{hin} {cin}->{cmid}->{cin} 1x1s",
           "conv_secs": s_bare,
           "conv_bn_relu_secs": s_epi,
           "epilogue_overhead_x": s_epi / s_bare,
           "chain_secs": s_chain,
           "sum_isolated_secs": s_bare + s_l2,
           "chain_over_sum_x": s_chain / (s_bare + s_l2)}
    print(f"epilogue: conv {s_bare * 1e3:.3f} ms vs conv+bn+relu {s_epi * 1e3:.3f} ms "
          f"({res['epilogue_overhead_x']:.3f}x); chain {s_chain * 1e3:.3f} ms vs sum "
          f"{1e3 * (s_bare + s_l2):.3f} ms ({res['chain_over_sum_x']:.3f}x)", flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write the results here (default: no file)")
    ap.add_argument("--target_s", type=float, default=1.5)
    ap.add_argument("--conv_names", nargs="+", default=[],
                    help="measure only these shapes")
    ap.add_argument("--dtypes", nargs="+", default=["bf16"], choices=sorted(DTYPES))
    ap.add_argument("--skip_extras", action="store_true",
                    help="skip the artifact/epilogue/chain extras")
    opts = ap.parse_args(argv)

    dev = resolve_device(None)
    results = {"device": timing.device_record(dev), "batch": BATCH,
               "method": timing.METHOD + "; flop counter checks each library call",
               **measure_convs(opts.conv_names, tuple(opts.dtypes), opts.target_s,
                               device=dev)}
    if not opts.skip_extras:
        results["artifact_check"] = measure_artifact_check(opts.target_s, device=dev)
        results["epilogue_chain"] = measure_epilogue_and_chain(opts.target_s, device=dev)
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"-> {opts.out}")
    return results


if __name__ == "__main__":
    main()
