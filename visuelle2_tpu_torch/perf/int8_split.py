"""Where ``int8_conv``'s time goes, on the card.

Builds ``csrc/int8_conv.cu`` whole and in variants, each with one part
removed, and times them (CUDA events around 20 calls after 3 warm-up
calls) at the w8a8 ResNet-101's launch shapes at B = 128 that lose the
most against their bound, with the tiling ``launch_plan`` picks and with
each other one the kernel has for the shape (``TILE_PLANS``: the column
tile, cooperative or ping-pong):

* ``no_epilogue`` — no epilogue (the sums kept live behind a test they all
  but never pass): the loads, the ring and the products alone;
* ``no_stores``   — the epilogue without its int8 stores (kept behind such a
  test): everything but the output's writes;
* ``no_epilogue_loads`` — the epilogue's arithmetic and stores without its
  loads: m, z, the addend and the identity shortcut replaced by values in
  registers (the ratio, the row), which the compiler cannot fold;
* ``no_products`` — no wgmma issued (a descriptor folded into the sums):
  the loads, the ring and the epilogue;
* ``no_a_loads``  — no copy of the activation (TMA: B's tile alone; the
  gathers: no cp.async, the stage's barrier arrived on without bytes).

The variants compute wrong answers by design; they exist only to be timed.

    python -m visuelle2_tpu_torch.perf.int8_split [--shapes all]

It runs on the card and raises "no CUDA device" without one.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json

import torch

from visuelle2_tpu_torch.models import quantized_resnet as qr
from visuelle2_tpu_torch.models.resnet import STAGE_BLOCKS
from visuelle2_tpu_torch.ops.cuda import _build, roofline
from visuelle2_tpu_torch.ops.cuda import int8_conv as ic
from visuelle2_tpu_torch.perf import variants

SOURCE = _build.SRC_DIR / "int8_conv.cu"
VARIANTS = {
    "whole": [],
    "no_epilogue": [(
        """#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (small_k)
        epilogue<BN, true>(acc[mt], sc[mt], p, row0 + 64 * mt, n0, ratio);
      else
        epilogue<BN, false>(acc[mt], sc[mt], p, row0 + 64 * mt, n0, ratio);
    }""",
        """    if (acc[0][0] == 0x7fffffff && acc[MT - 1][BN / 2 - 1] == 0x7fffffff && ratio == 3.f)
      static_cast<int*>(p.out)[row0] = small_k + sc[0][0][0].x;""")],
    "no_stores": [(
        """      if (in)
        *reinterpret_cast<uint2*>(static_cast<int8_t*>(p.out)""",
        """      if (in && w[0] == 0x12345678u && w[3] == 0x9abcdef0u)
        *reinterpret_cast<uint2*>(static_cast<int8_t*>(p.out)""")],
    "no_epilogue_loads": [
        ("""      mm[e] = __ldg(reinterpret_cast<const float2*>(p.mul + col));
      zz[e] = __ldg(reinterpret_cast<const float2*>(p.add + col));""",
         """      mm[e] = make_float2(ratio, ratio);
      zz[e] = make_float2(ratio, __int_as_float(col));"""),
        ("""          ad[h][e] = row0 + 8 * h < p.M
                         ? __ldg(reinterpret_cast<const float2*>(
                               p.addend + (long long)(row0 + 8 * h) * p.Cout + n0 +
                               8 * (4 * jj + e) + 2 * q))
                         : make_float2(0.f, 0.f);""",
         """          ad[h][e] = make_float2(ratio, __int_as_float(row0 + h));"""),
        ("""            sc[mt][h][jj] = row < p.M ? __ldg(reinterpret_cast<const uint2*>(
                                            p.shortcut + (long long)row * p.Cout + n0 +
                                            32 * jj + 8 * q))
                                      : make_uint2(0u, 0u);""",
         """            sc[mt][h][jj] = make_uint2(row, row + n0 + jj);""")],
    "no_products": [(
        "wgmma_s8<BN>(acc[mt], a_desc + 512 * mt + 2 * kk, b_desc + 2 * kk, kc | kk);",
        "acc[mt][kk] ^= static_cast<int>(a_desc + b_desc);")],
    "no_a_loads": [
        ("""      mbar_arrive_expect_tx(full, kStageBytes);
      tma_load_2d(a_map, stage, full, kc * kChunk, tl.mt * BM);""",
         """      mbar_arrive_expect_tx(full, BN * kChunk);"""),
        ("cp_async16(stage + swz + 2048 * i, src, ok ? 16 : 0);", "(void)src;"),
        ("cp_async4(dst + 64 * kChunk * i, ok ? origin[i] + e.y : p.x, ok ? 4 : 0);",
         "(void)ok;")],
}
# The shapes that lose the most a forward (launches x (time - bound)) in the
# mma.sync design and in this one's first runs.
SHAPES = [
    (19, 19, 256, 1024, 1, 1, 0, "requant_add_identity"),
    (19, 19, 256, 256, 3, 1, 1, "requant"),
    (19, 19, 1024, 256, 1, 1, 0, "requant"),
    (75, 75, 64, 256, 1, 1, 0, "requant_add_identity"),
    (75, 75, 64, 64, 1, 1, 0, "requant"),
    (75, 75, 64, 64, 3, 1, 1, "requant"),
    (299, 299, qr.STEM_CIN, 64, 7, 2, 3, "requant"),
]
B = 128


def inputs(shape, gen, dev):
    """Seeded inputs of a launch shape at batch B (as chip_smoke.py's)."""
    h, w, cin, cout, k, stride, pad, epilogue = shape
    x = torch.randint(0, 128, (B, h, w, cin), generator=gen, dtype=torch.int8)
    wt = ic.pack_weight(torch.randint(-127, 128, (cout, cin, k, k), generator=gen,
                                      dtype=torch.int8))
    m = (torch.rand(cout, generator=gen) + 0.5) * (60.0 / ((k * k * cin) ** 0.5 * 70 * 73))
    z = torch.rand(cout, generator=gen) * 40 - 10
    ho = ic.out_size(h, k, stride, pad)
    ops = dict(addend=None, shortcut=None, ratio=None)
    if epilogue == "requant_add":
        ops["addend"] = torch.rand(B, ho, ho, cout, generator=gen).to(dev)
    elif epilogue == "requant_add_identity":
        ops["shortcut"] = torch.randint(0, 128, (B, ho, ho, cout), generator=gen,
                                        dtype=torch.int8).to(dev)
        ops["ratio"] = torch.tensor(0.5, device=dev)
    out = torch.empty(B, ho, ho, cout, device=dev,
                      dtype=torch.float32 if epilogue == "float" else torch.int8)
    return [t.to(dev) for t in (x, wt, m, z)], ops, out


def time_us(fn, n=20):
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(end) / n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="worst", choices=("worst", "all"))
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants to build and time")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    dev = torch.device("cuda")
    chosen_variants = {k: VARIANTS[k] for k in opts.variants.split(",")}
    libs = variants.build_variants({"int8_conv": (SOURCE, chosen_variants)})["int8_conv"]
    fns = {}
    for name, lib in libs.items():
        fn = lib.v2t_int8_conv
        fn.argtypes = ic._kernel()[1].argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    per = collections.Counter(c[1:] for c in qr.conv_launches(STAGE_BLOCKS["resnet101"], 299))
    shapes = sorted(per) if opts.shapes == "all" else SHAPES
    gen = torch.Generator().manual_seed(17)
    rows = {}
    plan = ic.launch_plan
    for shape in shapes:
        h, w, cin, cout, k, stride, pad, epilogue = shape
        args, ops, out = inputs(shape, gen, dev)
        work_cin = qr.IMAGE_CIN if cin == qr.STEM_CIN else cin  # the stem's pad: no work
        n_bytes, n_ops = roofline.int8_conv_cost(B, h, w, work_cin, cout, k, stride, pad,
                                                 epilogue)
        bound_ms, bound_by = roofline.bound_ms(n_bytes, n_ops, "int8")
        chosen, coop = plan(cout, k, stride, epilogue)
        row = {"launches_per_forward": per[shape], "bound_us": 1e3 * bound_ms,
               "bound_by": bound_by, "tile_n": chosen, "coop": coop, "us": {}}
        for bn, co in ic.TILE_PLANS[ic.producer_mode(cin, k, stride, pad)]:
            if cout % bn:
                continue
            ic.launch_plan = lambda *args_, bn=bn, co=co: (bn, co)
            tiling = f"{bn}{'' if co else 'pp'}"
            try:
                for name, fn in fns.items():
                    call_args = ic.launch_args(*args, k, stride, pad, epilogue, ops["addend"],
                                               ops["shortcut"], ops["ratio"], out)
                    code = fn(*call_args)
                    _build.check(libs[name], code, f"int8_conv {name}")
                    row["us"][f"{name}@{tiling}"] = time_us(lambda: fn(*call_args))
            finally:
                ic.launch_plan = plan
        rows[str(list(shape))] = row
        print(json.dumps({str(list(shape)): row}), flush=True)
        del args, ops, out
        torch.cuda.empty_cache()
    print(json.dumps({"card": torch.cuda.get_device_name(0), "batch": B,
                      "keys": "variant@BN, 'pp' after BN for ping-pong",
                      "timing": "CUDA events around 20 calls after 3 warm-up calls",
                      "shapes": rows}))
    return rows


if __name__ == "__main__":
    main()
