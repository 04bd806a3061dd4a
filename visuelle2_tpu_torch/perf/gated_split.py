"""Where the gated kernels' time goes, on the card, and their times against
another revision of them.

At gated_v2's two ``fused_gated_mha`` calls ("head": the trend encoder's
self-attention, B=128, Lq=Lk=52, D=64, 4 heads, query, key and value one
tensor; "pure": the decoder's cross-attention, Lq=1, Lk=52, key and value
one tensor) and gated_v4's ``fused_gated_residual`` call (B=128, D=32,
C=128), this tool builds the two kernels' sources whole and in variants,
each with one part removed, and times each build through the wrappers of
the same checkout, with the variant's library in place of the package's:
as the profiler's device µs per launch, and as µs per call from CUDA-event
timing of replays of a CUDA graph of calls (``perf/timing.py``), both on
the same inputs, made from a seed.  The whole kernels are also timed at
B = 8 ("head_B8", "pure_B8"), where the gated MHA kernel's 32 CTAs take
at most one SM each: the latency of one CTA's chain of phases.

``--root DIR`` takes the sources (``csrc/gated_mha.cu``, ``csrc/gated_fusion.cu``)
and the wrappers (``ops/cuda/gated_mha.py``, ``ops/cuda/gated_fusion.py``)
of the ``visuelle2_tpu_torch`` package under DIR, another revision's
checkout for instance, in place of this one's: the wrappers are loaded from
their files, so each revision runs with its own launch plan and entry
points.  To compare two revisions on one card, run the tool in one call for
each in turns: the other, this, this, the other.

The variants (``VARIANTS``, for this checkout's sources; ``--variants FILE``
reads another table, a JSON object of variant name -> {source file name:
[[line, replacement], ...]}):

* ``no_staging``     — no copies into shared memory (inputs, weight slices,
  biases, mask rows, Wo's rows): the products run on what it holds;
* ``no_projections`` — no q, k, v or pure-gate projections;
* ``no_attention``   — no scores, softmax or probabilities·v;
* ``no_gate``        — no gate: the context goes to the output product as it is;
* ``no_output``      — no output product;
* ``no_reduce``      — no sum of the cluster's partial outputs (no store);
* ``no_products``    — the gated residual without its two products.

A variant times only the kernels whose source it edits.  The variants
compute wrong answers by design; they exist only to be timed.

    python -m visuelle2_tpu_torch.perf.gated_split [--root DIR] [--variants FILE] [--whole]

It runs on the card and raises "no CUDA device" without one.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import types
from pathlib import Path

import numpy as np
import torch

from visuelle2_tpu_torch._device import resolve_device
from visuelle2_tpu_torch.ops.cuda import _build
from visuelle2_tpu_torch.perf import timing, variants
from visuelle2_tpu_torch.perf.additive_split import kernel_records_us

MHA, FUSION = "gated_mha.cu", "gated_fusion.cu"
VARIANTS = {
    "whole": {},
    "no_staging": {MHA: [("for (int r = first; r < rows_pad && first < step; r += step) {",
                          "for (int r = first; r < 0; r += step) {")]},
    "no_projections": {MHA: [("const int total = tq + 2 * tk + (head_gate ? 0 : tq);",
                              "const int total = 0;")]},
    "no_attention": {MHA: [("for (int i0 = 0; i0 < Lq; i0 += p.qb) {",
                            "for (int i0 = Lq; i0 < Lq; i0 += p.qb) {")]},
    "no_gate": {MHA: [("const int total = tq + 2 * tk + (head_gate ? 0 : tq);",
                       "const int total = tq + 2 * tk;"),
                      ("const int per_g = head_gate ? nrt * ntd : 0;", "const int per_g = 0;"),
                      ("*m = acc[i][j] * inv * *m;", "*m = acc[i][j] * inv;")]},
    "no_output": {MHA: [("const int nto = (D + 3) / 4, total = (Lq + 3) / 4 * nto;",
                         "const int nto = (D + 3) / 4, total = 0;")]},
    "no_reduce": {MHA: [("for (int i = tid; i < Lq * W; i += T) {",
                         "for (int i = tid; i < 0; i += T) {")]},
    "no_products": {FUSION: [("for (; k < D; k += S) {", "for (k = D; k < D; k += S) {"),
                             ("for (k -= D; k < C; k += S) {", "for (k = C; k < C; k += S) {")]},
}
HEAD = dict(B=128, Lq=52, Lk=52, D=64, heads=4, variant="head")
PURE = dict(B=128, Lq=1, Lk=52, D=64, heads=4, variant="pure")
RESIDUAL = dict(B=128, D=32, C=128)
SPLIT_CALLS = ("head", "pure", "residual")  # the calls a variant is timed at
LONE_B = 8  # the whole kernels also at B = 8: at most one CTA an SM, the card else idle


def _load_wrapper(root: Path, name: str):
    """``ops/cuda/<name>.py`` of the package under ``root``, loaded from its
    file as a module of its own."""
    path = root / "visuelle2_tpu_torch" / "ops" / "cuda" / f"{name}.py"
    tag = hashlib.sha256(str(path.resolve()).encode()).hexdigest()[:8]
    spec = importlib.util.spec_from_file_location(f"_gated_split_{name}_{tag}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def variant_sources(root: Path, table: dict) -> dict:
    """name -> {source file name: source text}: each variant's edits of the
    two sources under ``root``; raises if a source lacks a line an edit
    replaces."""
    csrc = root / "visuelle2_tpu_torch" / "csrc"
    texts = {f: (csrc / f).read_text() for f in (MHA, FUSION)}
    return {name: {f: variants.variant_sources(texts[f], {name: edits.get(f, ())}, csrc / f)[name]
                   for f in texts}
            for name, edits in table.items()}


def build(sources: dict) -> dict:
    """One shared library per variant from its two sources, one nvcc each,
    all side by side; a library whose sources were built before is loaded
    as it is.  name -> library."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, cmds, paths = _build._nvcc(), [], {}
    for name, texts in sources.items():
        h = hashlib.sha256("".join(texts[f] for f in sorted(texts)).encode()).hexdigest()[:16]
        paths[name] = _build.BUILD_DIR / f"gated_split_{h}.so"
        if paths[name].exists():
            continue
        files = []
        for f, text in texts.items():
            files.append(_build.BUILD_DIR / f"gated_split_{h}_{f}")
            files[-1].write_text(text)
        cmds.append([nvcc, *_build.COMPILE_FLAGS, "-shared", *map(str, files), "-o",
                     str(paths[name])])
    _build._run_all(cmds)
    return {name: ctypes.CDLL(str(path)) for name, path in paths.items()}


def _mha_args(shape, dev):
    rng = np.random.default_rng(0)
    f = lambda *s, scale=1.0: torch.from_numpy(
        (rng.standard_normal(s) * scale).astype(np.float32)).to(dev)
    B, Lq, Lk, D = (shape[k] for k in ("B", "Lq", "Lk", "D"))
    query = f(B, Lq, D)
    kv = query if Lq == Lk else f(B, Lk, D)
    G = D // shape["heads"] if shape["variant"] == "head" else D
    weights = []
    for n in (D, D, D, G, D):
        weights += [f(n, n, scale=n ** -0.5), f(n, scale=0.1)]
    return [query, kv, kv, torch.zeros(Lq, Lk, device=dev), *weights]


def _residual_args(shape, dev):
    rng = np.random.default_rng(0)
    B, D, C = shape["B"], shape["D"], shape["C"]
    f = lambda *s, scale=1.0: torch.from_numpy(
        (rng.standard_normal(s) * scale).astype(np.float32)).to(dev)
    return [f(B, D), f(B, C), f(D, D, scale=0.1), f(C, D, scale=0.1), f(D)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=_build.SRC_DIR.parents[1],
                    help="the checkout whose kernels and wrappers are timed (default: this one)")
    ap.add_argument("--variants", type=Path, default=None,
                    help="a JSON variant table for the sources under --root")
    ap.add_argument("--whole", action="store_true", help="time the whole kernels only")
    ap.add_argument("--target_s", type=float, default=0.2)
    opts = ap.parse_args(argv)
    dev = resolve_device(None)
    table = json.loads(opts.variants.read_text()) if opts.variants else VARIANTS
    table = {"whole": {}} if opts.whole else {"whole": {}, **table}
    libs = build(variant_sources(opts.root, table))
    mha_mod, fusion_mod = (_load_wrapper(opts.root, n) for n in ("gated_mha", "gated_fusion"))
    calls = {
        "head": (mha_mod, MHA, "fused_gated_mha", _mha_args(HEAD, dev),
                 dict(num_heads=HEAD["heads"], variant="head")),
        "pure": (mha_mod, MHA, "fused_gated_mha", _mha_args(PURE, dev),
                 dict(num_heads=PURE["heads"], variant="pure")),
        "residual": (fusion_mod, FUSION, "fused_gated_residual",
                     _residual_args(RESIDUAL, dev), {}),
    }
    for call, shape in (("head", HEAD), ("pure", PURE)):  # whole only: a CTA's latency
        calls[f"{call}_B{LONE_B}"] = (mha_mod, MHA, "fused_gated_mha",
                                      _mha_args(dict(shape, B=LONE_B), dev),
                                      dict(num_heads=shape["heads"], variant=call))
    results = {"device": timing.device_record(dev), "root": str(opts.root),
               "method": timing.METHOD, "shapes": {"head": HEAD, "pure": PURE,
                                                   "residual": RESIDUAL}, "us": {}}
    print(json.dumps({k: results[k] for k in ("device", "root")}), flush=True)
    for name, lib in libs.items():
        row = {}
        for call, (module, source, fn_name, args, kw) in calls.items():
            if name != "whole" and (source not in table[name] or call not in SPLIT_CALLS):
                continue
            module._build = types.SimpleNamespace(load_library=lambda lib=lib: lib,
                                                  check=_build.check)
            module._kernel.cache_clear()
            fn = getattr(module, fn_name)
            run = lambda fn=fn, args=args, kw=kw: fn(*args, **kw)
            with torch.inference_mode():
                records = kernel_records_us(run, dev)
                graph_us = 1e6 * timing.seconds_per_call(run, [()], device=dev,
                                                         target_s=opts.target_s)
            row[call] = {"device_us_per_launch": sum(records.values()),
                         "graph_us_per_call": graph_us, "records": records}
        results["us"][name] = row
        print(json.dumps({name: row}), flush=True)
    return results


if __name__ == "__main__":
    main()
