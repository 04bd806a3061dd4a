"""Serving: a port model as a callable, and as one artifact file.

Counterpart of ``visuelle2_tpu/eval/export.py``.  ``make_forecaster(model,
example_batch)`` returns ``(fn, header)``: the header has the JAX artifact
header's shape (sorted ``keys``, ``shapes``, ``dtypes``), and ``fn`` takes a
numpy batch dict of exactly those shapes and dtypes, runs the model on its
device under ``torch.inference_mode()`` and returns numpy forecasts.  A call
records three host spans (``utils/tracing.py``): ``forecast.upload`` (the
host-to-device copies), ``forecast.forward`` (issuing the forward) and
``forecast.download`` (waiting for the result and copying it back).

``export_forecaster`` writes a model built by ``models.build`` into one
file, and ``load_forecaster`` serves that file with no checkpoint and no
model flags.  The layout: a 12-byte magic of the port's own, an 8-byte
little-endian header length, a JSON header, then the weights as an npz (the
flax-layout tree of ``convert.to_jax_variables``, written with the codec of
``models/pretrained.py``; no pickle).  The header holds the JAX header's
fields (``keys``, ``version``, ``shapes``, ``dtypes``, ``quantize`` and
``quantized_arrays`` when quantized, ``provenance``) and ``registry``: the
registry name and build overrides (vocabulary sizes included) that rebuild
the model through ``models.build``.

Why not ``torch.export``: the model kernels are launched through ``ctypes``
(``ops/cuda/_build.py``) and are not registered as torch custom ops, so a
captured graph could not hold them.  A state dict plus a manifest keeps the
kernels on the served path.

``quantize="int8"`` is the JAX rule, weight-only and per channel: a float
leaf with ndim >= 2 and at least ``quantize_min_size`` elements is stored as
int8 ``q = clip(round(w / scale), -127, 127)`` with ``scale = max|w| / 127``
over every axis but the flax last one (0 replaced by 1).  Quantizing the
flax-layout tree itself keeps that axis right whatever the torch layout
(dim 0 of a Linear or Conv2d weight, the last dim of an Embedding, a GRU or
``attention._Weights``).  ``load_forecaster`` dequantizes once, at load time,
as ``q.float() * scale`` with plain torch ops: the same float32 weights, bit
for bit, as the JAX artifact's dequantization inside every call, without
paying it per call.

``quantize="w8a8"`` takes the ``calib`` dict of
``models/quantized_resnet.py::calibrate_model`` (without one it raises
``ValueError``, as the JAX exporter does without a calibrated ``apply_fn``).
It stores every ResNet convolution kernel by the int8 rule (its per-channel
scale is the engine's weight scale, bit for bit) and every other weight in
float32, because the w8a8 forward runs them in float32; the header adds
``w8a8``: the calibration dict and each backbone's block spec by module path.
``load_forecaster`` dequantizes, then rebuilds each ``W8A8Backbone`` from the
dequantized kernels with the stored scales: requantizing a dequantized
per-channel kernel recovers its codes (the JAX exporter's claim, tested), and
the stored scale keeps ``m`` the bits the exporting process had (a scale
recomputed from the dequantized kernel may differ by one ulp).  So the
artifact serves the ``--quantize w8a8`` forecasts bit for bit.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from visuelle2_tpu_torch._device import resolve_device
from visuelle2_tpu_torch.convert import load_jax_variables, to_jax_variables
from visuelle2_tpu_torch.models.base import VocabSizes
from visuelle2_tpu_torch.models.pretrained import (
    flatten_variables,
    load_backbone_npz,
    unflatten_variables,
)
from visuelle2_tpu_torch.models.quantized_resnet import backbone_paths, quantized_model
from visuelle2_tpu_torch.models.registry import build
from visuelle2_tpu_torch.parallel.distributed import is_main_process
from visuelle2_tpu_torch.utils import tracing

MAGIC = b"V2TORCHART01"
JAX_MAGIC = b"V2TPUEXPORT1"  # the JAX package's StableHLO artifact
VERSION = 1
SCALES = "scales"  # npz collection of the int8 leaves' scales


def signature(example_batch: Dict[str, np.ndarray]) -> dict:
    """The header's batch contract: sorted keys, their shapes and dtypes."""
    keys = sorted(example_batch)
    return {"keys": keys, "version": VERSION,
            "shapes": {k: list(np.shape(example_batch[k])) for k in keys},
            "dtypes": {k: str(np.asarray(example_batch[k]).dtype) for k in keys}}


def _serving_fn(model: nn.Module, header: dict, device: torch.device):
    model.to(device).eval()
    keys = header["keys"]

    def forecast_fn(batch: Dict[str, np.ndarray]) -> np.ndarray:
        missing = set(keys) - set(batch)
        if missing:
            raise ValueError(f"batch missing keys: {sorted(missing)}")
        for k in keys:
            a = np.asarray(batch[k])
            if list(a.shape) != header["shapes"][k]:
                raise ValueError(f"batch['{k}'] shape {list(a.shape)} != exported "
                                 f"{header['shapes'][k]} — serving batches must "
                                 "match the export batch size")
            if a.dtype != np.dtype(header["dtypes"][k]):
                raise ValueError(f"batch['{k}'] dtype {a.dtype} != exported "
                                 f"{header['dtypes'][k]}")
        with torch.inference_mode():
            with tracing.span("forecast.upload"):
                tensors = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
                           for k in keys}
            with tracing.span("forecast.forward"):
                out, _aux = model(tensors)
            with tracing.span("forecast.download"):
                return out.float().cpu().numpy()

    forecast_fn.model = model  # the served module, for inspection
    return forecast_fn


def make_forecaster(model: nn.Module, example_batch: Dict[str, np.ndarray],
                    device=None
                    ) -> Tuple[Callable[[Dict[str, np.ndarray]], np.ndarray], dict]:
    """Serve ``model`` on ``device`` (``cuda`` unless given; see ``_device``)."""
    device = resolve_device(device)
    header = signature(example_batch)
    return _serving_fn(model, header, device), header


# ----------------------------------------------------------------- int8 rule

def quantize_int8(flat: Dict[str, np.ndarray], min_size: int = 4096
                  ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """``(stored, scales)``: ``flat`` (flax-layout leaves by key) with each
    qualifying float leaf as int8, and those leaves' float32 scales by key.
    The arithmetic is the JAX ``_quantize_variables``' in numpy."""
    stored, scales = {}, {}
    for key, a in flat.items():
        if a.ndim >= 2 and a.size >= min_size and np.issubdtype(a.dtype, np.floating):
            a32 = a.astype(np.float32)
            scale = np.max(np.abs(a32), axis=tuple(range(a.ndim - 1)),
                           keepdims=True) / 127.0
            scale = np.where(scale == 0.0, 1.0, scale).astype(np.float32)
            stored[key] = np.clip(np.round(a32 / scale), -127, 127).astype(np.int8)
            scales[key] = scale
        else:
            stored[key] = a
    return stored, scales


def dequantize_int8(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """``q.float() * scale`` on the CPU with torch ops: float32, the dtype
    of every port weight (``convert.py``)."""
    return (torch.from_numpy(q).float() * torch.from_numpy(scale)).numpy()


# ------------------------------------------------------------- the artifact

def _jsonable(overrides: dict) -> dict:
    out = {}
    for k, v in overrides.items():
        if isinstance(v, VocabSizes):
            v = dataclasses.asdict(v)
        elif isinstance(v, torch.dtype):
            v = str(v).replace("torch.", "")
        out[k] = v
    return out


def _from_json(overrides: dict) -> dict:
    out = dict(overrides)
    if "vocab" in out:
        out["vocab"] = VocabSizes(**out["vocab"])
    if "image_dtype" in out:
        out["image_dtype"] = getattr(torch, out["image_dtype"])
    return out


def _w8a8_kernel_keys(backbones: Dict[str, tuple]):
    """The flat npz keys of every convolution kernel of the backbones
    (module path -> block spec), by the weight-scale key
    ``quantized_model`` reads ("<backbone path>.<conv path>")."""
    keys = {}
    for path, blocks in backbones.items():
        convs = ["conv1"]
        for stage, n_blocks in enumerate(blocks):
            for b in range(n_blocks):
                convs += [f"layer{stage + 1}_{b}.conv{i}" for i in (1, 2, 3)]
                if b == 0:
                    convs.append(f"layer{stage + 1}_{b}.ds_conv")
        for conv in convs:
            dotted = f"{path}.{conv}"
            keys["params/" + dotted.replace(".", "/") + "/kernel"] = dotted
    return keys


def export_forecaster(model: nn.Module, example_batch: Dict[str, np.ndarray], path: str,
                      quantize: Optional[str] = None, quantize_min_size: int = 4096,
                      extra_header: Optional[dict] = None,
                      calib: Optional[Dict[str, float]] = None) -> int:
    """Write ``model`` (built by ``models.build``; the float model, also for
    w8a8) and the batch contract of ``example_batch`` to ``path``; returns
    the file's size in bytes.  ``extra_header`` goes into the header as
    ``provenance``: informational for clients, never read by
    ``load_forecaster``.  ``calib``: the w8a8 calibration.  A model sharded
    over a ``model`` axis (``parallel/sharding.py``) is gathered, so every
    rank of its model group calls this.  Over a process group rank 0 writes
    the file and the other ranks return 0."""
    if quantize not in (None, "", "none", "int8", "w8a8"):
        raise ValueError(f"unsupported quantize mode {quantize!r}")
    if quantize == "w8a8" and not calib:
        raise ValueError("quantize='w8a8' needs a calibration "
                         "(models/quantized_resnet.py::calibrate_model)")
    spec = getattr(model, "build_spec", None)
    if spec is None:
        raise ValueError("export_forecaster needs a model built by models.build "
                         "(its build_spec rebuilds it at load)")
    flat = flatten_variables(to_jax_variables(model))  # gathers a sharded model
    if not is_main_process():
        return 0  # rank 0 writes
    scales = {}
    if quantize == "int8":
        flat, scales = quantize_int8(flat, quantize_min_size)
    w8a8 = None
    if quantize == "w8a8":
        backbones = backbone_paths(model)
        if not backbones:
            raise ValueError("quantize='w8a8' needs a ResNet image backbone")
        kernels = _w8a8_kernel_keys(backbones)
        stored, scales = quantize_int8({k: flat[k] for k in kernels}, 0)
        flat.update(stored)
        w8a8 = {"calib": dict(calib),
                "blocks": {p: list(b) for p, b in backbones.items()}}
    header = {
        **signature(example_batch),
        **({"quantize": quantize, "quantized_arrays": len(scales)}
           if quantize in ("int8", "w8a8") else {}),
        **({"w8a8": w8a8} if w8a8 else {}),
        **({"provenance": extra_header} if extra_header else {}),
        "registry": {"name": spec["name"], "overrides": _jsonable(spec["overrides"])},
    }
    buf = io.BytesIO()
    np.savez(buf, **flat, **{f"{SCALES}/{k}": v for k, v in scales.items()})
    blob = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        f.write(buf.getbuffer())
    return os.path.getsize(path)


def read_artifact(path: str) -> Tuple[dict, dict]:
    """``(header, variables)``: the flax-layout tree with the int8 leaves
    dequantized.  A JAX package artifact raises ``ValueError`` naming it."""
    header, tree, _scales = _read(path)
    return header, tree


def _read(path: str) -> Tuple[dict, dict, dict]:
    """``read_artifact`` and the int8 leaves' stored scales by flat key."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic == JAX_MAGIC:
            raise ValueError(
                f"{path} is a visuelle2_tpu (JAX, StableHLO) artifact; the port serves "
                "only its own artifacts — export the checkpoint with "
                "visuelle2_tpu_torch.cli.export")
        if magic != MAGIC:
            raise ValueError(f"not a visuelle2_tpu_torch artifact: {path}")
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n).decode())
        tree = load_backbone_npz(io.BytesIO(f.read()))
    scales = flatten_variables(tree.pop(SCALES, {}))
    if scales:
        flat = flatten_variables(tree)
        for key, scale in scales.items():
            flat[key] = dequantize_int8(flat[key], scale)
        tree = unflatten_variables(flat)
    return header, tree, scales


def load_forecaster(path: str, device=None
                    ) -> Tuple[Callable[[Dict[str, np.ndarray]], np.ndarray], dict]:
    """Serve an artifact: ``(fn, header)``, ``fn`` as ``make_forecaster``'s on
    ``device`` (``cuda`` unless given; no CPU fallback)."""
    device = resolve_device(device)
    header, variables, scales = _read(path)
    reg = header["registry"]
    model = build(reg["name"], device="cpu", **_from_json(reg["overrides"]))
    load_jax_variables(model, variables)
    if header.get("quantize") == "w8a8":
        w8a8 = header["w8a8"]
        have = {p: list(b) for p, b in backbone_paths(model).items()}
        if have != w8a8["blocks"]:
            raise ValueError(f"{path}: the artifact's backbones {w8a8['blocks']} are not "
                             f"the rebuilt model's {have}")
        kernels = _w8a8_kernel_keys(backbone_paths(model))
        model = quantized_model(model, w8a8["calib"], {
            kernels[k]: torch.from_numpy(s).reshape(-1) for k, s in scales.items()})
    return _serving_fn(model, header, device), header
