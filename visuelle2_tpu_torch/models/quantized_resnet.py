"""The w8a8 int8 serving engine for the ResNet backbone, counterpart of
``visuelle2_tpu/models/quantized_resnet.py``.

Every tensor between the stem and the final feature map is a per-tensor
scaled int8 NHWC array; each convolution runs int8 x int8 -> int32 with the
BatchNorm fold, the residual add, the ReLU and the requantization fused into
its epilogue (``ops/cuda/int8_conv.py``, ``csrc/int8_conv.cu``).

* weights: per-output-channel symmetric int8 (``_qweight``), BN folded into
  the epilogue's per-channel ``m`` and ``z``;
* activations: per-tensor symmetric int8, scales calibrated by absmax over a
  float forward (``float_forward(record=...)``); post-ReLU tensors use
  [0, 127], so the ReLU is the requantize clamp;
* residual adds in float32, in units of the block's output scale,
  requantized once.

The arithmetic is the JAX engine's, in its order and with its casts: a
Python double scale meets a float32 array as float32, ``m = s_prev · sw · a
/ s_out`` left to right in float32, ``sc_ratio = s_prev / s_out`` in double
then float32.  ``prepare`` runs on the CPU (a division by a scalar on CUDA is
a multiplication by its reciprocal, other bits), and the input quantization
divides by a device tensor for the same reason.  So the codes after every
block are the JAX engine's op-by-op codes, bit for bit.

This is an eval and serving path only.  ``quantized_model`` swaps a
``W8A8Backbone`` in for every ``ResNetBackbone`` of a copy of the model (the
image encoders' and gtm_v1's tower): it keeps the float backbone's output
contract (the input's dtype, an NCHW view of channels_last memory) and
raises in train mode.  ``calibrate_model`` drives the model's own forward,
so normalization and the dedup gather are the serving path's.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable, Optional

import torch
from torch import nn
from torch.nn import functional as F

from visuelle2_tpu_torch.models.resnet import ResNetBackbone
from visuelle2_tpu_torch.ops.cuda.int8_conv import int8_conv, out_size, pack_weight

EPS = 1e-5  # BatchNorm2d's, as the JAX engine's _EPS
# The stem's input channels as int8_conv takes them: the image's 3 and a zero
# channel (packed with zero weights, so the sums do not change), which lets
# the kernel move each tap's channels as one 4-byte copy.
STEM_CIN = 4
IMAGE_CIN = 3  # the image's channels: the stem's work (its bound, its operations)

# The largest image duplication (batch rows / unique images) at which the
# w8a8 forward measured faster than the bf16 one on the card: gated_v4 at
# B = 128, ResNet-101 at 299², duplications 1, 4, 10, 32 and 128 (128, 32,
# 13, 4 and 1 photos) timed in turns with CUDA events (chip_smoke.py phase
# w8a8; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6 gives each run's
# ratios). w8a8 was faster at all five: the eager bf16 forward is bound by
# the host's launches from 32 photos down, w8a8's issues in a third of that
# time. So ``--quantize auto`` picks w8a8 up to d = 128, the largest
# measured.  (0 would mean faster at none: auto would pick float.)
W8A8_AUTO_MAX_DUPLICATION = 128.0


def resolve_auto_mode(*, duplication: float, has_resnet_backbone: bool) -> str:
    """What ``--quantize auto`` resolves to: "w8a8" or "" (the float path)."""
    if not has_resnet_backbone:
        return ""
    return "w8a8" if duplication <= W8A8_AUTO_MAX_DUPLICATION else ""


def block_specs(blocks):
    """(name, width, stride, downsample) for every bottleneck, in order."""
    for stage, (n_blocks, w) in enumerate(zip(blocks, (64, 128, 256, 512))):
        for b in range(n_blocks):
            yield f"layer{stage + 1}_{b}", w, 2 if (stage > 0 and b == 0) else 1, b == 0


def conv_launches(blocks, image_size: int):
    """``(name, h, w, cin, cout, kernel, stride, pad, epilogue)`` of every
    ``int8_conv`` launch of one forward at ``image_size``², in order: the
    stem (its input padded to ``STEM_CIN`` channels), then conv1, conv2, the
    downsample conv (first block of a stage) and conv3 of each bottleneck
    (with the downsample's float shortcut, else the identity's int8 codes).
    ResNet-101 makes 104, ResNet-50 53."""
    out = [("stem", image_size, image_size, STEM_CIN, 64, 7, 2, 3, "requant")]
    h = out_size(out_size(image_size, 7, 2, 3), 3, 2, 1)  # the stem, its max pool
    cin = 64
    for name, w, stride, ds in block_specs(blocks):
        h2 = out_size(h, 3, stride, 1)
        out += [(f"{name}.conv1", h, h, cin, w, 1, 1, 0, "requant"),
                (f"{name}.conv2", h, h, w, w, 3, stride, 1, "requant")]
        if ds:
            out.append((f"{name}.ds", h, h, cin, 4 * w, 1, stride, 0, "float"))
        out.append((f"{name}.conv3", h2, h2, w, 4 * w, 1, 1, 0,
                    "requant_add" if ds else "requant_add_identity"))
        h, cin = h2, 4 * w
    return out


def _affine(bn, device=None):
    """Eval BatchNorm as y = x·a + b in float32, on ``device`` (the
    statistics' own when None)."""
    weight, bias, mean, var = (t.detach().float().to(device or t.device) for t in (
        bn.weight, bn.bias, bn.running_mean, bn.running_var))
    # The square root in float64, then rounded: the correctly rounded
    # float32 root, as XLA's; torch's vectorized float32 sqrt on the CPU can
    # be an ulp off.
    a = weight / torch.sqrt((var + EPS).double()).float()
    return a, bias - mean * a


# --------------------------------------------------------------------------
# The float reference forward, also the calibration pass
# --------------------------------------------------------------------------

def float_forward(backbone: ResNetBackbone, x: torch.Tensor,
                  record: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """float32 eval forward of ``backbone`` on NHWC ``x`` -> NHWC, with
    float32 weights whatever the backbone's dtype.  ``record`` (a dict) gets
    the absmax of every tensor the int8 path quantizes, as 0-dim device
    tensors merged by maximum, under the names ``prepare`` reads."""
    def rec(name, t):
        if record is not None:
            m = t.abs().amax()
            record[name] = m if name not in record else torch.maximum(record[name], m)

    def conv_bn(t, conv, bn, stride, pad):
        a, b = _affine(bn)
        y = F.conv2d(t, conv.weight.detach().float(), stride=stride, padding=pad)
        return y * a[:, None, None] + b[:, None, None]

    x = x.float()
    rec("input", x)
    y = torch.relu(conv_bn(x.permute(0, 3, 1, 2), backbone.conv1, backbone.bn1, 2, 3))
    y = F.max_pool2d(y, 3, stride=2, padding=1)
    rec("stem", y)
    for name, _w, stride, ds in block_specs(backbone.blocks):
        blk = getattr(backbone, name)
        h1 = torch.relu(conv_bn(y, blk.conv1, blk.bn1, 1, 0))
        rec(f"{name}.h1", h1)
        h2 = torch.relu(conv_bn(h1, blk.conv2, blk.bn2, stride, 1))
        rec(f"{name}.h2", h2)
        f3 = conv_bn(h2, blk.conv3, blk.bn3, 1, 0)
        sc = conv_bn(y, blk.ds_conv, blk.ds_bn, stride, 0) if ds else y
        y = torch.relu(f3 + sc)
        rec(f"{name}.out", y)
    return y.permute(0, 2, 3, 1)


# --------------------------------------------------------------------------
# Prepare: float weights + calibrated scales -> int8 kernels + epilogues
# --------------------------------------------------------------------------

def _qweight(w: torch.Tensor, scale: Optional[torch.Tensor] = None):
    """Per-output-channel symmetric int8 of an OIHW weight (the JAX HWIO
    kernel's axes 0-2 are torch dims 1-3); a zero scale becomes 1.  A given
    ``scale`` (an int8 artifact's stored one) is used as it is."""
    w32 = w.detach().float().cpu()
    s = w32.abs().amax(dim=(1, 2, 3)) / 127.0 if scale is None else scale.float().cpu()
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(w32 / s[:, None, None, None]), -127, 127).to(torch.int8)
    return q, s


def _f32(v: float) -> torch.Tensor:
    """A Python double as float32 (where the JAX engine's scalars meet a
    float32 array)."""
    return torch.tensor(v, dtype=torch.float32)


def prepare(backbone: ResNetBackbone, calib: Dict[str, float],
            weight_scales: Optional[Dict[str, torch.Tensor]] = None) -> dict:
    """The int8 execution tree on the CPU: per conv ``w`` (packed,
    ``ops/cuda/int8_conv.pack_weight``; the stem's with its input channels
    padded to ``STEM_CIN`` by zeros), ``cin``, ``kernel``, ``m``, ``z``;
    per identity block ``sc_ratio``; ``input_scale`` and ``out_scale`` as
    Python doubles.  ``weight_scales`` maps a conv's module path in the
    backbone ("layer1_0.conv1") to a stored per-channel scale."""
    weight_scales = weight_scales or {}

    def s_act(name):
        return max(float(calib[name]), 1e-12) / 127.0

    def conv_entry(path, conv, bn, s_prev, s_out, cin=None):
        qw, sw = _qweight(conv.weight, weight_scales.get(path))
        if cin is not None:
            qw = F.pad(qw, (0, 0, 0, 0, 0, cin - qw.shape[1]))
        a, b = _affine(bn, "cpu")
        return {"w": pack_weight(qw), "cin": qw.shape[1], "kernel": qw.shape[2],
                "m": _f32(s_prev) * sw * a / _f32(s_out), "z": b / _f32(s_out)}

    s_in, s_stem = s_act("input"), s_act("stem")
    qt = {"blocks": tuple(backbone.blocks), "input_scale": s_in,
          "stem": conv_entry("conv1", backbone.conv1, backbone.bn1, s_in, s_stem, STEM_CIN)}
    s_prev = s_stem
    for name, _w, stride, ds in block_specs(backbone.blocks):
        blk = getattr(backbone, name)
        s1, s2, s_out = (s_act(f"{name}.{t}") for t in ("h1", "h2", "out"))
        e = {"stride": stride,
             "conv1": conv_entry(f"{name}.conv1", blk.conv1, blk.bn1, s_prev, s1),
             "conv2": conv_entry(f"{name}.conv2", blk.conv2, blk.bn2, s1, s2),
             "conv3": conv_entry(f"{name}.conv3", blk.conv3, blk.bn3, s2, s_out)}
        if ds:
            e["ds"] = conv_entry(f"{name}.ds_conv", blk.ds_conv, blk.ds_bn, s_prev, s_out)
        else:
            # The identity shortcut, rescaled into block-output units.
            e["sc_ratio"] = s_prev / s_out
        qt[name] = e
        s_prev = s_out
    qt["out_scale"] = s_prev
    return qt


def to_device(qt: dict, device) -> dict:
    """``qt`` with every tensor on ``device`` and the scales the forward
    multiplies or divides by as float32 device tensors."""
    out = {}
    for k, v in qt.items():
        if isinstance(v, dict):
            out[k] = to_device(v, device)
        elif isinstance(v, torch.Tensor):
            out[k] = v.to(device)
        elif k in ("input_scale", "sc_ratio"):
            out[k] = _f32(v).to(device)
        else:
            out[k] = v
    return out


# --------------------------------------------------------------------------
# int8 execution
# --------------------------------------------------------------------------

def _conv(q, e, stride, pad, epilogue, **operands):
    return int8_conv(q, e["w"], e["m"], e["z"], kernel=e["kernel"], stride=stride,
                     pad=pad, epilogue=epilogue, **operands)


def _max_pool(q):
    """3x3/2 max pool of NHWC int8 codes, through an exact cast (CUDA
    max_pool2d takes no int8; padding is -inf, as flax's)."""
    t = q.permute(0, 3, 1, 2).to(torch.float16 if q.is_cuda else torch.float32)
    return F.max_pool2d(t, 3, stride=2, padding=1).to(torch.int8).permute(0, 2, 3, 1) \
        .contiguous()


def apply_quantized(qt: dict, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The int8 backbone on a normalized NHWC image batch -> the NHWC
    feature map in ``dtype`` (the codes times the output scale).  ``qt`` is
    ``to_device(prepare(...), x.device)``."""
    q = torch.clamp(torch.round(x.float() / qt["input_scale"]), -127, 127).to(torch.int8)
    zeros = qt["stem"]["cin"] - q.shape[3]
    q = F.pad(q, (0, zeros))  # the stem's zero channel
    q = _max_pool(_conv(q, qt["stem"], 2, 3, "requant", pad_channels=zeros))
    for name, _w, stride, ds in block_specs(qt["blocks"]):
        e = qt[name]
        q1 = _conv(q, e["conv1"], 1, 0, "requant")
        q2 = _conv(q1, e["conv2"], stride, 1, "requant")
        if ds:
            sc = _conv(q, e["ds"], stride, 0, "float")
            q = _conv(q2, e["conv3"], 1, 0, "requant_add", addend=sc)
        else:  # the kernel rescales the block input's codes in its epilogue
            q = _conv(q2, e["conv3"], 1, 0, "requant_add_identity", shortcut=q,
                      ratio=e["sc_ratio"])
    # The scale rounded to ``dtype`` on the host, then a Python scalar: no
    # copy to the card, and the JAX product's bits (``dtype`` x ``dtype``).
    return q.to(dtype) * torch.tensor(qt["out_scale"], dtype=dtype).item()


class W8A8Backbone(nn.Module):
    """A ``ResNetBackbone``'s eval forward on the int8 engine: NCHW in (the
    float backbone's input), an NCHW view of channels_last memory in the
    input's dtype out.  Built from the float backbone's weights (``prepare``
    on the CPU), then placed on that backbone's device; ``.to(device)``
    moves it.  Raises in train mode."""

    def __init__(self, backbone: ResNetBackbone, calib: Dict[str, float],
                 weight_scales: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        self.training = False
        self.qt = to_device(prepare(backbone, calib, weight_scales),
                            next(backbone.parameters()).device)

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        self.qt = _map_tensors(self.qt, fn)
        return self

    def forward(self, x):
        if self.training:
            raise ValueError("the w8a8 backbone is an eval/serving path; training must "
                             "use the float backbone")
        return apply_quantized(self.qt, x.permute(0, 2, 3, 1), x.dtype).permute(0, 3, 1, 2)


def _map_tensors(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def backbone_paths(model: nn.Module) -> Dict[str, tuple]:
    """Module path -> block spec of every ResNetBackbone of ``model``."""
    return {name: tuple(m.blocks) for name, m in model.named_modules()
            if isinstance(m, ResNetBackbone)}


def _backbone_slots(model: nn.Module):
    """(parent, attribute name, backbone) for every ResNetBackbone."""
    return [(parent, name, child) for parent in model.modules()
            for name, child in parent.named_children() if isinstance(child, ResNetBackbone)]


# --------------------------------------------------------------------------
# Model-level integration
# --------------------------------------------------------------------------

class _Intercept:
    """Run ``fn(backbone, x)`` in place of every ResNetBackbone's forward of
    ``model`` inside the ``with`` (the flax method interceptor's role)."""

    def __init__(self, model, fn):
        self.backbones = [bb for _p, _n, bb in _backbone_slots(model)]
        self.fn = fn

    def __enter__(self):
        for bb in self.backbones:
            bb.forward = lambda x, bb=bb: self.fn(bb, x)
        return self

    def __exit__(self, *exc):
        for bb in self.backbones:
            del bb.forward


def calibrate_model(model: nn.Module, batches: Iterable[dict]) -> Dict[str, float]:
    """One float32 pass of ``model``'s own eval forward per batch (batches on
    the model's device), with every ResNet running ``float_forward``; returns
    ``{scale name: absmax}`` merged by maximum over the batches.  Empty when
    no ResNet ran.  TF32 is off: the pass is float32 as the JAX one."""
    merged: Dict[str, float] = {}
    was_training = model.training
    model.eval()
    try:
        for batch in batches:
            record: Dict[str, torch.Tensor] = {}

            def run(bb, x):
                return float_forward(bb, x.permute(0, 2, 3, 1), record) \
                    .permute(0, 3, 1, 2).to(x.dtype)

            with torch.inference_mode(), _Intercept(model, run), \
                    torch.backends.cudnn.flags(allow_tf32=False):
                model(batch)
            if record:
                values = torch.stack(list(record.values())).tolist()  # one host sync
                for k, v in zip(record, values):
                    merged[k] = max(merged.get(k, 0.0), v)
    finally:
        model.train(was_training)
    return merged


def quantized_model(model: nn.Module, calib: Dict[str, float],
                    weight_scales: Optional[Dict[str, torch.Tensor]] = None) -> nn.Module:
    """A copy of ``model`` (eval mode) whose every ResNetBackbone is a
    ``W8A8Backbone`` built from it with ``calib``; the rest of the copy
    shares nothing with ``model``, and the float backbones are not copied.
    ``weight_scales`` maps "<path of the backbone in model>.<conv path>" to a
    stored per-channel scale (a w8a8 artifact's)."""
    slots = _backbone_slots(model)
    if not slots:
        raise ValueError("--quantize w8a8 needs a ResNet image backbone in the forward path")
    paths = {id(bb): name for name, bb in model.named_modules()
             if isinstance(bb, ResNetBackbone)}
    q = copy.deepcopy(model, memo={id(bb): bb for _p, _n, bb in slots})
    for parent, name, bb in _backbone_slots(q):
        prefix = paths[id(bb)] + "."
        scales = {k[len(prefix):]: v for k, v in (weight_scales or {}).items()
                  if k.startswith(prefix)}
        setattr(parent, name, W8A8Backbone(bb, calib, scales))
    return q.eval()


def build_serving_path(model: nn.Module, calib_batches: Iterable[dict]):
    """Calibrate and return ``(quantized model, calib)``: the CLI entry
    point.  Raises when calibration recorded nothing, i.e. no ResNet ran
    (``use_img=0``, or an InceptionV3 encoder): scoring the float path under
    a w8a8 label would be wrong."""
    calib = calibrate_model(model, calib_batches)
    if not calib:
        raise ValueError(
            "--quantize w8a8 needs a ResNet image backbone in the forward path "
            "(use_img=1 and --image_arch resnet50/resnet101); this model never "
            "invoked one during calibration")
    return quantized_model(model, calib), calib
