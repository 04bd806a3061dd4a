"""Plain float32 PyTorch: the building blocks of the benchmark's reference,
and the forward pass of a model family found by its registry name.

The reference that decides ``correct``.  Each model family is a file of its
own, ``families/<registry>.py`` (``forward(P, batch, model, rt)`` and
``heads_flops(model)``), written as a function of a parameter dict in the
port's layout (the names and shapes of the port's ``state_dict``, which is
how the benchmark draws the weights); this file holds what families share:
the linear layers, attention and GRU, and the ResNet backbone.  Nothing here
imports the port: the benchmark hands both sides the same weights and
inputs, and the reference computes everything from them again, with no
kernels, no caching and no batching tricks.

Train mode follows the models' stated semantics: BatchNorm on the batch's
statistics (mean and biased variance over N·H·W), dropout at each module's
rate, teacher forcing in Demand.  Dropout masks and teacher-forcing coins are
part of what the configuration states: each is ``rand(shape) < keep`` drawn
from the step's generator in the order the forward reaches it, a kept
element scaled by ``1 / keep``; ``Runtime.drop`` draws them so.

``Runtime.precision`` names a file of ``precisions/`` (``precision.py``):
the configuration's reference precision ("f32": float32, TF32 off, no
rounding) or its control, one precision below the configuration's (for a
bfloat16 backbone with float32 heads "fp8_tf32").  The backbone calls its
``low`` at every point where the model rounds to its working dtype: the
normalised image, every convolution's operands and output, every
BatchNorm's folded scale and shift (and its gain), output and residual sum,
gated_v4's 1x1 projection and its pooled mean.  The caller sets TF32 by
the same file (``precision.backends``).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.nn import functional as F

from benchmark.core import load_file
from benchmark.reference import precision as precisions

Params = Dict[str, torch.Tensor]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5
LN_EPS = 1e-6
STAGES = {"resnet101": (3, 4, 23, 3), "resnet50": (3, 4, 6, 3), "tiny": (1, 1, 1, 1)}


class Runtime:
    """How a forward runs: ``train`` (batch statistics, dropout, teacher
    forcing), the ``generator`` masks and coins come from, and
    ``precision`` (a file of ``precisions/``)."""

    def __init__(self, train: bool = False, generator: Optional[torch.Generator] = None,
                 precision: str = "f32", collect: Optional[dict] = None):
        self.train = train
        self.generator = generator
        self.precision = precision
        self.low = precisions.load(precision).low
        # Given, every BatchNorm normalises by the batch's statistics and
        # records them here by name (``calibrate_running_stats``).
        self.collect = collect

    def drop(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if not self.train or rate == 0.0:
            return x
        keep_prob = 1.0 - rate
        keep = torch.rand(x.shape, dtype=torch.float32, device=x.device,
                          generator=self.generator) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                             device=x.device))

    def coins(self, n: int, ratio: float, device) -> torch.Tensor:
        return torch.rand(n, device=device, generator=self.generator) < ratio


# ------------------------------------------------------------------ basics

def linear(P: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """torch ``nn.Linear`` layout: weight [out, in]."""
    return F.linear(x, P[f"{name}.weight"], P.get(f"{name}.bias"))


def layer_norm(P: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"], P[f"{name}.bias"], LN_EPS)


def gru_cell(x, h, w_i, w_h, b_i, b_h):
    gi = x @ w_i + b_i
    gh = h @ w_h + b_h
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def gru(P: Params, name: str, x: torch.Tensor, h0=None):
    """x [B, T, I] -> (outputs [B, T, H], h_T)."""
    w = [P[f"{name}.{k}"] for k in ("w_i", "w_h", "b_i", "b_h")]
    h = x.new_zeros(x.shape[0], w[1].shape[0]) if h0 is None else h0
    outs = []
    for t in range(x.shape[1]):
        h = gru_cell(x[:, t], h, *w)
        outs.append(h)
    return torch.stack(outs, dim=1), h


def mha(P: Params, name: str, q, k, v, heads: int, rate: float, rt: Runtime, mask=None):
    """Multi-head attention with separate q/k/v/out linears, scores
    q·kᵀ/√d plus an additive mask, the probabilities dropped at ``rate``."""
    def split(x):
        B, L, D = x.shape
        return x.reshape(B, L, heads, D // heads).transpose(1, 2)

    qh = split(linear(P, f"{name}.q_proj", q))
    kh = split(linear(P, f"{name}.k_proj", k))
    vh = split(linear(P, f"{name}.v_proj", v))
    scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * (qh.shape[-1] ** -0.5)
    if mask is not None:
        scores = scores + mask
    probs = rt.drop(torch.softmax(scores, dim=-1), rate)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
    B, h, L, d = out.shape
    return linear(P, f"{name}.out_proj", out.transpose(1, 2).reshape(B, L, h * d))


def sinusoidal_table(max_len: int, d_model: int, device) -> torch.Tensor:
    position = torch.arange(max_len, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                    * (-math.log(10000.0) / d_model))
    pe = torch.zeros(max_len, d_model)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div[: pe[:, 1::2].shape[1]])
    return pe.to(device)


def gcd_block_mask(size: int, horizon: int, device) -> torch.Tensor:
    split = math.gcd(size, horizon)
    idx = torch.arange(size, device=device)
    allowed = (idx[:, None] // split) == (idx[None, :] // split)
    return torch.zeros(size, size, device=device).masked_fill(~allowed, float("-inf"))


# --------------------------------------------------------------- backbone

def low(x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """A backbone tensor at a point where the model rounds it to its working
    dtype, as ``rt``'s precision rounds it there."""
    return rt.low(x)


def conv(x, w, stride: int, padding: int, rt: Runtime, bias=None):
    x, w = rt.low(x), rt.low(w)
    return low(F.conv2d(x, w, bias, stride=stride, padding=padding), rt)


def batch_norm(P: Params, name: str, x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    if rt.train or rt.collect is not None:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        if rt.collect is not None:
            rt.collect[name] = (mean, var)
    else:
        mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
    rstd = 1.0 / torch.sqrt(var + BN_EPS)
    # The model folds the statistics into a scale and a shift in its
    # working dtype: the precision rounds them (and the gain) there.
    inv = low(low(w, rt) * low(rstd, rt), rt)
    shift = low(b - mean * w * rstd, rt)
    return low(x * inv[:, None, None] + shift[:, None, None], rt)


def normalize_images(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> normalised NCHW float32."""
    x = images_u8.to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def backbone(P: Params, prefix: str, x: torch.Tensor, arch: str, rt: Runtime):
    """ResNet v1 (torchvision Bottleneck: stride on the 3x3) -> [B, 2048, h, w]."""
    x = conv(low(x, rt), P[f"{prefix}.conv1.weight"], 2, 3, rt)
    x = torch.relu(batch_norm(P, f"{prefix}.bn1", x, rt))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for stage, n_blocks in enumerate(STAGES[arch]):
        for b in range(n_blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            blk = f"{prefix}.layer{stage + 1}_{b}"
            out = torch.relu(batch_norm(P, f"{blk}.bn1",
                                        conv(x, P[f"{blk}.conv1.weight"], 1, 0, rt), rt))
            out = torch.relu(batch_norm(P, f"{blk}.bn2",
                                        conv(out, P[f"{blk}.conv2.weight"], stride, 1, rt), rt))
            out = batch_norm(P, f"{blk}.bn3", conv(out, P[f"{blk}.conv3.weight"], 1, 0, rt), rt)
            if b == 0:
                sc = batch_norm(P, f"{blk}.ds_bn",
                                conv(x, P[f"{blk}.ds_conv.weight"], stride, 0, rt), rt)
            else:
                sc = x
            x = torch.relu(low(out + sc, rt))
    return x


@torch.no_grad()
def calibrate_running_stats(P: Params, prefix: str, images_u8: torch.Tensor, arch: str,
                            precision: str = "f32") -> None:
    """Set every BatchNorm's running statistics under ``prefix`` (a
    backbone) to the batch statistics of ``images_u8`` under the weights
    ``P``, in place: random weights with a trained network's
    normalisation, so that eval mode neither blows up nor flattens the
    activations.  ``precision``: the configuration's reference precision."""
    stats = {}
    backbone(P, prefix, normalize_images(images_u8), arch,
             Runtime(precision=precision, collect=stats))
    for name, (mean, var) in stats.items():
        P[f"{name}.running_mean"] = mean.clone()
        P[f"{name}.running_var"] = var.clone()


FAMILIES = Path(__file__).resolve().parent / "families"
_FAMILIES = {}


def family(registry: str):
    """The model family's file ``families/<registry>.py``, named by the
    port's registry name: its ``forward(P, batch, model, rt)`` and
    ``heads_flops(model)``."""
    if registry not in _FAMILIES:
        path = FAMILIES / f"{registry}.py"
        if not path.is_file():
            raise KeyError(f"no reference for {registry!r}: add {path}")
        _FAMILIES[registry] = load_file(path, f"benchmark_family_{registry}")
    return _FAMILIES[registry]


def forward(P: Params, batch: dict, model: dict, rt: Runtime) -> torch.Tensor:
    return family(model["registry"]).forward(P, batch, model, rt)


def masked_mse(target: torch.Tensor, pred: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Σ mask·(target − pred)² / max(Σ mask · H, 1)."""
    err = (target - pred) ** 2
    return torch.sum(err * mask[:, None]) / torch.clamp_min(mask.sum() * target.shape[-1], 1.0)
