"""ResNet-v1 backbone (ResNet-50/101), counterpart of
``visuelle2_tpu/models/resnet.py``.

The public input is the JAX layout, NHWC; ``ImagePooledEncoder`` hands the
backbone ``x.permute(0, 3, 1, 2)``, which is already a channels_last view, so
cuDNN runs NHWC convolutions without a copy.  Every parameter is a float32
master; a convolution casts its weight (and bias) to the working dtype on
each call (bf16 on the main path), as the JAX package's ``param_dtype``
float32 with ``dtype`` bf16 does — an Adafactor update of ~1e-3 relative
would vanish in a bf16 weight.  BatchNorm keeps f32 parameters and running
statistics and folds them in the working dtype exactly as the JAX
``BatchNorm`` does: ``inv = dtype(scale) * dtype(1/√(var+eps))`` and
``shift = dtype(bias − mean·scale/√(var+eps))``.

In train mode BatchNorm uses the batch's mean and biased variance over
N·H·W, in float32 from ``x.float()``, and moves its running statistics
with momentum 0.1 and the unbiased variance; the frozen stages' statistics
move too (torch's ``requires_grad=False`` + ``.train()``, the JAX freeze
split).  ``remat=True`` runs each bottleneck under
``torch.utils.checkpoint`` in training (the JAX ``nn.remat``); its
recomputation leaves the running statistics alone (``ops/dropout.py``).
"""

from __future__ import annotations

import contextlib

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from visuelle2_tpu_torch.ops import dropout

STAGE_BLOCKS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    # One bottleneck per stage: the same code paths at toy cost, for tests.
    "tiny": (1, 1, 1, 1),
}


MOMENTUM = 0.1


def batch_statistics(x: torch.Tensor, dims) -> tuple:
    """Mean and biased variance over ``dims`` in float32, and the count."""
    var, mean = torch.var_mean(x.float(), dim=dims, correction=0)
    n = x.numel() // x.shape[1]
    return mean, var, n


def update_running(mod: nn.Module, mean, var, n: int) -> None:
    """Move ``mod``'s running statistics towards the batch's, momentum 0.1,
    with the unbiased variance; not in a checkpoint's recomputation."""
    if dropout.is_recomputing():
        return
    with torch.no_grad():
        unbiased = var * n / max(n - 1, 1)
        mod.running_mean.copy_((1 - MOMENTUM) * mod.running_mean + MOMENTUM * mean)
        mod.running_var.copy_((1 - MOMENTUM) * mod.running_var + MOMENTUM * unbiased)


class BatchNorm(nn.Module):
    """BatchNorm2d over NCHW, folded in the working dtype; batch statistics
    in train mode."""

    def __init__(self, features: int, dtype=torch.float32, eps: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if self.training:
            mean, var, n = batch_statistics(x, (0, 2, 3))
            update_running(self, mean, var, n)
        else:
            mean, var = self.running_mean, self.running_var
        std = torch.sqrt(var + self.eps)
        inv = self.weight.to(self.dtype) * (1.0 / std).to(self.dtype)
        shift = (self.bias - mean * self.weight / std).to(self.dtype)
        return x * inv[:, None, None] + shift[:, None, None]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with float32 master parameters, run in ``compute_dtype``."""

    def __init__(self, *args, dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.compute_dtype)
        return self._conv_forward(x, self.weight.to(self.compute_dtype), bias)


def _conv(cin, cout, kernel, stride, dtype):
    return Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False,
                  dtype=dtype)


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 → 3x3(stride) → 1x1(×4) + downsample."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32):
        super().__init__()
        out = features * 4
        self.conv1 = _conv(in_channels, features, 1, 1, dtype)
        self.bn1 = BatchNorm(features, dtype)
        self.conv2 = _conv(features, features, 3, stride, dtype)
        self.bn2 = BatchNorm(features, dtype)
        self.conv3 = _conv(features, out, 1, 1, dtype)
        self.bn3 = BatchNorm(out, dtype)
        if downsample:
            self.ds_conv = _conv(in_channels, out, 1, stride, dtype)
            self.ds_bn = BatchNorm(out, dtype)
        else:
            self.ds_conv = self.ds_bn = None

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        sc = x if self.ds_conv is None else self.ds_bn(self.ds_conv(x))
        return torch.relu(out + sc)


class ResNetBackbone(nn.Module):
    """conv1..layer4 of torchvision ResNet: NCHW in, [B, 2048, H/32, W/32] out.
    Blocks are named ``layer{stage}_{block}`` as in the JAX module."""

    def __init__(self, blocks: Sequence[int] = STAGE_BLOCKS["resnet101"],
                 dtype=torch.float32, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(64, dtype)
        self.block_names = []
        cin = 64
        for stage, (n_blocks, w) in enumerate(zip(blocks, (64, 128, 256, 512))):
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, Bottleneck(cin, w, stride=stride,
                                                 downsample=(b == 0), dtype=dtype))
                self.block_names.append(name)
                cin = w * 4

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        remat = self.remat and self.training and torch.is_grad_enabled()
        for name in self.block_names:
            block = getattr(self, name)
            if remat:
                x = checkpoint(block, x, use_reentrant=False,
                               context_fn=lambda: (contextlib.nullcontext(),
                                                   dropout.recomputing()))
            else:
                x = block(x)
        return x
