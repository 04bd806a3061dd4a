"""ResNet-v1 backbone (ResNet-50/101), eval mode, counterpart of
``visuelle2_tpu/models/resnet.py``.

The public input is the JAX layout, NHWC; ``ImagePooledEncoder`` hands the
backbone ``x.permute(0, 3, 1, 2)``, which is already a channels_last view, so
cuDNN runs NHWC convolutions without a copy.  Convolutions hold their weights
in the working dtype (bf16 on the main path; the JAX package casts its f32
kernels to that dtype on every call, which rounds the same way).  BatchNorm
keeps f32 parameters and running statistics and folds them in the working
dtype exactly as the JAX ``BatchNorm`` does: ``inv = dtype(scale) *
dtype(1/√(var+eps))`` and ``shift = dtype(bias − mean·scale/√(var+eps))``.
Training (batch statistics) arrives with the training slice.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

STAGE_BLOCKS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    # One bottleneck per stage: the same code paths at toy cost, for tests.
    "tiny": (1, 1, 1, 1),
}


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm2d over NCHW, folded in the working dtype."""

    def __init__(self, features: int, dtype=torch.float32, eps: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        std = torch.sqrt(self.running_var + self.eps)
        inv = self.weight.to(self.dtype) * (1.0 / std).to(self.dtype)
        shift = (self.bias - self.running_mean * self.weight / std).to(self.dtype)
        return x * inv[:, None, None] + shift[:, None, None]


def _conv(cin, cout, kernel, stride, dtype):
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2,
                     bias=False, dtype=dtype)


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
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False, dtype=dtype)
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
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x
