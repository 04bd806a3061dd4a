"""InceptionV3 backbone, counterpart of ``visuelle2_tpu/models/inception.py``.

It backs the legacy image encoder (``models/legacy.py``), which feeds 299²
images through torchvision's ``inception_v3`` with its head removed and
keeps the 8 x 8 x 2048 map.  The structure is torchvision's
``inception_v3(aux_logits=False, transform_input=False)``: ``BasicConv2d``
is a convolution with no bias, BatchNorm with eps **1e-3** (not the
ResNet's 1e-5) and ReLU; the stem, then Mixed_5b … Mixed_7c.  The module and
parameter names are torchvision's, which are also the JAX tree's, so
``convert.load_jax_variables`` and a torchvision state dict
(``inception_state_dict_from_torch``) both load it.

The weights are channels_last and the input is an NCHW view of
channels_last memory, as ``models/resnet.py`` runs; the branches are
concatenated along channels, dim 1 here (axis −1 in the JAX package).
Float32 masters, cast to the working dtype on each call, and BatchNorm
folded in the working dtype, as the ResNet does.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

from visuelle2_tpu_torch.models.resnet import BatchNorm, Conv2d

BN_EPS = 1e-3

_Pair = Union[int, Tuple[int, int]]


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: _Pair, stride: int = 1,
                 padding: _Pair = 0, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False,
                           dtype=dtype)
        self.bn = BatchNorm(cout, dtype, eps=BN_EPS)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


def _avgpool3(x):
    # torch AvgPool2d(3, stride=1, padding=1), count_include_pad=True
    return F.avg_pool2d(x, 3, stride=1, padding=1)


def _maxpool3s2(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, dtype=torch.float32):
        super().__init__()
        d = dict(dtype=dtype)
        self.branch1x1 = BasicConv2d(cin, 64, 1, **d)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1, **d)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2, **d)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1, **d)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1, **d)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1, **d)
        self.branch_pool = BasicConv2d(cin, pool_features, 1, **d)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avgpool3(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int, dtype=torch.float32):
        super().__init__()
        d = dict(dtype=dtype)
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2, **d)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1, **d)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1, **d)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2, **d)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _maxpool3s2(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int, dtype=torch.float32):
        super().__init__()
        d, c7 = dict(dtype=dtype), channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192, 1, **d)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1, **d)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3), **d)
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0), **d)
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1, **d)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0), **d)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3), **d)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0), **d)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3), **d)
        self.branch_pool = BasicConv2d(cin, 192, 1, **d)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avgpool3(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int, dtype=torch.float32):
        super().__init__()
        d = dict(dtype=dtype)
        self.branch3x3_1 = BasicConv2d(cin, 192, 1, **d)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2, **d)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1, **d)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3), **d)
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0), **d)
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2, **d)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7, _maxpool3s2(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, dtype=torch.float32):
        super().__init__()
        d = dict(dtype=dtype)
        self.branch1x1 = BasicConv2d(cin, 320, 1, **d)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1, **d)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1), **d)
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0), **d)
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1, **d)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1, **d)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1), **d)
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0), **d)
        self.branch_pool = BasicConv2d(cin, 192, 1, **d)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avgpool3(x))], dim=1)


class InceptionV3Backbone(nn.Module):
    """Stem + Mixed_5b..7c: NCHW [B, 3, 299, 299] -> [B, 2048, 8, 8]."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        d = dict(dtype=dtype)
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2, **d)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3, **d)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1, **d)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1, **d)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3, **d)
        self.Mixed_5b = InceptionA(192, 32, **d)
        self.Mixed_5c = InceptionA(256, 64, **d)
        self.Mixed_5d = InceptionA(288, 64, **d)
        self.Mixed_6a = InceptionB(288, **d)
        self.Mixed_6b = InceptionC(768, 128, **d)
        self.Mixed_6c = InceptionC(768, 160, **d)
        self.Mixed_6d = InceptionC(768, 160, **d)
        self.Mixed_6e = InceptionC(768, 192, **d)
        self.Mixed_7a = InceptionD(768, **d)
        self.Mixed_7b = InceptionE(1280, **d)
        self.Mixed_7c = InceptionE(2048, **d)
        self.to(memory_format=torch.channels_last)

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _maxpool3s2(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _maxpool3s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x


def inception_state_dict_from_torch(state_dict) -> dict:
    """A torchvision ``inception_v3`` state dict -> ``InceptionV3Backbone``'s
    (the JAX ``inception_params_from_torch``): the BasicConv2d leaves under
    their own names, as float32; ``AuxLogits.`` (torchvision's pretrained
    net ships its auxiliary classifier), the ``fc`` head and the BatchNorms'
    ``num_batches_tracked`` are left out."""
    keep = (".conv.weight", ".bn.weight", ".bn.bias", ".bn.running_mean", ".bn.running_var")
    return {k: torch.as_tensor(v).float() for k, v in state_dict.items()
            if k.endswith(keep) and not k.startswith("AuxLogits.")}
