"""BatchNorm1d over ``[B, F]`` features, counterpart of
``visuelle2_tpu/models/norms.py``, in eval mode.

Used by the GTM and M4FT fusion MLPs.  It normalises with the running
statistics by the JAX package's formula as written,
``(x - mean) / sqrt(var + eps) * scale + bias`` in float32 — not the folded
form of ``resnet.BatchNorm``, which rounds differently.  Batch statistics
arrive with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm1d(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        return ((x - self.running_mean) / torch.sqrt(self.running_var + self.eps)
                * self.weight + self.bias)
