"""BatchNorm1d over ``[B, F]`` features, counterpart of
``visuelle2_tpu/models/norms.py``.

Used by the GTM and M4FT fusion MLPs.  It normalises by the JAX package's
formula as written, ``(x - mean) / sqrt(var + eps) * scale + bias`` in
float32 — not the folded form of ``resnet.BatchNorm``, which rounds
differently — with the running statistics in eval mode and the batch's mean
and biased variance in train mode, where the running statistics move with
momentum 0.1 and the unbiased variance.
"""

from __future__ import annotations

import torch
from torch import nn

from visuelle2_tpu_torch.models.resnet import batch_statistics, update_running


class BatchNorm1d(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if self.training:
            mean, var, n = batch_statistics(x, (0,))
            update_running(self, mean, var, n)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias
