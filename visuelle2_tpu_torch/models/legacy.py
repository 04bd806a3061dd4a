"""Legacy shared blocks of the reference's ``models/modules.py``, counterpart
of ``visuelle2_tpu/models/legacy.py`` (no reference script imports them; kept
for the inventory's completeness).

* ``LegacyImageEncoder`` — InceptionV3 -> 8 x 8 x 2048 -> 64 patch tokens ->
  ``Linear(E)`` -> dropout 0.1 (``modules.py:65-94``).
* ``LegacyAdditiveAttention`` — the α·h_j variant (``modules.py:97-122``):
  ``ops.attention.AdditiveAttention(weight_on="projected")``, through
  ``fused_additive_attention``.
* ``LegacyTemporalFeatureEncoder`` — every feature through the ``day``
  linear (``modules.py:40-62``):
  ``encoders.TemporalFeatureEncoder(shared_day_embedding=True)``.
* ``TSEmbedder`` / ``AttributeEncoder`` — the per-model copies, re-exported.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from visuelle2_tpu_torch.data.images import normalize_images
from visuelle2_tpu_torch.models.encoders import (  # noqa: F401 (re-exports)
    AttributeEncoder,
    TemporalFeatureEncoder,
    TSEmbedder,
)
from visuelle2_tpu_torch.models.inception import InceptionV3Backbone
from visuelle2_tpu_torch.ops.attention import AdditiveAttention
from visuelle2_tpu_torch.ops.dropout import Dropout

LegacyAdditiveAttention = functools.partial(AdditiveAttention, weight_on="projected")
LegacyTemporalFeatureEncoder = functools.partial(TemporalFeatureEncoder,
                                                 shared_day_embedding=True)


class LegacyImageEncoder(nn.Module):
    """uint8 NHWC 299² -> [B, 64, E] in float32.  ``fine_tune=False`` (the
    reference's default) freezes the whole backbone: no gradient, and its
    BatchNorm on running statistics in train mode too.  The backbone's
    output is an NCHW view of channels_last memory; the patch tokens are
    flattened from NHWC, the JAX order."""

    def __init__(self, embedding_dim: int, fine_tune: bool = False, dropout: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.fine_tune = fine_tune
        self.dtype = dtype
        # "backbone", like every image encoder's CNN.
        self.backbone = InceptionV3Backbone(dtype=dtype)
        if not fine_tune:
            self.backbone.requires_grad_(False)
        self.fc = nn.Linear(2048, embedding_dim)
        self.drop = Dropout(dropout)

    def train(self, mode: bool = True):
        super().train(mode)
        if not self.fine_tune:
            self.backbone.eval()
        return self

    def forward(self, images_u8):
        x = normalize_images(images_u8, dtype=self.dtype).permute(0, 3, 1, 2)
        with torch.set_grad_enabled(self.fine_tune and torch.is_grad_enabled()):
            feats = self.backbone(x).permute(0, 2, 3, 1)
        B, H, W, C = feats.shape
        return self.drop(self.fc(feats.reshape(B, H * W, C).float()))
