"""Modality encoders, counterpart of ``visuelle2_tpu/models/encoders.py``.

* ``TSEmbedder``         — GRU over the trend series (CrossAttnRNN family)
* ``SalesEncoder``       — GRU over the sales history
* ``AttributeEncoder``   — 4 embeddings, combine ∈ {sum, stack, concat_proj}
* ``DummyEmbedder``      — 4 scalar linears -> concat -> fuse (GTM style)
* ``TemporalEmbedder``   — 4 scalar linears -> concat -> proj to hidden_dim
  (M4FT style)
* ``TemporalFeatureEncoder`` — 4 scalar linears summed (CrossAttnRNN style);
  ``shared_day_embedding`` applies the one ``day`` linear to all four
* ``ImagePatchEncoder``  — uint8 NHWC -> normalize -> ResNet -> patch tokens
  in the JAX NHWC order, cast to f32 -> linear (CrossAttnRNN family)
* ``ImagePooledEncoder`` — uint8 NHWC -> normalize -> ResNet -> 1x1 conv ->
  global mean [-> final proj]; the pooled mean is computed in the working
  dtype and cast to f32, as in the JAX package
* ``GTrendEmbedder``     — linear -> sinusoidal positions -> post-norm
  encoder under the gcd block mask; ``gated=True`` is gated_v2's encoder,
  whose self-attention runs the fused gated-MHA kernel

Train mode drops where the JAX encoders do, at their rates: the GRU
encoders' outputs (0.1), the attribute embeddings (0.1; each one before the
sum, or the stack, or the projection), the temporal embedders' outputs (0.2
GTM / M4FT, 0.1 each feature for CrossAttnRNN), the patch encoder's
projection (0.1), and the trend encoder's positions (0.1) and layers (0.2).
``ImagePooledEncoder`` has no dropout, as in the JAX package; ``remat``
reaches its backbone.

A dedup batch's ``img_idx`` indexes the global slot axis: under data
parallelism each rank encodes its slot block, and the global features are
gathered (with their gradient) before the rows take theirs
(``parallel/collectives.py::select_global_rows``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from visuelle2_tpu_torch.data.images import normalize_images
from visuelle2_tpu_torch.models.resnet import STAGE_BLOCKS, Conv2d, ResNetBackbone
from visuelle2_tpu_torch.ops.dropout import Dropout
from visuelle2_tpu_torch.ops.gru import GRU
from visuelle2_tpu_torch.ops.masks import gcd_block_mask
from visuelle2_tpu_torch.ops.positional import PositionalEncoding
from visuelle2_tpu_torch.ops.transformer import TransformerEncoder
from visuelle2_tpu_torch.parallel import collectives


class TSEmbedder(nn.Module):
    """GRU over the trend series: [B, T, C] -> dropout(outputs [B, T, E])."""

    def __init__(self, embedding_dim: int, input_dim: int = 3):
        super().__init__()
        self.gru = GRU(input_dim, embedding_dim)
        self.drop = Dropout(0.1)

    def forward(self, x):
        return self.drop(self.gru(x)[0])


class SalesEncoder(nn.Module):
    """GRU over sales history: [B, T, I] -> dropout(outputs [B, T, H])."""

    def __init__(self, embedding_dim: int, input_dim: int = 1):
        super().__init__()
        self.gru = GRU(input_dim, embedding_dim)
        self.drop = Dropout(0.1)

    def forward(self, x):
        return self.drop(self.gru(x)[0])


class AttributeEncoder(nn.Module):
    """Category/color/fabric/store embeddings.

    combine="sum" -> [B, E]; "stack" -> [B, 4, E]; "concat_proj" -> [B, H].
    """

    def __init__(self, num_cat: int, num_col: int, num_fab: int, num_store: int,
                 embedding_dim: int, combine: str = "sum",
                 hidden_dim: Optional[int] = None):
        super().__init__()
        if combine not in ("sum", "stack", "concat_proj"):
            raise ValueError(combine)
        E = embedding_dim
        self.combine = combine
        self.cat = nn.Embedding(num_cat, E)
        self.col = nn.Embedding(num_col, E)
        self.fab = nn.Embedding(num_fab, E)
        self.store = nn.Embedding(num_store, E)
        if combine == "concat_proj":
            self.proj = nn.Linear(4 * E, hidden_dim or E)
        self.drop = Dropout(0.1)

    def forward(self, cat, col, fab, store):
        embs = [self.cat(cat), self.col(col), self.fab(fab), self.store(store)]
        if self.combine == "sum":
            # Each embedding dropped on its own, then summed.
            embs = [self.drop(e) for e in embs]
            return embs[0] + embs[1] + embs[2] + embs[3]
        if self.combine == "stack":
            return self.drop(torch.stack(embs, dim=1))
        return self.drop(self.proj(torch.cat(embs, dim=-1)))


class DummyEmbedder(nn.Module):
    """GTM temporal encoder: 4 linears -> concat -> fuse -> dropout."""

    def __init__(self, embedding_dim: int):
        super().__init__()
        E = embedding_dim
        self.day = nn.Linear(1, E)
        self.week = nn.Linear(1, E)
        self.month = nn.Linear(1, E)
        self.year = nn.Linear(1, E)
        self.fusion = nn.Linear(4 * E, E)
        self.drop = Dropout(0.2)

    def forward(self, temporal):
        parts = [layer(temporal[:, i: i + 1])
                 for i, layer in enumerate((self.day, self.week, self.month, self.year))]
        return self.drop(self.fusion(torch.cat(parts, dim=-1)))


class TemporalEmbedder(nn.Module):
    """M4FT temporal encoder: 4 linears -> concat -> proj to hidden_dim ->
    dropout."""

    def __init__(self, embedding_dim: int, hidden_dim: int):
        super().__init__()
        E = embedding_dim
        self.day = nn.Linear(1, E)
        self.week = nn.Linear(1, E)
        self.month = nn.Linear(1, E)
        self.year = nn.Linear(1, E)
        self.proj = nn.Linear(4 * E, hidden_dim)
        self.drop = Dropout(0.2)

    def forward(self, temporal):
        parts = [layer(temporal[:, i: i + 1])
                 for i, layer in enumerate((self.day, self.week, self.month, self.year))]
        return self.drop(self.proj(torch.cat(parts, dim=-1)))


class TemporalFeatureEncoder(nn.Module):
    """Four scalar features -> E each, summed.  ``shared_day_embedding=True``
    applies the ``day`` linear to all four features, as the reference Demand
    model does; the JAX tree then holds only ``day``."""

    def __init__(self, embedding_dim: int, shared_day_embedding: bool = False):
        super().__init__()
        E = embedding_dim
        self.drop = Dropout(0.1)
        self.day = nn.Linear(1, E)
        if shared_day_embedding:
            self.week = self.month = self.year = None
        else:
            self.week = nn.Linear(1, E)
            self.month = nn.Linear(1, E)
            self.year = nn.Linear(1, E)

    def forward(self, temporal):
        layers = ([self.day] * 4 if self.week is None
                  else [self.day, self.week, self.month, self.year])
        out = 0.0
        for i, layer in enumerate(layers):
            out = out + self.drop(layer(temporal[:, i: i + 1]))
        return out


class ImagePatchEncoder(nn.Module):
    """ResNet -> patch tokens -> linear: uint8 NHWC [B, H, W, 3] ->
    [B, (H/32)·(W/32), E] in f32; ``img_idx`` (optional [N] int) expands the
    features of unique images to rows by gather."""

    def __init__(self, embedding_dim: int, arch: str = "resnet101", dtype=torch.float32,
                 remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.backbone = ResNetBackbone(STAGE_BLOCKS[arch], dtype=dtype, remat=remat)
        self.fc = nn.Linear(2048, embedding_dim)
        self.drop = Dropout(0.1)

    def forward(self, images_u8, img_idx=None):
        x = normalize_images(images_u8, dtype=self.dtype).permute(0, 3, 1, 2)
        # The backbone's output is an NCHW view of channels_last memory; the
        # JAX patch order is that of NHWC, so flatten from NHWC.
        feats = self.backbone(x).permute(0, 2, 3, 1)
        B, H, W, C = feats.shape
        out = self.drop(self.fc(feats.reshape(B, H * W, C).float()))
        if img_idx is not None:
            out = collectives.select_global_rows(out, img_idx)
        return out


class ImagePooledEncoder(nn.Module):
    """ResNet -> 1x1 conv projection -> global average pool [-> final proj].

    Takes uint8 NHWC images; ``img_idx`` (optional [N] int) expands the
    pooled features of unique images to rows by gather.
    """

    def __init__(self, embedding_dim: int, final_dim: Optional[int] = None,
                 arch: str = "resnet101", dtype=torch.float32, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.backbone = ResNetBackbone(STAGE_BLOCKS[arch], dtype=dtype, remat=remat)
        self.projection = Conv2d(2048, embedding_dim, 1, bias=True, dtype=dtype)
        self.final_proj = (None if final_dim is None
                           else nn.Linear(embedding_dim, final_dim))

    def forward(self, images_u8, img_idx=None):
        x = normalize_images(images_u8, dtype=self.dtype).permute(0, 3, 1, 2)
        proj = self.projection(self.backbone(x))
        pooled = proj.mean(dim=(2, 3)).float()
        if self.final_proj is not None:
            pooled = self.final_proj(pooled)
        if img_idx is not None:
            pooled = collectives.select_global_rows(pooled, img_idx)
        return pooled


class GTrendEmbedder(nn.Module):
    """Trend transformer encoder with the gcd block mask:
    gtrends [B, num_trends, trend_len] -> memory [B, trend_len, E]."""

    def __init__(self, forecast_horizon: int, embedding_dim: int, num_trends: int = 3,
                 trend_len: int = 52, use_mask: bool = True, num_layers: int = 2,
                 nhead: int = 4, gated: bool = False):
        super().__init__()
        self.forecast_horizon = forecast_horizon
        self.use_mask = use_mask
        self.input_linear = nn.Linear(num_trends, embedding_dim)
        self.pos = PositionalEncoding(embedding_dim, max_len=trend_len)
        self.encoder = TransformerEncoder(embedding_dim, nhead, num_layers,
                                          dim_feedforward=2048, gated=gated, dropout=0.2)

    def forward(self, gtrends):
        x = self.pos(self.input_linear(gtrends.transpose(1, 2)))
        mask = (gcd_block_mask(x.shape[1], self.forecast_horizon, device=x.device)
                if self.use_mask else None)
        return self.encoder(x, mask=mask)
