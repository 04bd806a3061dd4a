"""Post-norm transformer encoder/decoder layers (torch semantics),
counterpart of ``visuelle2_tpu/ops/transformer.py``.

ReLU FFN, post-norm, batch-first ``[B, L, D]``, eval mode (no dropout).
Every LayerNorm sets ``eps=1e-6``: that is flax's default, and torch's 1e-5
would drift from the JAX package.

The JAX package's gated layers differ from the standard ones only in one
attention module and, in train mode, in the dropout on its residual; in eval
mode each is the standard layer with that module swapped:

* ``GatedTransformerEncoderLayer`` (gated_v2 trend encoder) —
  ``TransformerEncoderLayer(gated=True)``: ``self_attn`` is
  ``HeadSpecificGatedAttention``;
* ``GatedTransformerDecoderLayerV1`` / ``V2`` — ``TransformerDecoderLayer``
  with ``variant="gated_v1"`` / ``"gated_v2"``: ``cross_attn`` is
  ``GatedCrossAttention`` / ``PureGatedMultiHeadAttention``, and the residual
  is ``norm2(tgt + ca)`` as in the standard layer.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from visuelle2_tpu_torch.ops.attention import (
    GatedCrossAttention,
    HeadSpecificGatedAttention,
    MultiHeadAttention,
    PureGatedMultiHeadAttention,
)

LN_EPS = 1e-6  # flax nn.LayerNorm default

# Decoder variant -> its cross-attention module.
_CROSS_ATTN = {
    "standard": MultiHeadAttention,
    "gated_v1": GatedCrossAttention,
    "gated_v2": PureGatedMultiHeadAttention,
}


class _FFN(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int):
        super().__init__()
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)

    def forward(self, x):
        return self.linear2(torch.relu(self.linear1(x)))


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: Optional[int] = None,
                 gated: bool = False):
        super().__init__()
        self.self_attn = (HeadSpecificGatedAttention if gated else MultiHeadAttention)(
            d_model, nhead)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ffn = _FFN(d_model, dim_feedforward or 2048)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, *, mask=None):
        attn, _ = self.self_attn(src, src, src, mask=mask)
        src = self.norm1(src + attn)
        return self.norm2(src + self.ffn(src))


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: Optional[int] = None,
                 variant: str = "standard"):
        super().__init__()
        if variant not in _CROSS_ATTN:
            raise KeyError(f"unknown decoder variant {variant!r}; known: {sorted(_CROSS_ATTN)}")
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.cross_attn = _CROSS_ATTN[variant](d_model, nhead)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ffn = _FFN(d_model, dim_feedforward or 2048)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt, memory, *, tgt_mask=None, memory_mask=None):
        sa, _ = self.self_attn(tgt, tgt, tgt, mask=tgt_mask)
        tgt = self.norm1(tgt + sa)
        ca, _ = self.cross_attn(tgt, memory, memory, mask=memory_mask)
        tgt = self.norm2(tgt + ca)
        return self.norm3(tgt + self.ffn(tgt))


class TransformerEncoder(nn.Module):
    """Stack of encoder layers named ``layer{i}`` as in the JAX module;
    ``gated=True`` is gated_v2's trend encoder."""

    def __init__(self, d_model: int, nhead: int, num_layers: int,
                 dim_feedforward: Optional[int] = None, gated: bool = False):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, gated=gated))

    def forward(self, src, *, mask=None):
        for i in range(self.num_layers):
            src = getattr(self, f"layer{i}")(src, mask=mask)
        return src


class TransformerDecoder(nn.Module):
    """Stack of decoder layers named ``layer{i}``; ``variant`` is "standard",
    "gated_v1" or "gated_v2"."""

    def __init__(self, d_model: int, nhead: int, num_layers: int,
                 dim_feedforward: Optional[int] = None, variant: str = "standard"):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, variant=variant))

    def forward(self, tgt, memory, *, tgt_mask=None, memory_mask=None):
        for i in range(self.num_layers):
            tgt = getattr(self, f"layer{i}")(tgt, memory, tgt_mask=tgt_mask,
                                             memory_mask=memory_mask)
        return tgt
