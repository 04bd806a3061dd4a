"""Post-norm transformer encoder/decoder layers (torch semantics),
counterpart of ``visuelle2_tpu/ops/transformer.py``.

ReLU FFN, post-norm, batch-first ``[B, L, D]``, eval mode (no dropout).
Every LayerNorm sets ``eps=1e-6``: that is flax's default, and torch's 1e-5
would drift from the JAX package.  Only the "standard" layers are ported; the
gated layers of the Proposed models arrive with the seq2seq-family slice
(ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from visuelle2_tpu_torch.ops.attention import MultiHeadAttention

LN_EPS = 1e-6  # flax nn.LayerNorm default


class _FFN(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int):
        super().__init__()
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)

    def forward(self, x):
        return self.linear2(torch.relu(self.linear1(x)))


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: Optional[int] = None):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ffn = _FFN(d_model, dim_feedforward or 2048)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, *, mask=None):
        attn, _ = self.self_attn(src, src, src, mask=mask)
        src = self.norm1(src + attn)
        return self.norm2(src + self.ffn(src))


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: Optional[int] = None):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.cross_attn = MultiHeadAttention(d_model, nhead)
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
    """Stack of encoder layers named ``layer{i}`` as in the JAX module."""

    def __init__(self, d_model: int, nhead: int, num_layers: int,
                 dim_feedforward: Optional[int] = None, gated: bool = False):
        super().__init__()
        if gated:
            raise NotImplementedError(
                "the gated trend encoder (gated_v2) is ported with the "
                "seq2seq-family slice, ROADMAP Queue 1 item 6")
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}",
                            TransformerEncoderLayer(d_model, nhead, dim_feedforward))

    def forward(self, src, *, mask=None):
        for i in range(self.num_layers):
            src = getattr(self, f"layer{i}")(src, mask=mask)
        return src


class TransformerDecoder(nn.Module):
    """Stack of decoder layers named ``layer{i}``; only ``variant="standard"``."""

    def __init__(self, d_model: int, nhead: int, num_layers: int,
                 dim_feedforward: Optional[int] = None, variant: str = "standard"):
        super().__init__()
        if variant != "standard":
            raise NotImplementedError(
                f"decoder variant {variant!r} is ported with the seq2seq-family "
                "slice, ROADMAP Queue 1 item 6")
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}",
                            TransformerDecoderLayer(d_model, nhead, dim_feedforward))

    def forward(self, tgt, memory, *, tgt_mask=None, memory_mask=None):
        for i in range(self.num_layers):
            tgt = getattr(self, f"layer{i}")(tgt, memory, tgt_mask=tgt_mask,
                                             memory_mask=memory_mask)
        return tgt
