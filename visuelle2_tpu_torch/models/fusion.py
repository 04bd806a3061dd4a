"""TG-Fusion (gated_v4), counterpart of ``visuelle2_tpu/models/fusion.py``
(``_GateParams``, ``_gated_residual``, ``TextGuidedFusionNetwork``).

The gate kernel is the Dense kernel over the concatenation ``[ctx, x]``:
rows ``0..C-1`` belong to ctx (Wc), the rest to x (Wx).  It keeps that JAX
layout, ``[in, out]``, and ``_gated_residual`` hands ``kernel[C:]`` and
``kernel[:C]`` to the fused kernel exactly as the JAX package does.  The
fused kernel runs on every forward on the card.  The other fusion networks
arrive with the seq2seq-family slice.
"""

from __future__ import annotations

import torch
from torch import nn

from visuelle2_tpu_torch.ops.cuda.gated_fusion import fused_gated_residual
from visuelle2_tpu_torch.ops.transformer import LN_EPS


class _GateParams(nn.Module):
    """Gate parameters in the Dense layout: kernel [in, out], bias [out]."""

    def __init__(self, in_features: int, out_features: int, bias_init: float = 0.0):
        super().__init__()
        self.bias_init = bias_init
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.full((out_features,), bias_init))


def _gated_residual(x, ctx, kernel, bias, *, residual=True):
    """σ-gate with ``concat([ctx, x]) @ kernel + bias`` semantics, run by the
    fused kernel; residual=True -> x + x·g, else x·g."""
    C = ctx.shape[-1]
    return fused_gated_residual(x, ctx, kernel[C:], kernel[:C], bias,
                                residual=residual)


def _flatten_text(text_encoding):
    """[B, 4, E] -> [B, 4E]."""
    return text_encoding.reshape(text_encoding.shape[0], -1)


class TextGuidedFusionNetwork(nn.Module):
    """v4 TG-Fusion: text-anchored soft gates on image and temporal, concat,
    Linear -> LayerNorm -> ReLU."""

    def __init__(self, embedding_dim: int, hidden_dim: int, num_text: int = 4,
                 use_img: bool = True):
        super().__init__()
        E = embedding_dim
        C = num_text * E
        self.dummy_gate_fc = _GateParams(C + E, E)
        self.img_gate_fc = _GateParams(C + E, E) if use_img else None
        self.fusion_fc = nn.Linear(C + E + (E if use_img else 0), hidden_dim)
        self.fusion_norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)

    def forward(self, img, text, dummy):
        if text is None:
            raise ValueError("TG-Fusion is text-anchored: use_text=False is "
                             "structurally impossible for gated_v4")
        if (img is None) != (self.img_gate_fc is None):
            raise ValueError("img must be given exactly when the network was "
                             "built with use_img=True")
        text_flat = _flatten_text(text)
        parts = [text_flat, _gated_residual(dummy, text_flat, self.dummy_gate_fc.kernel,
                                            self.dummy_gate_fc.bias)]
        if img is not None:
            parts.insert(0, _gated_residual(img, text_flat, self.img_gate_fc.kernel,
                                            self.img_gate_fc.bias))
        x = self.fusion_fc(torch.cat(parts, dim=-1))
        return torch.relu(self.fusion_norm(x))
