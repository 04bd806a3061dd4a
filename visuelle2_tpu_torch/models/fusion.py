"""Fusion networks of the seq2seq family, counterpart of
``visuelle2_tpu/models/fusion.py``.

* ``GTMFusionNetwork``          — concat(img, text_flat, dummy) -> BN -> MLP
* ``FusionBlock`` / ``M4FTFusionNetwork`` — hierarchical summation fusion
* ``GatedResidualBlock`` / ``ResidualGatedFusionNetwork`` — v1 per-modality
  soft gates + LayerNorm residual
* ``PureGatedFusionNetwork``    — v2 post-concat soft gate, bias init +2.0
* ``TARGFusionNetwork``         — v3 target-anchored residual gating
* ``TextGuidedFusionNetwork``   — v4 text-anchored gates on image/temporal

The JAX modules size their layers from the inputs they first see; the port
sizes them at construction, so the networks that concatenate take the
``use_img``/``use_text`` ablation flags.  An ablated modality is ``None`` at
the call, as in the JAX package.

Only TG-Fusion (v4) runs a kernel: its gate kernel is the Dense kernel over
the concatenation ``[ctx, x]`` — rows ``0..C-1`` belong to ctx (Wc), the rest
to x (Wx) — kept in that JAX layout, ``[in, out]``, and ``_gated_residual``
hands ``kernel[C:]`` and ``kernel[:C]`` to the fused kernel exactly as the
JAX package does.  The v1–v3 gates are plain tensor code, as the JAX package
computes them in plain XLA.
"""

from __future__ import annotations

import torch
from torch import nn

from visuelle2_tpu_torch.models.norms import BatchNorm1d
from visuelle2_tpu_torch.ops.attention import GATE_BIAS_INIT, _Weights
from visuelle2_tpu_torch.ops.cuda.gated_fusion import fused_gated_residual
from visuelle2_tpu_torch.ops.transformer import LN_EPS


def _gated_residual(x, ctx, kernel, bias, *, residual=True):
    """σ-gate with ``concat([ctx, x]) @ kernel + bias`` semantics, run by the
    fused kernel; residual=True -> x + x·g, else x·g."""
    C = ctx.shape[-1]
    return fused_gated_residual(x, ctx, kernel[C:], kernel[:C], bias,
                                residual=residual)


def _flatten_text(text_encoding):
    """[B, 4, E] -> [B, 4E]."""
    return text_encoding.reshape(text_encoding.shape[0], -1)


def _concat_width(E: int, use_img: bool, use_text: bool, num_text: int = 4) -> int:
    """Width of concat(img E, text_flat 4E, dummy E) with ablations."""
    return E * (1 + use_img + num_text * use_text)


def _concat(img, text, dummy):
    parts = [p for p in (img, None if text is None else _flatten_text(text), dummy)
             if p is not None]
    return torch.cat(parts, dim=-1)


class GTMFusionNetwork(nn.Module):
    """Concat fusion: img(E) ⊕ text(4E) ⊕ dummy(E) -> BN -> Linear (no bias)
    -> ReLU -> Linear(H)."""

    def __init__(self, embedding_dim: int, hidden_dim: int, use_img: bool = True,
                 use_text: bool = True):
        super().__init__()
        D = _concat_width(embedding_dim, use_img, use_text)
        self.bn = BatchNorm1d(D)
        self.fc1 = nn.Linear(D, D, bias=False)
        self.fc2 = nn.Linear(D, hidden_dim)

    def forward(self, img, text, dummy):
        x = self.bn(_concat(img, text, dummy))
        return self.fc2(torch.relu(self.fc1(x)))


class FusionBlock(nn.Module):
    """BN -> Linear -> ReLU -> Linear."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.bn = BatchNorm1d(hidden_dim)
        self.fc1 = nn.Linear(hidden_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(self.bn(x))))


class M4FTFusionNetwork(nn.Module):
    """Hierarchical summation: out_tt = FB(temp+text); out_tv = FB(text+vis);
    final = FB(out_tt + out_tv + temp + text + vis).  Ablated inputs are
    zeros, so the block structure stays."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.fusion_temp_text = FusionBlock(hidden_dim)
        self.fusion_text_vis = FusionBlock(hidden_dim)
        self.fusion_final = FusionBlock(hidden_dim)

    def forward(self, e_temp, e_text, e_vis):
        zero = torch.zeros_like(e_temp)
        e_text = zero if e_text is None else e_text
        e_vis = zero if e_vis is None else e_vis
        out_tt = self.fusion_temp_text(e_temp + e_text)
        out_tv = self.fusion_text_vis(e_text + e_vis)
        return self.fusion_final(out_tt + out_tv + e_temp + e_text + e_vis)


class GatedResidualBlock(nn.Module):
    """LayerNorm(x + x·σ(Wx + b))."""

    def __init__(self, features: int):
        super().__init__()
        self.gate_fc = nn.Linear(features, features)
        self.norm = nn.LayerNorm(features, eps=LN_EPS)

    def forward(self, x):
        return self.norm(x + x * torch.sigmoid(self.gate_fc(x)))


class ResidualGatedFusionNetwork(nn.Module):
    """v1: a gated residual block per modality, concat, Linear -> ReLU."""

    def __init__(self, embedding_dim: int, hidden_dim: int, use_img: bool = True,
                 use_text: bool = True, num_text: int = 4):
        super().__init__()
        E = embedding_dim
        self.img_gate = GatedResidualBlock(E) if use_img else None
        self.text_gate = GatedResidualBlock(num_text * E) if use_text else None
        self.dummy_gate = GatedResidualBlock(E)
        self.fusion_fc = nn.Linear(_concat_width(E, use_img, use_text, num_text),
                                   hidden_dim)

    def forward(self, img, text, dummy):
        parts = []
        if img is not None:
            parts.append(self.img_gate(img))
        if text is not None:
            parts.append(self.text_gate(_flatten_text(text)))
        parts.append(self.dummy_gate(dummy))
        return torch.relu(self.fusion_fc(torch.cat(parts, dim=-1)))


class PureGatedFusionNetwork(nn.Module):
    """v2: concat all, soft gate x + x·σ(Wx + b), Linear -> ReLU.  The gate is
    a Dense in the JAX package whose bias starts at +2.0; here it is a
    ``_Weights`` (kernel [in, out]), the type whose init rule honours
    ``bias_init``."""

    def __init__(self, embedding_dim: int, hidden_dim: int, use_img: bool = True,
                 use_text: bool = True):
        super().__init__()
        D = _concat_width(embedding_dim, use_img, use_text)
        self.gate_fc = _Weights(D, D, bias_init=GATE_BIAS_INIT)
        self.fusion_fc = nn.Linear(D, hidden_dim)

    def forward(self, img, text, dummy):
        x = _concat(img, text, dummy)
        x = x + x * torch.sigmoid(x @ self.gate_fc.kernel + self.gate_fc.bias)
        return torch.relu(self.fusion_fc(x))


# query_modality -> (anchor, context 1, context 2)
_TARG_ORDER = {
    "text": ("text", "image", "temporal"),
    "image": ("image", "text", "temporal"),
    "temporal": ("temporal", "text", "image"),
}


class TARGFusionNetwork(nn.Module):
    """v3 TARG: the anchor modality Q kept as is, each context Cᵢ gated by
    σ(W[Q; Cᵢ]) and added; a FusionBlock on top.  ``gate_fc{i}`` counts the
    contexts in order, ablated ones too, as the JAX module names them."""

    def __init__(self, hidden_dim: int, query_modality: str = "text",
                 use_img: bool = True, use_text: bool = True):
        super().__init__()
        if query_modality not in _TARG_ORDER:
            raise ValueError(f"query_modality {query_modality!r} is not one of "
                             f"{sorted(_TARG_ORDER)}")
        self.order = _TARG_ORDER[query_modality]
        present = {"text": use_text, "image": use_img, "temporal": True}
        if not present[self.order[0]]:
            raise ValueError(f"TARG anchor modality '{query_modality}' is ablated "
                             "(use_text/use_img) — pick another query_modality")
        for i, modality in enumerate(self.order[1:], start=1):
            if present[modality]:
                self.add_module(f"gate_fc{i}", nn.Linear(2 * hidden_dim, hidden_dim))
        self.fusion_final = FusionBlock(hidden_dim)

    def forward(self, e_temp, e_text, e_vis):
        values = {"text": e_text, "image": e_vis, "temporal": e_temp}
        q = values[self.order[0]]
        fused = q
        for i, modality in enumerate(self.order[1:], start=1):
            c = values[modality]
            if c is not None:
                g = torch.sigmoid(getattr(self, f"gate_fc{i}")(torch.cat([q, c], dim=-1)))
                fused = fused + c * g
        return self.fusion_final(fused)


class TextGuidedFusionNetwork(nn.Module):
    """v4 TG-Fusion: text-anchored soft gates on image and temporal, concat,
    Linear -> LayerNorm -> ReLU.  Both gates run the fused kernel."""

    def __init__(self, embedding_dim: int, hidden_dim: int, num_text: int = 4,
                 use_img: bool = True):
        super().__init__()
        E = embedding_dim
        C = num_text * E
        self.dummy_gate_fc = _Weights(C + E, E)
        self.img_gate_fc = _Weights(C + E, E) if use_img else None
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
