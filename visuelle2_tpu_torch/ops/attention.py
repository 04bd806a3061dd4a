"""Attention modules, counterpart of ``visuelle2_tpu/ops/attention.py``.

Every module here returns ``(output, probabilities or None)``, as torch's
``nn.MultiheadAttention`` does, so the transformer layers take any of them.

* ``MultiHeadAttention`` — separate q/k/v/out projections (named like the JAX
  ``nn.Dense`` children), batch-first ``[B, L, D]``, scores ``q·kᵀ/√d`` plus
  an additive 0/−inf mask.  Its probabilities are averaged over heads.
  Plain tensor code: the JAX package ran it through plain XLA too.
* ``PureGatedMultiHeadAttention`` / ``HeadSpecificGatedAttention`` — gated_v2's
  cross- and self-attention.  Their weights are ``_Weights`` children in the
  JAX ``[in, out]`` layout, so the fused kernel reads them as they are; the
  forward always goes through ``ops/cuda/gated_mha.py::fused_gated_mha``,
  which launches the CUDA kernel on the card and runs its plain version on
  the CPU.  No probabilities.
* ``GatedCrossAttention`` — gated_v1's query-gated standard MHA (plain XLA in
  the JAX package, plain tensor code here).  No probabilities.
* ``AdditiveAttention`` — the CrossAttnRNN family's Bahdanau attention,
  ``weight_on`` "inputs" or "projected"; ``_Weights`` children as in the JAX
  module, and the forward always goes through
  ``ops/cuda/additive_attention.py::fused_additive_attention``.  Returns
  (weighted encoding, α).

Eval mode only: attention dropout is the identity there.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from visuelle2_tpu_torch.ops.cuda.additive_attention import fused_additive_attention
from visuelle2_tpu_torch.ops.cuda.gated_mha import fused_gated_mha
from visuelle2_tpu_torch.ops.heads import merge_heads, split_heads

GATE_BIAS_INIT = 2.0  # gated_v2's gates start open, as the JAX initializers set them


class _Weights(nn.Module):
    """Parameters in the JAX Dense layout: kernel [in, out], optional bias
    [out] that starts at ``bias_init``."""

    def __init__(self, in_features: int, out_features: int, *, use_bias: bool = True,
                 bias_init: float = 0.0):
        super().__init__()
        self.bias_init = bias_init
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = (nn.Parameter(torch.full((out_features,), bias_init))
                     if use_bias else None)


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query, key, value, *, mask: Optional[torch.Tensor] = None):
        h = self.num_heads
        qh = split_heads(self.q_proj(query), h)
        kh = split_heads(self.k_proj(key), h)
        vh = split_heads(self.v_proj(value), h)
        scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * (qh.shape[-1] ** -0.5)
        if mask is not None:
            scores = scores + mask
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
        return self.out_proj(merge_heads(out)), probs.mean(dim=1)


class _GatedMHABase(nn.Module):
    """gated_v2's gated MHA; ``variant`` "pure" gates the merged heads by
    σ(query·Wg + bg), Wg [D, D]; "head" gates each head's context by
    σ(q_h·Wg + bg), Wg [d, d].  The gate bias starts at ``GATE_BIAS_INIT``."""

    variant = "pure"

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        D = embed_dim
        self.num_heads = num_heads
        self.q_proj = _Weights(D, D)
        self.k_proj = _Weights(D, D)
        self.v_proj = _Weights(D, D)
        G = D // num_heads if self.variant == "head" else D
        self.gate_proj = _Weights(G, G, bias_init=GATE_BIAS_INIT)
        self.out_proj = _Weights(D, D)

    def kernel_inputs(self, query, key, value, mask: Optional[torch.Tensor] = None):
        """The positional arguments this module hands ``fused_gated_mha``.

        The mask goes over as the JAX package hands it to its kernel: zeros
        [Lq, Lk] when there is none, else broadcast to [Lq, Lk]."""
        Lq, Lk = query.shape[1], key.shape[1]
        m = (query.new_zeros(Lq, Lk) if mask is None
             else mask.to(torch.float32).expand(Lq, Lk).contiguous())
        w = [p for mod in (self.q_proj, self.k_proj, self.v_proj, self.gate_proj,
                           self.out_proj) for p in (mod.kernel, mod.bias)]
        return [query, key, value, m, *w]

    def forward(self, query, key, value, *, mask: Optional[torch.Tensor] = None):
        return fused_gated_mha(*self.kernel_inputs(query, key, value, mask),
                               num_heads=self.num_heads, variant=self.variant), None


class PureGatedMultiHeadAttention(_GatedMHABase):
    """gated_v2 decoder cross-attention: the merged heads gated by
    σ(query·Wg + bg) before the out projection."""

    variant = "pure"


class HeadSpecificGatedAttention(_GatedMHABase):
    """gated_v2 trend-encoder self-attention: each head's context gated by
    σ(q_h·Wg + bg) on head_dim."""

    variant = "head"


class GatedCrossAttention(nn.Module):
    """gated_v1 cross-attention: standard MHA (under ``mha``), its output
    gated by σ(gate_proj(query)).  The residual lives in the decoder layer."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.mha = MultiHeadAttention(embed_dim, num_heads)
        self.gate_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query, key, value, *, mask: Optional[torch.Tensor] = None):
        attn_out, _ = self.mha(query, key, value, mask=mask)
        return attn_out * torch.sigmoid(self.gate_proj(query)), None


class AdditiveAttention(nn.Module):
    """Bahdanau attention: α = softmax_L(v·tanh(enc·We + dec·Wd) + vb);
    returns (α-weighted enc or enc·We [B, L, Dw], α [B, L])."""

    def __init__(self, encoder_dim: int, decoder_dim: int, attention_dim: int,
                 weight_on: str = "inputs"):
        super().__init__()
        self.weight_on = weight_on
        self.encoder_linear = _Weights(encoder_dim, attention_dim, use_bias=False)
        self.decoder_linear = _Weights(decoder_dim, attention_dim, use_bias=False)
        self.attn_linear = _Weights(attention_dim, 1)

    def kernel_inputs(self, encoder_out, decoder_hidden):
        """The positional arguments this module hands ``fused_additive_attention``."""
        return [encoder_out, decoder_hidden, self.encoder_linear.kernel,
                self.decoder_linear.kernel, self.attn_linear.kernel, self.attn_linear.bias]

    def forward(self, encoder_out, decoder_hidden):
        return fused_additive_attention(*self.kernel_inputs(encoder_out, decoder_hidden),
                                        weight_on=self.weight_on)
