"""Multi-head attention, counterpart of
``visuelle2_tpu/ops/attention.py::MultiHeadAttention``.

Separate q/k/v/out projections (named like the JAX ``nn.Dense`` children),
batch-first ``[B, L, D]``, scores ``q·kᵀ/√d`` plus an additive 0/−inf mask.
Returns the output and the probabilities averaged over heads, as torch's
``nn.MultiheadAttention(need_weights=True)`` does.  Plain tensor code: the
JAX package ran this through plain XLA too, with no Pallas kernel.
The gated variants arrive with the seq2seq-family slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, L, D = x.shape
    return x.reshape(B, L, num_heads, D // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, h, L, d = x.shape
    return x.transpose(1, 2).reshape(B, L, h * d)


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
        qh = _split_heads(self.q_proj(query), h)
        kh = _split_heads(self.k_proj(key), h)
        vh = _split_heads(self.v_proj(value), h)
        scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * (qh.shape[-1] ** -0.5)
        if mask is not None:
            scores = scores + mask
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
        return self.out_proj(_merge_heads(out)), probs.mean(dim=1)
