"""Additive attention masks (0 / −inf), counterpart of
``visuelle2_tpu/ops/masks.py``.

The masks are additive with −inf, not boolean: a masked score becomes −inf
before the softmax, as in the JAX package.  No row of either mask is fully
masked, so the softmax never sees an all −inf row.
"""

from __future__ import annotations

import math

import torch


def _additive(allowed: torch.Tensor, dtype) -> torch.Tensor:
    return torch.full(allowed.shape, float("-inf"), dtype=dtype,
                      device=allowed.device).masked_fill(allowed, 0.0)


def gcd_block_mask(size: int, forecast_horizon: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """Block-diagonal encoder mask: trend self-attention stays inside
    contiguous blocks of ``gcd(size, horizon)`` steps."""
    split = math.gcd(size, forecast_horizon)
    idx = torch.arange(size, device=device)
    return _additive((idx[:, None] // split) == (idx[None, :] // split), dtype)


def causal_mask(size: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Square subsequent mask for autoregressive decoding."""
    idx = torch.arange(size, device=device)
    return _additive(idx[None, :] <= idx[:, None], dtype)
