"""Training and evaluation loop helpers, counterpart of
``visuelle2_tpu/train/loop.py``.  So far only what scoring needs:
``target_and_pred`` and ``expand_mask``; the trainer arrives with ROADMAP
Queue 1 item 8.
"""

from __future__ import annotations

import torch


def target_and_pred(batch, forecast: torch.Tensor):
    """Align the target with a model forecast, both as ``[N, H]``.

    stfore: ``y [B, W, H]`` -> ``[B·W, H]``; demand: ``ts [B, 12]``; a
    forecast's trailing singleton dim is squeezed (Demand returns
    ``[N, 12, 1]``).
    """
    if "y" in batch and batch.get("X") is not None:
        y = batch["y"]
        target = y.reshape(-1, y.shape[-1])
    else:
        target = batch["ts"]
    f = forecast
    if f.dim() == 3 and f.shape[-1] == 1 and target.dim() == 2:
        f = f[..., 0]
    return target, f.reshape(target.shape)


def expand_mask(batch, target: torch.Tensor) -> torch.Tensor:
    """Per-item mask -> per-row mask over the flattened window axis."""
    mask = batch.get("mask")
    if mask is None:
        return torch.ones(target.shape[0], dtype=target.dtype, device=target.device)
    reps = target.shape[0] // mask.shape[0]
    return torch.repeat_interleave(mask, reps, dim=0) if reps > 1 else mask
