"""Forecast error metrics, counterpart of ``visuelle2_tpu/ops/metrics.py``.

WAPE and MAE on rescaled values with the ``Σ|gt|`` denominator;
``calc_error_metrics`` keeps the reference's ``sum(gt)`` denominator and its
rounding, for the statistical baselines.  ``eval_metrics`` returns masked
partial sums that add exactly across batches and stay on the device until
``finalize_metrics``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def calc_error_metrics(gt, forecasts):
    """(MAE, WAPE) in float64, rounded to 3 decimals; the WAPE denominator is
    ``sum(gt)``, not ``sum(|gt|)``."""
    gt = np.asarray(gt, np.float64)
    forecasts = np.asarray(forecasts, np.float64)
    mae_v = np.abs(gt - forecasts).mean()
    wape_v = 100.0 * (np.sum(np.abs(gt - forecasts)) / np.sum(gt))
    return round(float(mae_v), 3), round(float(wape_v), 3)


def mae(gt: torch.Tensor, pred: torch.Tensor, norm_scalar: float = 1.0) -> torch.Tensor:
    """Mean absolute error on rescaled values."""
    return torch.abs(gt * norm_scalar - pred * norm_scalar).mean()


def wape(gt: torch.Tensor, pred: torch.Tensor, norm_scalar: float = 1.0) -> torch.Tensor:
    """WAPE % = 100·Σ|gt−ŷ|/Σ|gt| on rescaled values."""
    num = torch.sum(torch.abs((gt - pred) * norm_scalar))
    den = torch.sum(torch.abs(gt * norm_scalar))
    return 100.0 * num / den


def eval_metrics(gt: torch.Tensor, pred: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 norm_scalar: float = 53.0) -> Dict[str, torch.Tensor]:
    """Masked partial sums ``abs_err``, ``abs_gt``, ``count`` (masked values,
    rows × horizon) and ``rows``, as 0-d tensors on ``gt``'s device; they
    add exactly across batches (``finalize_metrics`` turns them into
    metrics)."""
    gt = gt.reshape(gt.shape[0], -1)
    pred = pred.reshape(pred.shape[0], -1)
    if mask is None:
        mask = torch.ones(gt.shape[0], dtype=gt.dtype, device=gt.device)
    m = mask[:, None]
    abs_err = torch.sum(torch.abs(gt - pred) * m) * norm_scalar
    abs_gt = torch.sum(torch.abs(gt) * m) * norm_scalar
    count = torch.sum(mask) * gt.shape[1]
    return {"abs_err": abs_err, "abs_gt": abs_gt, "count": count, "rows": torch.sum(mask)}


def finalize_metrics(sums) -> Dict[str, float]:
    """Partial sums -> ``{'mae', 'wape'}``."""
    return {"mae": float(sums["abs_err"] / sums["count"]),
            "wape": float(100.0 * sums["abs_err"] / sums["abs_gt"])}
