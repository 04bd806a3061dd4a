"""Common model plumbing: batch contract, window flatten/repeat helpers.

Counterpart of ``visuelle2_tpu/models/base.py``.  Models return
``(forecast, aux)`` from ``model(batch)``; the batch dict holds torch tensors
on the model's device:

* stfore: ``X [B, W, 2]``, ``y [B, W, H]``
* demand: ``ts [B, 12]``
* both:   ``cat/col/fab/store [B]``, ``temporal [B, 4]``,
          ``gtrends [B, 3, 52]``, ``images uint8 [B, H, W, 3]``, ``mask [B]``
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class VocabSizes:
    """Embedding table sizes: len(dict)+1 / store_num+1."""

    num_cat: int
    num_col: int
    num_fab: int
    num_store: int = 126

    @classmethod
    def from_dicts(cls, cat_dict, col_dict, fab_dict, store_num: int = 125):
        return cls(len(cat_dict) + 1, len(col_dict) + 1, len(fab_dict) + 1,
                   store_num + 1)


def flatten_windows(X: torch.Tensor):
    """[B, W, T] -> ([B·W, T, 1], B, W); [B, T] -> ([B, T, 1], B, 1)."""
    if X.dim() == 3:
        B, W, T = X.shape
        return X.reshape(B * W, T, 1), B, W
    B, T = X.shape
    return X.reshape(B, T, 1), B, 1


def repeat_windows(enc: torch.Tensor, num_windows: int) -> torch.Tensor:
    """Item-major repeat matching the window flatten order."""
    if num_windows == 1:
        return enc
    return torch.repeat_interleave(enc, num_windows, dim=0)
