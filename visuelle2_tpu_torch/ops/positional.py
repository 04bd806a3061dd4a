"""Sinusoidal positional encoding, counterpart of
``visuelle2_tpu/ops/positional.py``."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from visuelle2_tpu_torch.ops.dropout import Dropout


def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    pe = np.zeros((max_len, d_model), np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div[: pe[:, 1::2].shape[1]])
    return pe


class PositionalEncoding(nn.Module):
    """x [B, L, D] -> dropout(x + pe[:L]), at the JAX module's rate 0.1."""

    def __init__(self, d_model: int, max_len: int = 52):
        super().__init__()
        # Not a parameter and not in the state dict: the JAX module has no
        # variable for it either.
        self.register_buffer("pe", torch.from_numpy(sinusoidal_table(max_len, d_model)),
                             persistent=False)
        self.dropout = Dropout(0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(x + self.pe[None, : x.shape[1], :])
