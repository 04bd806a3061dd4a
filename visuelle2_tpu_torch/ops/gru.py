"""GRU cell + sequence layer, counterpart of ``visuelle2_tpu/ops/gru.py``.

The parameters keep the JAX layout: ``w_i [I, 3H]``, ``w_h [H, 3H]``,
``b_i [3H]``, ``b_h [3H]``, gate order (r, z, n) — the order of
``torch.nn.GRU`` as well, transposed.  ``GRU`` runs the recurrence as a
plain step loop by default, as the JAX default is ``lax.scan``;
``use_kernel=True`` (the JAX ``use_pallas``) runs it through
``ops/cuda/gru_seq.py::fused_gru_sequence``.  No model turns it on, because
no JAX model does.  ``GRUCellModule`` is one step with the same parameters,
for the decoders whose step loop lives in the model.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def gru_cell_step(x, h, w_i, w_h, b_i, b_h):
    """One GRU step. x: [B, I], h: [B, H] -> new h [B, H].

    r = σ(Wx_r + bx_r + Wh_r h + bh_r), z likewise,
    n = tanh(Wx_n + bx_n + r·(Wh_n h + bh_n)), h' = (1−z)·n + z·h.
    """
    gi = x @ w_i + b_i
    gh = h @ w_h + b_h
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def gru_sequence(x, w_i, w_h, b_i, b_h, h0: Optional[torch.Tensor] = None):
    """The step loop: x [B, T, I] -> (outputs [B, T, H], h_T [B, H])."""
    h = x.new_zeros(x.shape[0], w_h.shape[0]) if h0 is None else h0
    ys = []
    for t in range(x.shape[1]):
        h = gru_cell_step(x[:, t], h, w_i, w_h, b_i, b_h)
        ys.append(h)
    return torch.stack(ys, dim=1), h


class GRUParams(nn.Module):
    """``w_i [I, 3H]``, ``w_h [H, 3H]``, ``b_i``, ``b_h [3H]`` in the JAX
    layout, drawn U(±1/√H) by ``registry.init_parameters``."""

    def __init__(self, input_dim: int, hidden_dim: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        H3 = 3 * hidden_dim
        self.w_i = nn.Parameter(torch.empty(input_dim, H3))
        self.w_h = nn.Parameter(torch.empty(hidden_dim, H3))
        self.b_i = nn.Parameter(torch.empty(H3))
        self.b_h = nn.Parameter(torch.empty(H3))


class GRU(GRUParams):
    """Single-layer batch-first GRU: [B, T, I] -> (outputs [B, T, H], h_T [B, H])."""

    def __init__(self, input_dim: int, hidden_dim: int, use_kernel: bool = False):
        super().__init__(input_dim, hidden_dim)
        self.use_kernel = use_kernel

    def forward(self, x, h0: Optional[torch.Tensor] = None):
        if self.use_kernel:
            # Imported here: gru_seq takes this module's step loop as its plain version.
            from visuelle2_tpu_torch.ops.cuda.gru_seq import fused_gru_sequence

            # The kernel takes contiguous inputs; the trend encoder hands over
            # a transposed view.
            return fused_gru_sequence(x.contiguous(), self.w_i, self.w_h, self.b_i,
                                      self.b_h, h0)
        return gru_sequence(x, self.w_i, self.w_h, self.b_i, self.b_h, h0)


class GRUCellModule(GRUParams):
    """One GRU step, x [B, I], h [B, H] -> new h [B, H]."""

    def forward(self, x, h):
        return gru_cell_step(x, h, self.w_i, self.w_h, self.b_i, self.b_h)
