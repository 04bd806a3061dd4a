"""Optimizer: Adafactor as the JAX package configures optax's, counterpart of
``visuelle2_tpu/train/optim.py``.

The JAX package chains ``clip_by_global_norm(grad_clip)`` (0.5 for the
transformer family) into ``optax.adafactor(decay_rate=0.8,
clipping_threshold=1.0, min_dim_size_to_factor=128,
multiply_by_parameter_scale=True, eps=1e-30)`` with fairseq's relative-step
schedule ``lr_t = min(1e-6·t, 1/√t)``, and masks it by ``multi_transform``
into the trainable leaves and ``set_to_zero``.  ``Adafactor`` here computes
the same update for each trainable parameter p with gradient g, at update
count c (0 for the first):

* the clip, over the trainable gradients together: g ← g when ‖g‖ < max,
  else (g / ‖g‖)·max (no +1e-6, unlike ``clip_grad_norm_``);
* β = 1 − (c+1)^−0.8; with s = g² + 1e-30, a factored second moment where
  the two largest dims are at least 128 (d0 the largest, d1 the other, ties
  as numpy's ``argsort`` orders them: optax's rule): r ← β·r + (1−β)·mean_d0(s), k ← β·k +
  (1−β)·mean_d1(s), u = g · (r / mean_d1(r))^−½ · k^−½; else v ← β·v +
  (1−β)·s, u = g · v^−½;
* u ← u / max(1, rms(u)); u ← u · lr(c); u ← u · max(rms(p), 1e-3);
  p ← p − u.

The factored update is symmetric in its two dims, so the port's weight
layouts (OIHW convolutions, [out, in] linears) factor the same two dims as
the JAX ones (HWIO, [in, out]) and give the same update up to rounding.
Parameters that do not require a gradient are left alone, as
``set_to_zero`` leaves the frozen leaves; a trainable parameter with no
gradient takes a zero one, as JAX's tree always has one.  The update count
is a Python int in the param group, so a step needs no host sync; the state
dict (``v_row``/``v_col`` or ``v`` per parameter, and the count) round-trips
through a checkpoint.

``FROZEN_BACKBONE_PREFIXES`` is the reference's freeze split on the port's
module names: under any image encoder's ``backbone``, ``conv1``, ``bn1``,
``layer1_*`` and ``layer2_*``.  ``freeze_backbone`` turns their
``requires_grad`` off, so their backward is never built (the JAX
``stop_frozen_gradients``); their BatchNorm statistics still move in train
mode.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np
import torch
from torch import nn

FROZEN_BACKBONE_PREFIXES = ("conv1", "bn1", "layer1_", "layer2_")
# optax.adafactor as the JAX package configures it.
DECAY_RATE = 0.8
CLIPPING_THRESHOLD = 1.0
EPSILON = 1e-30
MIN_PARAM_SCALE = 1e-3


def fairseq_relative_step_schedule(step) -> np.float32:
    """``min(1e-6·t, 1/√t)`` at t = step + 1, in float32."""
    t = np.float32(step) + np.float32(1.0)
    return np.minimum(np.float32(1e-6) * t, np.float32(1.0) / np.sqrt(t))


def current_lr(step: int, learning_rate: Optional[float] = None) -> float:
    """The learning rate of the latest update after ``step`` updates (the
    schedule at the pre-increment count ``step - 1``)."""
    t = float(max(1, int(step)))
    if learning_rate is None:
        return min(1e-6 * t, t ** -0.5)
    return float(learning_rate)


def is_frozen(name: str) -> bool:
    """Whether the parameter ``name`` (a ``named_parameters`` key) lies in a
    frozen backbone stage."""
    parts = name.split(".")
    for i, part in enumerate(parts[:-1]):
        if part == "backbone":
            return parts[i + 1].startswith(FROZEN_BACKBONE_PREFIXES)
    return False


def freeze_backbone(model: nn.Module) -> List[str]:
    """Turn off ``requires_grad`` on the frozen stages; returns their names."""
    frozen = [name for name, _ in model.named_parameters() if is_frozen(name)]
    params = dict(model.named_parameters())
    for name in frozen:
        params[name].requires_grad_(False)
    return frozen


def factored_dims(shape) -> Optional[tuple]:
    """(d1, d0): the second-largest and the largest dim, ties as numpy's
    default ``argsort`` orders them, when both are at least 128 (optax's
    ``_factored_dims``); else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < 128:
        return None
    return int(order[-2]), int(order[-1])


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: the gradients as they are when their
    joint norm is below ``max_norm``, else (g / norm)·max_norm; new tensors,
    and no host sync."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    below = norm < max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    # g / 1 · 1 = g below the clip, else (g / norm) · max_norm.
    out = torch._foreach_div(grads, torch.where(below, one, norm))
    torch._foreach_mul_(out, torch.where(below, one, one * max_norm))
    return out


def _f32(x) -> float:
    return float(np.float32(x))


class Adafactor(torch.optim.Optimizer):
    """optax's Adafactor as the JAX package configures it, with the global
    norm clip in front (see the module docstring).  ``lr`` None is the
    relative-step schedule, a float a fixed rate."""

    def __init__(self, params: Iterable, lr: Optional[float] = None,
                 grad_clip: Optional[float] = None):
        super().__init__(params, dict(lr=lr, grad_clip=grad_clip, count=0))

    def _lr(self, group) -> float:
        if group["lr"] is None:
            return float(fairseq_relative_step_schedule(group["count"]))
        return _f32(group["lr"])

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adafactor.step takes no closure")
        for group in self.param_groups:
            self._step_group(group)

    def _step_group(self, group):
        params = [p for p in group["params"] if p.requires_grad]
        if not params:
            return
        torch._foreach_sub_(params, self.compute_updates(group, params))
        group["count"] += 1

    def compute_updates(self, group, params) -> List[torch.Tensor]:
        """The amounts ``step`` subtracts from ``params`` (the group's
        trainable ones), moving the second-moment state."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        if group["grad_clip"] is not None:
            grads = clip_by_global_norm(grads, group["grad_clip"])
        t = np.float32(group["count"] + 1)
        beta = _f32(np.float32(1.0) - t ** np.float32(-DECAY_RATE))
        rest = _f32(np.float32(1.0) - np.float32(beta))

        updates = [None] * len(params)
        flat = [i for i, p in enumerate(params) if factored_dims(p.shape) is None]
        if flat:
            g = [grads[i] for i in flat]
            v = [self._state(params[i], "v", lambda p: torch.zeros_like(p)) for i in flat]
            sq = torch._foreach_mul(g, g)
            torch._foreach_add_(sq, EPSILON)
            torch._foreach_mul_(sq, rest)
            torch._foreach_mul_(v, beta)
            torch._foreach_add_(v, sq)
            u = torch._foreach_pow(v, -0.5)
            torch._foreach_mul_(u, g)
            for i, ui in zip(flat, u):
                updates[i] = ui
        for i, (p, g) in enumerate(zip(params, grads)):
            if updates[i] is not None:
                continue
            d1, d0 = factored_dims(p.shape)
            row = self._state(p, "v_row", lambda q: q.new_zeros(_drop(q.shape, d0)))
            col = self._state(p, "v_col", lambda q: q.new_zeros(_drop(q.shape, d1)))
            sq = g * g + EPSILON
            row.mul_(beta).add_(rest * sq.mean(dim=d0))
            col.mul_(beta).add_(rest * sq.mean(dim=d1))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (row / row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
            updates[i] = g * row_factor.unsqueeze(d0) * (col ** -0.5).unsqueeze(d1)

        # Clip each update by its RMS, then the rate and the parameter's RMS.
        rms_u = torch.stack([(u * u).mean() for u in updates]).sqrt()
        torch._foreach_div_(updates, list(torch.clamp_min(
            rms_u / CLIPPING_THRESHOLD, 1.0).unbind()))
        torch._foreach_mul_(updates, self._lr(group))
        rms_p = torch.stack([(p * p).mean() for p in params]).sqrt()
        scale = torch.where(rms_p <= MIN_PARAM_SCALE, torch.full_like(rms_p, MIN_PARAM_SCALE),
                            rms_p)
        torch._foreach_mul_(updates, list(scale.unbind()))
        return updates

    def _state(self, p, key, make):
        state = self.state[p]
        if key not in state:
            state[key] = make(p)
        return state[key]


def _drop(shape, dim):
    return tuple(n for i, n in enumerate(shape) if i != dim)


def make_optimizer(model: nn.Module, grad_clip: Optional[float] = None,
                   learning_rate: Optional[float] = None) -> Adafactor:
    """Adafactor over ``model``'s parameters with the backbone freeze split
    applied (the JAX ``make_optimizer``)."""
    freeze_backbone(model)
    return Adafactor(model.parameters(), lr=learning_rate, grad_clip=grad_clip)
