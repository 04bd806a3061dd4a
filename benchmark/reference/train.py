"""The reference's training steps: the model's masked MSE, its gradients by
autograd in float32, the global-norm clip and Adafactor, written from the
rule the configuration states (optax's ``adafactor`` as the JAX package
configures it, behind ``clip_by_global_norm``), not from the port's code:

* the clip, over the trainable gradients together: g stays when ‖g‖ is
  below the clip, else becomes (g / ‖g‖)·clip;
* at update count c (0 first; a run resumed at update c0 starts there):
  β = 1 − (c+1)^−0.8 in float32, s = g² + 1e-30; where
  the two largest dims are both at least 128 (d0 the largest, d1 the
  other, ties in numpy's ``argsort`` order) the second moment is factored,
  r ← β·r + (1−β)·mean_d0(s), k ← β·k + (1−β)·mean_d1(s),
  u = g · (r / mean_d1(r))^−½ · k^−½; else v ← β·v + (1−β)·s, u = g·v^−½;
* u ← u / max(1, rms(u)); u ← u·lr(c), lr(c) = min(1e-6·t, 1/√t) at
  t = c + 1; u ← u·max(rms(p), 1e-3); p ← p − u.

Only the trainable leaves move: the backbone's stem, ``layer1`` and
``layer2`` are frozen (the reference CrossAttnRNN's "last two blocks
finetuned"), every other parameter trains.  Each step's dropout masks come
from a generator seeded with ``SeedSequence([seed + 1000, step])`` (the
configuration's mask stream, ``model.Runtime``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference.model import Runtime, forward, masked_mse

FROZEN_BACKBONE = ("conv1", "bn1", "layer1_", "layer2_")
DROPOUT_SEED_OFFSET = 1000
DECAY_RATE = 0.8
EPS = 1e-30
MIN_PARAM_SCALE = 1e-3


def is_trainable(name: str) -> bool:
    """Whether the parameter ``name`` trains under the freeze split."""
    parts = name.split(".")
    for i, part in enumerate(parts[:-1]):
        if part == "backbone":
            return not parts[i + 1].startswith(FROZEN_BACKBONE)
    return True


def step_generator(seed: int, step: int, device) -> torch.Generator:
    words = [seed + DROPOUT_SEED_OFFSET, step]
    value = int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1
    return torch.Generator(device=device).manual_seed(value)


def decay(count: int) -> tuple:
    """(β, 1 − β) at update count ``count``, in float32 as the rule states."""
    beta = np.float32(1.0) - np.float32(count + 1) ** np.float32(-DECAY_RATE)
    return float(beta), float(np.float32(1.0) - np.float32(beta))


def learning_rate(count: int) -> float:
    t = np.float32(count) + np.float32(1.0)
    return float(np.minimum(np.float32(1e-6) * t, np.float32(1.0) / np.sqrt(t)))


def factored_dims(shape) -> Optional[tuple]:
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < 128:
        return None
    return int(order[-2]), int(order[-1])


def clip(grads: List[torch.Tensor], max_norm: Optional[float]) -> List[torch.Tensor]:
    if max_norm is None:
        return grads
    norm = torch.sqrt(sum(g.double().pow(2).sum() for g in grads)).float()
    if norm < max_norm:
        return grads
    return [g / norm * max_norm for g in grads]


def adafactor(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
              state: dict, count: int) -> None:
    """One update of ``params`` (in place) from ``grads`` (already clipped)."""
    beta, rest = decay(count)
    lr = learning_rate(count)
    for name, p in params.items():
        g = grads[name]
        s = g * g + EPS
        dims = factored_dims(tuple(p.shape))
        st = state.setdefault(name, {})
        if dims is None:
            st["v"] = beta * st.get("v", torch.zeros_like(p)) + rest * s
            u = g * st["v"] ** -0.5
        else:
            d1, d0 = dims
            row = s.mean(dim=d0)
            col = s.mean(dim=d1)
            st["r"] = beta * st.get("r", torch.zeros_like(row)) + rest * row
            st["k"] = beta * st.get("k", torch.zeros_like(col)) + rest * col
            r_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (st["r"] / st["r"].mean(dim=r_d1, keepdim=True)) ** -0.5
            u = g * row_factor.unsqueeze(d0) * (st["k"] ** -0.5).unsqueeze(d1)
        u = u / torch.clamp_min(torch.sqrt((u * u).mean()), 1.0)
        u = u * lr
        u = u * torch.clamp_min(torch.sqrt((p * p).mean()), MIN_PARAM_SCALE)
        p.sub_(u)


def train_steps(weights: Dict[str, torch.Tensor], batches: List[dict], model: dict,
                grad_clip: Optional[float], seed: int, precision: str = "f32",
                count0: int = 0) -> dict:
    """Follow ``len(batches)`` training steps from ``weights`` (left
    untouched) and Adafactor's empty moments at update count ``count0``.
    Returns each step's loss, the first step's gradient norm per trainable
    leaf as Adafactor receives it (after the clip), and the trainable
    parameters after the last step."""
    P = {k: v.detach().clone() for k, v in weights.items()}
    names = [k for k in P if is_trainable(k) and not k.endswith(("running_mean",
                                                                  "running_var"))]
    for n in names:
        P[n].requires_grad_(True)
    state, losses, first_grads = {}, [], None
    for step, batch in enumerate(batches):
        rt = Runtime(train=True, generator=step_generator(seed, step, batch["ts"].device),
                     precision=precision)
        forecast = forward(P, batch, model, rt)
        loss = masked_mse(batch["ts"], forecast.reshape(batch["ts"].shape), batch["mask"])
        grads = torch.autograd.grad(loss, [P[n] for n in names], allow_unused=True)
        grads = [torch.zeros_like(P[n]) if g is None else g for n, g in zip(names, grads)]
        with torch.no_grad():
            grads = clip(grads, grad_clip)
            if first_grads is None:
                first_grads = {n: float(torch.linalg.vector_norm(g)) for n, g in zip(names, grads)}
            adafactor({n: P[n] for n in names}, dict(zip(names, grads)), state, count0 + step)
        losses.append(float(loss.detach()))
        del forecast, loss, grads
    return {"losses": losses, "grad_norms": first_grads,
            "params": {n: P[n].detach() for n in names}}
