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

Tensor parallel (``shards``: a sharded parameter -> its
``parallel/sharding.py::ShardSpec``): a parameter is this rank's column
block of a whole one, and every decision and reduction is the whole
parameter's.  ``factored_dims`` reads the whole shape; the means over a
sharded dim (``mean_d0``, ``mean_d1``, the row factor's mean), the sums of
squares of ``rms(u)`` and ``rms(p)`` and the clip's norm (sharded
gradients summed over the model group, replicated ones counted once) are
sums over the model group, four all-reduces a step; ``v``, ``v_row`` and
``v_col`` are sharded where they keep the sharded dim, else replicated
(``state_shard_dim``).  ``plain_state_dict`` gathers the state into the
whole parameters' layout (every rank of the model group calls it) and
``load_plain_state_dict`` cuts this rank's block back out, so a checkpoint
is the unsharded optimizer's whatever the mesh.

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


def global_norm(grads: List[torch.Tensor], sharded: Optional[List[bool]] = None,
                group=None) -> torch.Tensor:
    """The gradients' joint L2 norm, a 0-d tensor on their device.  The
    per-tensor norms are joined in float64, so the float32 result does not
    depend on their order or on zero gradients among them (a frozen leaf
    that JAX hands a zero gradient and the port none).  ``sharded[i]``: the
    i-th gradient is a block of a whole one, whose squares are summed over
    the model ``group``."""
    norms = torch.stack(torch._foreach_norm(grads))
    if not sharded or not any(sharded):
        return torch.linalg.vector_norm(norms.double()).to(norms.dtype)
    import torch.distributed as dist

    squares = (norms.double() ** 2).unbind()
    part = torch.stack([q for q, s in zip(squares, sharded) if s]).sum().reshape(1)
    dist.all_reduce(part, group=group)
    rest = [q for q, s in zip(squares, sharded) if not s]
    whole = part[0] + torch.stack(rest).sum() if rest else part[0]
    return whole.sqrt().to(norms.dtype)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        sharded: Optional[List[bool]] = None,
                        group=None) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: the gradients as they are when their
    ``global_norm`` is below ``max_norm``, else (g / norm)·max_norm; new
    tensors, and no host sync."""
    norm = global_norm(grads, sharded, group)
    below = norm < max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    # g / 1 · 1 = g below the clip, else (g / norm) · max_norm.
    out = torch._foreach_div(grads, torch.where(below, one, norm))
    torch._foreach_mul_(out, torch.where(below, one, one * max_norm))
    return out


def _f32(x) -> float:
    return float(np.float32(x))


def state_shard_dim(key: str, global_shape, dim: int) -> Optional[int]:
    """The dim along which the state ``key`` ("v", "v_row" or "v_col") of a
    parameter of ``global_shape`` sharded along ``dim`` is sharded; None
    where the state drops that dim (replicated)."""
    if key == "v":
        return dim
    d1, d0 = factored_dims(global_shape)
    dropped = d0 if key == "v_row" else d1
    if dim == dropped:
        return None
    return dim if dim < dropped else dim - 1


class _ModelSums:
    """Sums over the model group, queued and then all-reduced together."""

    def __init__(self, group):
        self.group = group
        self.parts = []

    def add(self, t: torch.Tensor) -> int:
        self.parts.append(t)
        return len(self.parts) - 1

    def reduce(self) -> List[torch.Tensor]:
        import torch.distributed as dist

        parts, self.parts = self.parts, []
        if not parts:
            return []
        flat = torch.cat([t.reshape(-1) for t in parts])
        dist.all_reduce(flat, group=self.group)
        return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in parts]), parts)]


class Adafactor(torch.optim.Optimizer):
    """optax's Adafactor as the JAX package configures it, with the global
    norm clip in front (see the module docstring).  ``lr`` None is the
    relative-step schedule, a float a fixed rate.  ``shards``: the
    parameters that are blocks of whole ones, each with its
    ``ShardSpec`` (tensor parallel; the specs share one model group)."""

    def __init__(self, params: Iterable, lr: Optional[float] = None,
                 grad_clip: Optional[float] = None, shards: Optional[dict] = None):
        super().__init__(params, dict(lr=lr, grad_clip=grad_clip, count=0))
        self.shards = dict(shards or {})
        self.model_group = next(iter(self.shards.values())).group if self.shards else None

    def _global_shape(self, p) -> tuple:
        spec = self.shards.get(p)
        return tuple(p.shape) if spec is None else spec.global_shape

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
        dims = [None if p not in self.shards else self.shards[p].dim for p in params]
        sharded = [d is not None for d in dims]
        sums = _ModelSums(self.model_group)
        if group["grad_clip"] is not None:
            grads = clip_by_global_norm(grads, group["grad_clip"], sharded, self.model_group)
        t = np.float32(group["count"] + 1)
        beta = _f32(np.float32(1.0) - t ** np.float32(-DECAY_RATE))
        rest = _f32(np.float32(1.0) - np.float32(beta))
        shapes = [self._global_shape(p) for p in params]

        updates = [None] * len(params)
        flat = [i for i, shape in enumerate(shapes) if factored_dims(shape) is None]
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

        def mean(x, dim, i, keepdim=False, param_dim=None):
            """x's mean over its ``dim``, which is the parameter's
            ``param_dim`` (``dim`` by default); over the model group
            (queued: an index into ``sums``) where that is the sharded one."""
            param_dim = dim if param_dim is None else param_dim
            if dims[i] is None or param_dim != dims[i]:
                return x.mean(dim=dim, keepdim=keepdim)
            return sums.add(x.sum(dim=dim, keepdim=keepdim) / shapes[i][param_dim])

        def reduced(values):
            out = sums.reduce()
            return [out[v] if isinstance(v, int) else v for v in values]

        factored = [i for i in range(len(params)) if updates[i] is None]
        moments = []
        for i in factored:
            d1, d0 = factored_dims(shapes[i])
            sq = grads[i] * grads[i] + EPSILON
            moments += [mean(sq, d0, i), mean(sq, d1, i)]
        moments = reduced(moments)
        rows = []
        for k, i in enumerate(factored):
            p = params[i]
            d1, d0 = factored_dims(shapes[i])
            row = self._state(p, "v_row", lambda q: q.new_zeros(_drop(q.shape, d0)))
            col = self._state(p, "v_col", lambda q: q.new_zeros(_drop(q.shape, d1)))
            row.mul_(beta).add_(rest * moments[2 * k])
            col.mul_(beta).add_(rest * moments[2 * k + 1])
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            # The row's dims are the parameter's without d0.
            rows.append(mean(row, reduced_d1, i, keepdim=True, param_dim=d1))
        rows = reduced(rows)
        for k, i in enumerate(factored):
            d1, d0 = factored_dims(shapes[i])
            state = self.state[params[i]]
            row_factor = (state["v_row"] / rows[k]) ** -0.5
            updates[i] = grads[i] * row_factor.unsqueeze(d0) * (
                state["v_col"] ** -0.5).unsqueeze(d1)

        # Clip each update by its RMS, then the rate and the parameter's RMS.
        rms_u = torch.stack(reduced([sums.add((u * u).sum() / _numel(shapes[i]))
                                     if sharded[i] else (u * u).mean()
                                     for i, u in enumerate(updates)])).sqrt()
        torch._foreach_div_(updates, list(torch.clamp_min(
            rms_u / CLIPPING_THRESHOLD, 1.0).unbind()))
        torch._foreach_mul_(updates, self._lr(group))
        rms_p = torch.stack(reduced([sums.add((p * p).sum() / _numel(shapes[i]))
                                     if sharded[i] else (p * p).mean()
                                     for i, p in enumerate(params)])).sqrt()
        scale = torch.where(rms_p <= MIN_PARAM_SCALE, torch.full_like(rms_p, MIN_PARAM_SCALE),
                            rms_p)
        torch._foreach_mul_(updates, list(scale.unbind()))
        return updates

    def plain_state_dict(self) -> dict:
        """``state_dict`` in the whole parameters' layout: the sharded
        states gathered over the model group (a collective: every rank of
        it calls this)."""
        from visuelle2_tpu_torch.parallel.collectives import gather_model_shards

        sd = self.state_dict()
        if not self.shards:
            return sd
        # state_dict's per-parameter dicts are the live ones: copy them.
        sd["state"] = {i: dict(st) for i, st in sd["state"].items()}
        with torch.no_grad():
            for idx, p in enumerate(self._ordered_params()):
                spec = self.shards.get(p)
                if spec is None or idx not in sd["state"]:
                    continue
                for key, value in list(sd["state"][idx].items()):
                    dim = state_shard_dim(key, spec.global_shape, spec.dim)
                    if dim is not None:
                        sd["state"][idx][key] = gather_model_shards(
                            value, dim, spec.rank, spec.world, spec.group)
        return sd

    def load_plain_state_dict(self, sd: dict) -> None:
        """``load_state_dict`` of a state in the whole parameters' layout
        (``plain_state_dict``'s, or an unsharded optimizer's): this rank's
        block of each sharded state."""
        if self.shards:
            sd = {"state": {k: dict(v) for k, v in sd["state"].items()},
                  "param_groups": sd["param_groups"]}
            for idx, p in enumerate(self._ordered_params()):
                spec = self.shards.get(p)
                if spec is None or idx not in sd["state"]:
                    continue
                for key, value in sd["state"][idx].items():
                    dim = state_shard_dim(key, spec.global_shape, spec.dim)
                    if dim is not None:
                        n = value.shape[dim] // spec.world
                        sd["state"][idx][key] = value.narrow(dim, spec.rank * n, n).clone()
        self.load_state_dict(sd)

    def _ordered_params(self):
        """The parameters in ``state_dict``'s index order."""
        return [p for g in self.param_groups for p in g["params"]]

    def _state(self, p, key, make):
        state = self.state[p]
        if key not in state:
            state[key] = make(p)
        return state[key]


def _drop(shape, dim):
    return tuple(n for i, n in enumerate(shape) if i != dim)


def _numel(shape) -> int:
    return int(np.prod(shape))


def make_optimizer(model: nn.Module, grad_clip: Optional[float] = None,
                   learning_rate: Optional[float] = None, params=None,
                   shards: Optional[dict] = None) -> Adafactor:
    """Adafactor over ``model``'s parameters (``params``, in that order,
    when given) with the backbone freeze split applied (the JAX
    ``make_optimizer``); ``shards`` as ``Adafactor`` takes them."""
    freeze_backbone(model)
    return Adafactor(model.parameters() if params is None else params, lr=learning_rate,
                     grad_clip=grad_clip, shards=shards)
