"""Weights drawn on the device from the seed, in the port's parameter layout.

The benchmark draws them itself, hands the same values to the port (copied
into its parameters and buffers) and to the reference, and draws them again
after the window to give the reference a copy the port never touched.  One
normal draw of every element at once, on the device, then each tensor its
slice scaled by its rule: the first rule of the configuration's ``init``
list whose ``match`` (a regular expression) finds the name, else the
defaults below.  A rule gives ``mean`` and ``std``.

Defaults, by the name's last part and the tensor's shape:

* ``running_mean``: N(0, 0.1²); ``running_var``: 0.75 + 0.25·tanh(N)
  (between 0.5 and 1);
* a 1-D ``weight`` (a norm's gain): N(1, 0.1²); a 1-D ``bias``, ``b_i``,
  ``b_h``: N(0, 0.1²);
* a 4-D ``weight`` (a convolution, [out, in, kh, kw]): N(0, 2 / fan_in),
  fan_in = in·kh·kw (He's rule for a ReLU network);
* a 2-D ``weight`` ([out, in], a linear): N(0, 1 / in); ``kernel``, ``w_i``,
  ``w_h`` ([in, out]): N(0, 1 / in).

The serving cells then set the backbone's BatchNorm running statistics
from a batch of photos (``drivers/serve.py::serving_weights``).
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np
import torch


def sub_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed for one purpose (weights 0, data 1, traffic 2) of the
    run's ``--seed``."""
    return int(np.random.SeedSequence([int(seed), purpose]).generate_state(1, np.uint64)[0]) >> 1


def _default_rule(name: str, shape) -> tuple:
    last = name.rsplit(".", 1)[-1]
    if last == "running_mean":
        return "normal", 0.0, 0.1
    if last == "running_var":
        return "var", 0.75, 0.25
    if len(shape) == 1:
        return ("normal", 1.0, 0.1) if last == "weight" else ("normal", 0.0, 0.1)
    if len(shape) == 4:
        fan_in = int(np.prod(shape[1:]))
        return "normal", 0.0, float(np.sqrt(2.0 / fan_in))
    if last == "weight":
        return "normal", 0.0, float(np.sqrt(1.0 / shape[1]))
    return "normal", 0.0, float(np.sqrt(1.0 / shape[0]))


def rule_for(name: str, shape, rules: List[dict]) -> tuple:
    for r in rules:
        if re.search(r["match"], name):
            return "normal", float(r["mean"]), float(r["std"])
    return _default_rule(name, shape)


def draw(layout: Dict[str, tuple], seed: int, rules: List[dict], device) -> Dict[str, torch.Tensor]:
    """``{name: float32 tensor}`` for each ``name: shape`` of ``layout``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    sizes = [int(np.prod(s)) for s in layout.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out = {}
    for (name, shape), part in zip(layout.items(), flat.split(sizes)):
        kind, mean, std = rule_for(name, shape, rules)
        t = part.reshape(shape)
        out[name] = (mean + std * torch.tanh(t)) if kind == "var" else (mean + std * t)
    return out


def layout_of(model: torch.nn.Module) -> Dict[str, tuple]:
    """The float tensors of ``model``'s state dict by name and shape."""
    return {k: tuple(v.shape) for k, v in model.state_dict().items()
            if v.dtype == torch.float32}


@torch.no_grad()
def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the model's own parameters and buffers."""
    state = model.state_dict(keep_vars=True)
    missing = set(layout_of(model)) - set(weights)
    if missing:
        raise KeyError(f"no weights drawn for {sorted(missing)[:5]}")
    for name, value in weights.items():
        state[name].data.copy_(value)
