"""Dropout for train mode, and the switches the train forward reads.

The JAX package draws every dropout mask from a ``dropout`` rng that the
trainer folds on the global step (``visuelle2_tpu/train/loop.py``), so a
resumed run draws the masks of the uninterrupted one.  A torch module takes
no rng argument; here the train forward runs inside ``use_generator(gen)``
and every mask is drawn from ``gen`` in the order the forward reaches the
dropouts (``Seq2SeqForecaster.forward(batch, generator=gen)`` enters it; the
trainer derives ``gen`` from ``(seed + 1000, step)``).  Without a generator
the masks come from torch's default one.

A kept element is scaled by ``1 / (1 - rate)``, a dropped one is 0, as flax's
``nn.Dropout`` computes it.  Masks cannot match across frameworks, so the
parity runs turn dropout off everywhere with ``disabled()`` (the JAX tests
neutralize flax's ``Dropout`` the same way).

``recomputing()`` marks the second forward of a block under
``torch.utils.checkpoint`` (``--remat``): train-mode BatchNorm leaves its
running statistics alone there, so each block updates them once a step, as
``nn.remat`` does in the JAX package.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
from torch import nn

_local = threading.local()


def _get(name, default):
    return getattr(_local, name, default)


@contextlib.contextmanager
def _set(name, value):
    previous = _get(name, None)
    setattr(_local, name, value)
    try:
        yield
    finally:
        setattr(_local, name, previous)


def use_generator(generator: Optional[torch.Generator]):
    """Draw the masks of the forwards inside this block from ``generator``."""
    return _set("generator", generator)


def disabled():
    """Dropout off everywhere inside this block (deterministic train mode)."""
    return _set("disabled", True)


def recomputing():
    """The forward inside this block is a checkpoint's recomputation."""
    return _set("recomputing", True)


def is_disabled() -> bool:
    return bool(_get("disabled", False))


def is_recomputing() -> bool:
    return bool(_get("recomputing", False))


def stochastic(module: nn.Module) -> bool:
    """Whether ``module``'s forward draws dropout masks: train mode with
    dropout on (the JAX modules' ``not deterministic``)."""
    return module.training and not is_disabled()


def dropout(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """``x`` with each element kept with probability ``1 - rate`` and scaled
    by ``1 / (1 - rate)``; the identity in eval mode, at rate 0 and under
    ``disabled()``."""
    if not training or rate == 0.0 or is_disabled():
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, dtype=torch.float32, device=x.device,
                      generator=_get("generator", None)) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """``dropout`` at a fixed rate, on in train mode; it holds no state."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        return dropout(x, self.rate, self.training)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
