"""Reproducibility, counterpart of ``visuelle2_tpu/utils/seeding.py``
(``pl.seed_everything``)."""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int = 21) -> torch.Generator:
    """Seed ``random``, numpy and torch, and return a CPU ``torch.Generator``
    seeded with ``seed``: pass it to ``models.build`` to draw the weights
    (the JAX version returns a PRNG key)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
