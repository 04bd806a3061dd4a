"""The reference's precision: every product in float32 with TF32 off, and no
rounding where the model rounds to its working dtype."""

import torch

TF32 = False


def low(x: torch.Tensor) -> torch.Tensor:
    """A tensor at a point where the model rounds it to its working dtype."""
    return x
