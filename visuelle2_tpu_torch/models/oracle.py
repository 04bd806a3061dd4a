"""Oracle: the statistical baselines over framed windows, counterpart of
``visuelle2_tpu/models/oracle.py`` (the reference's ``models/Oracle.py``),
computed by ``ops/stats.py``.

The reference decides teacher forcing with one numpy coin per batch
(``Oracle.py:17,27,46``) whose "probability" is the boolean flag itself, so
teacher forcing is fixed by the flag; the port keeps that.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from visuelle2_tpu_torch._device import resolve_device
from visuelle2_tpu_torch.ops.stats import holt_forecast, naive_forecast, ses_forecast

METHODS = {"naive": naive_forecast, "ses": ses_forecast, "holt": holt_forecast}


@dataclasses.dataclass(frozen=True)
class Oracle:
    """A parameter-free forecaster on ``device``: ``cuda`` unless the caller
    passes one (``_device.resolve_device``)."""

    method: str = "naive"  # naive | ses | holt
    use_teacher_forcing: bool = False
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"unknown method {self.method}")
        object.__setattr__(self, "device", resolve_device(self.device))

    def __call__(self, X) -> torch.Tensor:
        """X: framed windows [B, W, T] (a tensor or an array) -> float32
        forecasts on ``device``: [B, W, 1] teacher-forced; without teacher
        forcing [B, W, 1] for naive and [B, 1, W] for SES and Holt."""
        X = torch.as_tensor(X).to(self.device, torch.float32)
        return METHODS[self.method](X, bool(self.use_teacher_forcing))
