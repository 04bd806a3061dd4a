"""Where the port's entry points put a model.

The port runs on the card.  ``build(...)`` and ``make_forecaster(...)`` take
an explicit ``device``; with none given they use ``cuda`` and raise when no
CUDA device exists — they never quietly run on the CPU.  Tests pass
``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' to "
            "run it on the CPU explicitly")
    return torch.device("cuda")
