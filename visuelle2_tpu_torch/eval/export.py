"""Serving callable for a port model, counterpart of the header and
``forecast_fn`` contract of ``visuelle2_tpu/eval/export.py``.

``make_forecaster(model, example_batch)`` returns ``(fn, header)``: the
header has the JAX artifact header's shape (sorted ``keys``, ``shapes``,
``dtypes``), and ``fn`` takes a numpy batch dict of exactly those shapes and
dtypes, runs the model on its device under ``torch.inference_mode()`` and
returns numpy forecasts.  The artifact file format arrives with the serving
slice (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

from visuelle2_tpu_torch._device import resolve_device


def make_forecaster(model: nn.Module, example_batch: Dict[str, np.ndarray],
                    device=None
                    ) -> Tuple[Callable[[Dict[str, np.ndarray]], np.ndarray], dict]:
    """Serve ``model`` on ``device`` (``cuda`` unless given; see ``_device``)."""
    device = resolve_device(device)
    model.to(device).eval()
    keys = sorted(example_batch)
    header = {
        "keys": keys, "version": 1,
        "shapes": {k: list(np.shape(example_batch[k])) for k in keys},
        "dtypes": {k: str(np.asarray(example_batch[k]).dtype) for k in keys},
    }

    def forecast_fn(batch: Dict[str, np.ndarray]) -> np.ndarray:
        missing = set(keys) - set(batch)
        if missing:
            raise ValueError(f"batch missing keys: {sorted(missing)}")
        for k in keys:
            a = np.asarray(batch[k])
            if list(a.shape) != header["shapes"][k]:
                raise ValueError(f"batch['{k}'] shape {list(a.shape)} != exported "
                                 f"{header['shapes'][k]} — serving batches must "
                                 "match the export batch size")
            if a.dtype != np.dtype(header["dtypes"][k]):
                raise ValueError(f"batch['{k}'] dtype {a.dtype} != exported "
                                 f"{header['dtypes'][k]}")
        with torch.inference_mode():
            tensors = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
                       for k in keys}
            out, _aux = model(tensors)
            return out.float().cpu().numpy()

    return forecast_fn, header
