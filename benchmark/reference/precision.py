"""The precisions the reference runs in, one file each in ``precisions/``,
found by the name a configuration gives (``"precision": {"reference": ...,
"control": ...}``).  A precision file gives ``TF32`` (whether the products
of matrices and convolutions may run in TF32) and ``low(x)``, the rounding
at each point where the model rounds to its working dtype."""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch

from benchmark.core import load_file

HERE = Path(__file__).resolve().parent / "precisions"
_LOADED = {}


def load(name: str):
    """The precision file ``precisions/<name>.py``."""
    if name not in _LOADED:
        path = HERE / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no precision {name!r}: add {path}")
        _LOADED[name] = load_file(path, f"benchmark_precision_{name}")
    return _LOADED[name]


@contextlib.contextmanager
def backends(name: str):
    """TF32 on or off for the precision ``name`` while the block runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = bool(load(name).TF32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
