"""FLOPs and peak memory of one eval batch, counterpart of
``visuelle2_tpu/eval/profiler.py``.

The JAX package reads both from XLA's compiled program (cost analysis and
buffer assignment).  Eager PyTorch has no compiled program, so here:

* FLOPs are what ``torch.utils.flop_counter.FlopCounterMode`` counts over
  one forward: matrix products, convolutions and attention, not elementwise
  work, and not the hand-written kernels called through ``ctypes`` (the
  gated fusion and attention kernels, a small share of a forward);
* peak memory is ``torch.cuda.max_memory_allocated`` over one forward, from
  a reset just before it: the weights, the batch and the activations the
  caching allocator held at once — tensors only, not the allocator's
  reserved-but-free blocks, cuDNN/cuBLAS workspaces outside it, or the
  CUDA context.  On the CPU it is ``None``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode


def batch_flops(model, batch) -> float:
    """FLOPs of one forward of ``model`` on ``batch`` (flop counter)."""
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        model(batch)
    return float(counter.get_total_flops())


def peak_memory_bytes(model, batch) -> Optional[int]:
    """Peak allocated device bytes over one forward (see the module
    docstring); ``None`` when ``batch`` is not on a CUDA device."""
    dev = next(iter(batch.values())).device
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        model(batch)
    torch.cuda.synchronize(dev)
    return int(torch.cuda.max_memory_allocated(dev))
