"""Device traces, counterpart of ``visuelle2_tpu/utils/tracing.py``
(``jax.profiler`` there, ``torch.profiler`` here).

``trace(log_dir)`` records the host and, where a CUDA device exists, the
card, and writes one Chrome trace (``trace_<pid>_<n>.json``, viewable in
Perfetto or ``chrome://tracing``) into ``log_dir`` when the block ends.
``annotate(name)`` names a region inside a trace.
"""

from __future__ import annotations

import contextlib
import itertools
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_counter = itertools.count()


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block into ``log_dir``; yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{next(_counter)}.json"))


def annotate(name: str):
    """A named region inside a trace."""
    return record_function(name)
