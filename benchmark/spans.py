"""The program's own spans and counters, read from the process
(``visuelle2_tpu_torch/utils/tracing.py``: records ``(name, span_id,
parent_id, thread_id, t0_ns, t1_ns, tags)`` on ``time.perf_counter_ns``),
for the per-layer metrics of source ``program_span`` and
``program_counter``.

A reader takes every record the recorder holds: set-up's warm calls and
both profiled stretches with the window.  Only the stretch that records
the host (about a tenth of the window) is slowed, so the median holds
against it.  Under ``MIN_RECORDS`` records, or in a program without the
recorder, a reader finds nothing (None).  Nothing here resets the
recorder.
"""

from __future__ import annotations

import collections
import statistics
from typing import Optional

MIN_RECORDS = 10


def recorder():
    """The program's recorder module, or None where it has none."""
    try:
        from visuelle2_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing if hasattr(tracing, "records") and hasattr(tracing, "counters") else None


def records(name: str) -> list:
    rec = recorder()
    return rec.records(name) if rec is not None else []


def counters() -> dict:
    rec = recorder()
    return rec.counters() if rec is not None else {}


def _median_ms(values: list) -> Optional[float]:
    return 1e-6 * statistics.median(values) if len(values) >= MIN_RECORDS else None


def median_ms(name: str) -> Optional[float]:
    """The median length of the spans ``name``, in ms."""
    return _median_ms([r[5] - r[4] for r in records(name)])


def median_per_parent_ms(name: str) -> Optional[float]:
    """The spans ``name`` summed by the span they were opened in (a
    forward's decode steps), the median of the sums, in ms."""
    sums = collections.Counter()
    for r in records(name):
        sums[r[2]] += r[5] - r[4]
    return _median_ms(list(sums.values()))


def median_gap_ms(name: str) -> Optional[float]:
    """The median time from the end of one span ``name`` to the start of the
    next on the same thread, in ms."""
    by_thread = collections.defaultdict(list)
    for r in records(name):
        by_thread[r[3]].append((r[4], r[5]))
    gaps = []
    for spans in by_thread.values():
        spans.sort()
        gaps += [b[0] - a[1] for a, b in zip(spans, spans[1:])]
    return _median_ms(gaps)


def share(part: str, rest: str, calls: str) -> Optional[float]:
    """Counter ``part`` over ``part`` + ``rest``, in %, once the spans
    ``calls`` number ``MIN_RECORDS``."""
    c = counters()
    total = c.get(part, 0) + c.get(rest, 0)
    if len(records(calls)) < MIN_RECORDS or not total:
        return None
    return 100.0 * c.get(part, 0) / total
