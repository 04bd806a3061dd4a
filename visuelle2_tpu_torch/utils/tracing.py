"""The port's spans and counters, and device traces (``torch.profiler``;
``jax.profiler`` in ``visuelle2_tpu/utils/tracing.py``).

``span(name)`` times a block on the host: one record
``(name, span_id, parent_id, thread_id, t0_ns, t1_ns, tags)`` when it
ends, on the clock ``time.perf_counter_ns``; ``parent_id`` is the span open
on the same thread when it began (0: none).  ``add(name, t0, t1, **tags)``
records a span begun on one thread and ended on another (a request's
wait), with no parent.  ``count(name, n)`` adds to a
process-wide counter.  Records sit in memory in a ring of ``CAPACITY``
(``overwritten`` counts those it dropped); ``records(name)``,
``counters()`` and ``reset()`` read and clear them.  Recording is on by
default, so a running server holds its last minutes; ``enable(False)``
turns every span into one shared no-op.

A span is a host record and nothing else: no ``torch.profiler`` range, no
CUDA call (event, synchronise, copy), no tensor read.  A profiled run
therefore sees the same device operations with recording on or off.

``trace(log_dir)`` records the host and, where a CUDA device exists, the
card, and writes one Chrome trace (``trace_<pid>_<n>.json``, viewable in
Perfetto or ``chrome://tracing``) into ``log_dir`` when the block ends,
with the port's spans of the block on a row of their own, placed on the
profiler's clock by ``to_epoch_ns``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from time import perf_counter_ns
from typing import Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile

CAPACITY = 2 ** 17  # spans held: minutes of serving at a few hundred a second
SPANS_PID = "visuelle2_tpu_torch spans"  # the exported spans' process row


class _Stack(threading.local):
    def __init__(self):
        self.ids = [0]
        self.thread = threading.get_ident()


class Recorder:
    """Spans and counters of one process (see the module docstring)."""

    def __init__(self, capacity: int = CAPACITY):
        self.enabled = True
        self._ring = collections.deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._stack = _Stack()
        self.reset()

    def reset(self) -> None:
        """Drop every record and counter and take a new clock anchor."""
        self._ring.clear()
        self._counters = collections.Counter()
        self.overwritten = 0
        p0 = time.perf_counter_ns()
        epoch = time.time_ns()
        # The host clock's reading at one instant of the Unix epoch clock.
        self.anchor = (epoch, (p0 + time.perf_counter_ns()) // 2)

    def span(self, name: str, span_id: Optional[int] = None):
        """``with span("batcher.pack"): ...``: a block timed as ``name``;
        ``span_id`` a number taken earlier from ``new_id`` (that a record
        made elsewhere names)."""
        if not self.enabled:
            return _NOOP
        return _Span(self, name, span_id)

    def new_id(self) -> int:
        return next(self._ids)

    def now(self) -> int:
        return perf_counter_ns()

    def add(self, name: str, t0_ns: int, t1_ns: int, **tags) -> None:
        """A finished span from two readings of ``now`` (a request's wait,
        begun on one thread and ended on another), with no parent."""
        if self.enabled:
            self._append((name, next(self._ids), 0, self._stack.thread, t0_ns, t1_ns,
                          tags or None))

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to a counter (bumped from one thread at a time)."""
        if self.enabled:
            self._counters[name] += n

    def _append(self, rec: tuple) -> None:
        ring = self._ring
        if len(ring) == ring.maxlen:
            self.overwritten += 1
        ring.append(rec)  # one append under the GIL: no lock

    def records(self, name: Optional[str] = None) -> List[tuple]:
        while True:
            try:
                recs = list(self._ring)
                break
            except RuntimeError:  # another thread appended while it was copied
                continue
        return recs if name is None else [r for r in recs if r[0] == name]

    def counters(self) -> Dict[str, int]:
        return dict(self._counters)

    def to_epoch_ns(self, t_ns: int) -> int:
        """A ``perf_counter_ns`` reading on the Unix epoch clock, the clock of
        ``torch.profiler``'s events."""
        epoch, perf = self.anchor
        return t_ns - perf + epoch


class _Span:
    __slots__ = ("rec", "name", "id", "t0", "st")

    def __init__(self, rec: Recorder, name: str, span_id: Optional[int]):
        self.rec, self.name, self.id = rec, name, span_id

    def __enter__(self):
        rec = self.rec
        st = self.st = rec._stack
        if self.id is None:
            self.id = next(rec._ids)
        st.ids.append(self.id)
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = perf_counter_ns()
        st, rec = self.st, self.rec
        ids = st.ids
        ids.pop()
        rec._append((self.name, self.id, ids[-1], st.thread, self.t0, t1, None))
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoSpan()
# The process's recorder, whose methods the port calls by these names.
RECORDER = Recorder()
span, new_id, now, add, count = (RECORDER.span, RECORDER.new_id, RECORDER.now, RECORDER.add,
                                 RECORDER.count)
records, counters, reset, to_epoch_ns = (RECORDER.records, RECORDER.counters, RECORDER.reset,
                                         RECORDER.to_epoch_ns)


def enable(on: bool = True) -> None:
    RECORDER.enabled = bool(on)


_counter = itertools.count()


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block into ``log_dir``; yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    start = time.perf_counter_ns()
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{next(_counter)}.json")
    prof.export_chrome_trace(path)
    _add_spans(path, [r for r in records() if r[4] >= start])


def _add_spans(path: str, recs: List[tuple]) -> None:
    """Write ``recs`` into the Chrome trace at ``path`` as complete events
    (``"ph": "X"``) on the process row ``SPANS_PID``, one row a thread,
    at ``ts`` µs after the file's ``baseTimeNanoseconds``."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": SPANS_PID,
                   "args": {"name": SPANS_PID}})
    for name, sid, parent, tid, t0, t1, tags in recs:
        events.append({"ph": "X", "cat": "port_span", "name": name, "pid": SPANS_PID,
                       "tid": tid, "ts": (to_epoch_ns(t0) - base) / 1e3,
                       "dur": (t1 - t0) / 1e3,
                       "args": {"id": sid, "parent": parent, **(tags or {})}})
    with open(path, "w") as f:
        json.dump(doc, f)
