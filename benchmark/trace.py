"""Spans from the benchmark's own files, and the reduction of a profiled
window to device time by span.

A span is a ``torch.profiler.record_function`` range named ``bench/<name>``
opened around a call into a layer: by forward pre- and post-hooks on a port
module (``hook_module``), by an optimizer's step pre- and post-hooks
(``hook_optimizer``), or around a call the benchmark makes (``span``).
Spans exist only in a ``--trace 1`` run; the untraced run installs none.

Device time is given to spans on the device's own timeline, because the
port's kernels are launched from its own library, whose launches the
profiler does not see on the host: on a card each span's entry and exit
also launch an empty marker kernel (``torch.cuda._sleep(0)``) on the
thread's stream, inside a range ``bench:mark/enter/<name>`` or
``bench:mark/exit/<name>`` that tells the marker's kind.  Walking a stream
in execution order, every operation between a span's two markers belongs to
it.  A span whose entry or exit fell outside the profiled stretch is not
counted.

``reduce`` reads the profiler's raw events in memory (no trace file is
written), finds each marker by its launch (the runtime call with the
device operation's correlation id), and returns the busy time (the union of the device operations'
intervals, markers left out), each span's complete instances with their
device time and operation count, the top operations by time and the
longest idle gaps, each named by the spans the host's working thread was in
at the gap's middle.  The profiler now and then loses a record; an
instance whose marker was lost holds more or fewer operations than its
name's others and is left out (``dropped`` counts them), and
``check_spans`` fails a run that lost more than a tenth of a span's
(one, where it had fewer than ten).
"""

from __future__ import annotations

import bisect
import collections
import threading
import time
from typing import List, Optional

import torch

PREFIX = "bench/"
MARK = "bench:mark/"
LOST_SHARE = 0.1  # the share of a span's instances a run may lose
_MARKERS = {"on": False}


class _Stack(threading.local):
    def __init__(self):
        self.open = collections.defaultdict(list)


_STACK = _Stack()


def use_markers(device: torch.device) -> None:
    """Launch marker kernels at span edges (on a card)."""
    _MARKERS["on"] = device.type == "cuda"


def _mark(kind: str, name: str) -> None:
    if _MARKERS["on"]:
        with torch.profiler.record_function(f"{MARK}{kind}/{name}"):
            torch.cuda._sleep(0)


def _enter(name: str):
    rf = torch.profiler.record_function(PREFIX + name)
    rf.__enter__()
    _STACK.open[name].append(rf)
    _mark("enter", name)


def _exit(name: str):
    _mark("exit", name)
    _STACK.open[name].pop().__exit__(None, None, None)


class span:
    """``with span("forecast_fn"): ...``"""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _enter(self.name)
        return self

    def __exit__(self, *exc):
        _exit(self.name)
        return False


def hook_module(module: torch.nn.Module, name: str) -> list:
    """Open ``bench/<name>`` around every call of ``module``; returns the
    hook handles."""
    pre = module.register_forward_pre_hook(lambda mod, args: _enter(name))
    post = module.register_forward_hook(lambda mod, args, out: _exit(name))
    return [pre, post]


def hook_optimizer(optimizer: torch.optim.Optimizer, name: str = "optimizer") -> list:
    pre = optimizer.register_step_pre_hook(lambda opt, args, kwargs: _enter(name))
    post = optimizer.register_step_post_hook(lambda opt, args, kwargs: _exit(name))
    return [pre, post]


def remove(handles: list) -> None:
    for h in handles:
        h.remove()


def start_profiler(device: torch.device, host: bool = True):
    """A started profiler of the device (on a card) and, with ``host``, of
    the host's operations and spans, after the device has finished what was
    queued.  Recording the host's operations slows a host-bound loop, so
    the busy time and the idle share come from a stretch without it."""
    # On the CPU (rehearsals) there is no device to trace: record the host.
    activities = ([torch.profiler.ProfilerActivity.CPU] if host or device.type != "cuda"
                  else [])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    if device.type == "cuda":
        # The device's first records after a start can be lost: let the
        # tracing settle on a throwaway operation first.
        torch.ones(8, device=device).sum()
        torch.cuda.synchronize(device)
    return prof


def warm_profiler(device: torch.device) -> None:
    """One short profile in set-up: the profiler's first start initialises
    the device tracing, which would otherwise stall the window."""
    prof = start_profiler(device)
    torch.ones(8, device=device).sum()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()


def stop_profiler(prof, device: torch.device) -> float:
    """Stop after the device has run what was launched, inside a span
    ``sync`` whose start tells ``reduce`` which host spans were done;
    returns the host clock (``time.perf_counter``) at the synchronise's end,
    the profiled stretch's end."""
    with torch.profiler.record_function(PREFIX + "sync"):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    end = time.perf_counter()
    prof.stop()
    return end


def _ns(ev, which: str) -> int:
    fn = getattr(ev, f"{which}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{which}_us")() * 1000)


def _stream(ev) -> int:
    fn = getattr(ev, "device_resource_id", None)
    return int(fn()) if fn is not None else 0


def reduce(prof, window_s: float, work_span: Optional[str] = None, top: int = 10) -> dict:
    """Reduce a stopped profiler (see the module docstring).  ``work_span``:
    a span of the host thread that drives the device, whose spans name the
    idle gaps."""
    device, launches = [], {}
    ranges = collections.defaultdict(list)  # (thread, name) -> [(start, end)]
    marks = collections.defaultdict(list)  # thread -> [(start, end, kind, name)]
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        name = ev.name()
        if ev.device_type() != torch.autograd.DeviceType.CPU:
            if not name.startswith("bench"):  # not the ranges' device-side copies
                device.append((start, end, name, ev.correlation_id(), _stream(ev)))
            continue
        tid = ev.start_thread_id()
        if name.startswith(MARK):
            kind, sname = name[len(MARK):].split("/", 1)
            marks[tid].append((start, end, kind, sname))
        elif name.startswith(PREFIX):
            ranges[(tid, name[len(PREFIX):])].append((start, end))
        elif name.startswith("cu"):  # a runtime or driver call: a launch, a copy
            launches[ev.correlation_id()] = (tid, start)
    for v in marks.values():
        v.sort()
    mark_starts = {tid: [m[0] for m in v] for tid, v in marks.items()}

    def marker_of(correlation):
        launch = launches.get(correlation)
        if launch is None or launch[0] not in marks:
            return None
        tid, t = launch
        i = bisect.bisect_right(mark_starts[tid], t) - 1
        if i >= 0 and marks[tid][i][0] <= t <= marks[tid][i][1]:
            return marks[tid][i][2:]
        return None

    by_stream = collections.defaultdict(list)
    for op in device:
        by_stream[op[4]].append(op)
    instances = collections.defaultdict(list)  # name -> [(ns, ops)]
    work, by_name = [], collections.Counter()
    for ops in by_stream.values():
        ops.sort()
        open_ = {}
        for start, end, name, correlation, _ in ops:
            mark = marker_of(correlation)
            if mark is not None:
                kind, sname = mark
                if kind == "enter":
                    open_[sname] = [0, 0]
                elif sname in open_:
                    instances[sname].append(tuple(open_.pop(sname)))
                continue
            work.append((start, end))
            by_name[name] += end - start
            for acc in open_.values():
                acc[0] += end - start
                acc[1] += 1

    sync = [s for (_, n), v in ranges.items() if n == "sync" for s, _ in v]
    sync_start = min(sync) if sync else None
    host_done, host_all = collections.Counter(), collections.Counter()
    for (_, n), v in ranges.items():
        if n != "sync":
            host_all[n] += len(v)
            host_done[n] += sum(1 for _, e in v if sync_start is None or e < sync_start)

    work_thread = None
    if work_span is not None:
        counts = collections.Counter({tid: len(v) for (tid, n), v in ranges.items()
                                      if n == work_span})
        work_thread = counts.most_common(1)[0][0] if counts else None
    busy, gaps = _busy_and_gaps(work)
    named_gaps = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (g0 + g1) // 2
        inside = sorted(n for (tid, n), v in ranges.items()
                        if (work_thread is None or tid == work_thread)
                        and any(s <= mid <= e for s, e in v))
        named_gaps.append(["/".join(inside) or "outside spans", (g1 - g0) / 1e9])
    # A marker the profiler lost merges an instance with its neighbour (or
    # drops it): only instances holding the modal count of operations stay.
    kept, dropped = {}, {}
    for n, v in instances.items():
        mode = collections.Counter(k for _, k in v).most_common(1)[0][0]
        kept[n] = [(ns / 1e9, k) for ns, k in v if k == mode]
        dropped[n] = len(v) - len(kept[n])
    return {
        "busy_s": busy / 1e9,
        "window_s": window_s,
        "device_ops": len(work),
        "spans": kept,
        "dropped": dropped,
        "host_done": dict(host_done),
        "host_all": dict(host_all),
        "top_ops": [[n, t / 1e9] for n, t in by_name.most_common(top)],
        "idle_gaps": named_gaps,
    }


def _busy_and_gaps(intervals: List[tuple]):
    """Length of the union of ``intervals`` and the gaps between its runs."""
    busy, gaps, cur = 0, [], None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy, gaps


def check_spans(trace: dict, names) -> List[str]:
    """What the profiler lost, for each span in ``names``: a span whose
    complete instances with the modal count of device operations fall short
    of the host ranges done before the final synchronise by more than
    ``LOST_SHARE`` of them (or by more than one), or outnumber the ranges
    the host recorded, or hold no device operation.  Empty when the spans have their records; the instances a
    lost marker spoilt are left out of every metric.  Without device
    operations (a CPU run) only the host ranges are looked at."""
    faults = []
    for name in names:
        done, seen = trace["host_done"].get(name, 0), trace["host_all"].get(name, 0)
        if not seen:
            faults.append(f"span {name}: no range recorded")
            continue
        if not trace["device_ops"]:
            continue
        recs = trace["spans"].get(name, [])
        allowed = max(1, int(LOST_SHARE * done))
        if not done - allowed <= len(recs) <= seen or not recs or recs[0][1] == 0:
            faults.append(f"span {name}: {len(recs)} whole instances on the device, "
                          f"{done} to {seen} ranges on the host")
    return faults
