"""The 95th percentile of the requests returned in the window, ``submit``
to the return of its rows, in ms, leaving out those the profiler's stretches
held.  The serving cells' closed loop keeps the
batcher's queue full, so the tail swings with the throughput: it is read
here, beside the layers, and not held to a bound (an open loop at four
fifths of the knee would make it an end-to-end metric)."""

from benchmark import core


def read(ctx):
    lat = ctx.counters["latencies_ms"]
    return core.quantile(lat, 0.95) if lat else None
