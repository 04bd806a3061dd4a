"""Host ms between two dispatches in a row (serving, ``MicroBatcher``: the
worker slicing the answers, waiting for requests, packing FIFO and padding
the next batch), from the benchmark's clock around the callable it hands
the batcher, outside the profiled stretches."""


def read(ctx):
    gaps = ctx.counters["gaps_s"]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
