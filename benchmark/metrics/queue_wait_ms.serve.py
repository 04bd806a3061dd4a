"""Host ms a request waits in ``MicroBatcher``'s queue (``eval/server.py``),
from ``submit`` until the worker takes it into a dispatch: the median of
the program's ``batcher.queue`` spans (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.median_ms("batcher.queue")
