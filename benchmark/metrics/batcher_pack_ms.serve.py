"""Host ms ``MicroBatcher`` takes to concatenate and pad a dispatch
(``eval/server.py``): the median of the program's ``batcher.pack`` spans
(``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.median_ms("batcher.pack")
