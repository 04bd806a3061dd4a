"""Host ms ``BatchLoader`` takes to assemble a batch (``data/loader.py``:
the prefetch engine's wait, the row gather, the tensors and the next
batch's submit), outside the consumer's time: the median of the program's
``loader.batch`` spans (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.median_ms("loader.batch")
