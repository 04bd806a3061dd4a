"""Real rows over the export batch, in %, over every dispatch of the process
(``eval/server.py::MicroBatcher``): the program's counters
``batcher.rows`` over ``batcher.rows`` + ``batcher.padded_rows``, read once
ten ``batcher.call`` spans are recorded (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.share("batcher.rows", "batcher.padded_rows", "batcher.call")
