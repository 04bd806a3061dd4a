"""Host ms on ``MicroBatcher``'s worker from the end of one ``forecast_fn``
call to the start of the next (slicing the answers, waking the clients,
waiting, taking and packing the next dispatch): the median gap between the
program's ``batcher.call`` spans on one thread (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.median_gap_ms("batcher.call")
