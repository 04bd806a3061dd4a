"""Host ms a training step takes to move its batch to the device
(``train/loop.py::Trainer``, from pinned memory): the median of the
program's ``train.upload`` spans (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.median_ms("train.upload")
