"""Host ms a training step takes to issue the train-mode forward and the
loss (``train/loop.py::Trainer``): the median of the program's
``train.forward`` spans (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.median_ms("train.forward")
