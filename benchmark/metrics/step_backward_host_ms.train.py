"""Host ms a training step takes to zero the gradients and issue
``backward`` (``train/loop.py::Trainer``): the median of the program's
``train.backward`` spans (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.median_ms("train.backward")
