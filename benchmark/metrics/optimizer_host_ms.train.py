"""Host ms a training step takes to issue Adafactor's update
(``train/optim.py``, called by ``train/loop.py::Trainer``): the median of
the program's ``train.optimizer`` spans (``benchmark/spans.py``); beside
``optimizer_device_ms.train`` it says whether the host holds the card."""

from benchmark import spans


def read(ctx):
    return spans.median_ms("train.optimizer")
