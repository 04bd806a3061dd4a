"""Host ms a served call takes to issue the model's forward
(``eval/export.py``; with waiting where the launch queue fills): the median
of the program's ``forecast.forward`` spans (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.median_ms("forecast.forward")
