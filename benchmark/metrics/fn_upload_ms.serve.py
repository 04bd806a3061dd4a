"""Host ms a served call takes to copy its keys to the device
(``eval/export.py``'s ``forecast_fn``, pageable copies): the median of the
program's ``forecast.upload`` spans (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.median_ms("forecast.upload")
