"""Host ms a served call spends in ``.float().cpu().numpy()``
(``eval/export.py``: waiting for the device to finish, then the copy
back): the median of the program's ``forecast.download`` spans
(``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.median_ms("forecast.download")
