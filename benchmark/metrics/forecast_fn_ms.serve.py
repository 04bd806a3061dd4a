"""Host ms a ``forecast_fn`` call (the served callable of
``eval/export.py``: upload, forward, ``.cpu()``), outside the profiled
stretches; the call ends on the device's result, so the host's clock is
sound."""


def read(ctx):
    calls = ctx.counters["calls"]
    return 1e3 * sum(d for d, _ in calls) / len(calls) if calls else None
