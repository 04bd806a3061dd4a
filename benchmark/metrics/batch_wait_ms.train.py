"""Host ms a step spent in ``next(loader)`` (the data plane,
``data/loader.py::BatchLoader`` over the native prefetch engine), over the
window's steps outside the profiled stretch."""


def read(ctx):
    c = ctx.counters
    if not c["loader_waits"]:
        return None
    return 1e3 * c["loader_wait_s"] / c["loader_waits"]
