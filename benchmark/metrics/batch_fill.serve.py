"""Rows a dispatch over the export batch, in % (serving,
``eval/server.py::MicroBatcher``): the real rows of the dispatches in the
window, outside the profiled stretches, over their count x the export
batch."""


def read(ctx):
    calls = ctx.counters["calls"]
    if not calls:
        return None
    return 100.0 * sum(r for _, r in calls) / (len(calls) * ctx.counters["export_batch"])
