"""Device ms a step inside Adafactor's ``step`` (``train/optim.py``; the
``optimizer`` span opened by the optimizer's step hooks)."""


def read(ctx):
    t = ctx.trace
    recs = (t or {}).get("spans", {}).get("optimizer")
    if not t or not t["device_ops"] or not recs:
        return None
    return 1e3 * sum(s for s, _ in recs) / len(recs)
