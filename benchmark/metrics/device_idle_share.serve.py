"""The share of a profiled stretch in which no operation ran on the
device, in %: 1 − busy / stretch (serving cells).  The stretch records the
device alone: recording the host's operations as well slows a host-bound
loop and would read a longer idle share."""


def read(ctx):
    t = (ctx.trace or {}).get("device")
    if not t or not t["device_ops"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
