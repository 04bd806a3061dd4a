"""Model FLOPs of the forecasts served, as a share of the card's bf16
peak, in %: the real rows of the dispatches inside the stretch profiled
for the device alone x one row's forward (``yardstick/flops.py``), over the
stretch and 989 TFLOP/s."""

from benchmark.yardstick import flops, peaks


def read(ctx):
    t = (ctx.trace or {}).get("device")
    if not t or not t["device_ops"] or not t["real_rows"]:
        return None
    work = t["real_rows"] * flops.forward_flops_per_row(ctx.config)
    return 100.0 * work / t["window_s"] / peaks.MFU_PEAK
