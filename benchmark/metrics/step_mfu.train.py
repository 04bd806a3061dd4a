"""Model FLOPs of the rows trained, as a share of the card's bf16 peak,
in %: the rows of the steps inside the stretch profiled for the device
alone x one row's forward and backward under the freeze split
(``yardstick/flops.py``: the backbone's convolutions forward, the
trainable stages (layer3 and layer4) backward at twice their forward,
layer3_0's first convolutions their weight gradient only, the heads at
three times their forward), over
the stretch and 989 TFLOP/s."""

from benchmark.yardstick import flops, peaks


def read(ctx):
    t = (ctx.trace or {}).get("device")
    if not t or not t["device_ops"] or not t["real_rows"]:
        return None
    work = t["real_rows"] * flops.train_flops_per_row(ctx.config)
    return 100.0 * work / t["window_s"] / peaks.MFU_PEAK
