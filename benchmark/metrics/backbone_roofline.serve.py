"""The backbone's share of its roofline, in % (``models/resnet.py``): the
least time of each call's work on the card (the larger of its
convolutions' operations over the bf16 peak and its input, weights and
output over the HBM rate; ``yardstick/``) over the device time of the
operations launched inside the ``backbone`` span, summed over the calls
the profiler saw."""

from benchmark.yardstick import flops, peaks


def read(ctx):
    t = ctx.trace
    recs = (t or {}).get("spans", {}).get("backbone")
    if not t or not t["device_ops"] or not recs:
        return None
    device_s = sum(s for s, _ in recs)
    arch, image = ctx.model["image_arch"], ctx.config["image_size"]
    least = peaks.bound_s(flops.backbone_bytes(ctx.batch, arch, image),
                          flops.backbone_forward_flops(arch, image) * ctx.batch, "bf16")
    return 100.0 * least * len(recs) / device_s if device_s > 0 else None
