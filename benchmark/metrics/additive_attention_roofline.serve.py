"""The additive attention's share of its bound, in %
(``ops/cuda/additive_attention.py``): each forward's ``out_len`` steps of
three calls (image patches, trend steps, the four fused tokens; "projected")
bounded by the float32-accurate rule of ``yardstick/peaks.py``, over the
device time inside the ``additive`` spans."""

from benchmark.yardstick import peaks

PATCHES, TREND_LEN, TOKENS = 100, 52, 4


def read(ctx):
    t = ctx.trace
    recs = (t or {}).get("spans", {}).get("additive")
    if not t or not t["device_ops"] or not recs:
        return None
    m = ctx.model
    E, A, H = m["embedding_dim"], m["attention_dim"], m["hidden_dim"]
    per_forward = m["out_len"] * sum(
        peaks.f32_accurate_bound_s(*peaks.additive_attention_cost(
            ctx.batch, L, E, H, A, "projected")) for L in (PATCHES, TREND_LEN, TOKENS))
    forwards = len(recs) / ctx.spans["additive"]["per_forward"]
    device_s = sum(s for s, _ in recs)
    return 100.0 * per_forward * forwards / device_s if device_s > 0 else None
