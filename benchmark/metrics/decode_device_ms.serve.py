"""Device ms a forward inside the CrossAttnRNN decode loop
(``models/cross_attn_rnn.py``: the ``decoder`` span around each call of the
decode cell, ``out_len`` a forward), over the complete instances the
profiler saw."""


def read(ctx):
    t = ctx.trace
    recs = (t or {}).get("spans", {}).get("decoder")
    if not t or not t["device_ops"] or not recs:
        return None
    forwards = len(recs) / ctx.spans["decoder"]["per_forward"]
    return 1e3 * sum(s for s, _ in recs) / forwards
