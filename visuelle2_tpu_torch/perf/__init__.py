"""The roofline harness: probes of what the card sustains for the
backbone's convolutions and the conv-floor shapes (``roofline``,
``convfloor_v2``, ``convfloor``), timed by ``timing``."""
