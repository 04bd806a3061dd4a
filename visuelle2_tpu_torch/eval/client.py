"""Python client for the HTTP inference server — stdlib and numpy only,
counterpart of ``visuelle2_tpu/eval/client.py`` (the code is framework-free,
so it is the JAX package's; either client talks to either package's server).

It wraps the npz-over-HTTP protocol of ``eval/server.py``, so a
deployment's callers need neither torch nor this package's model code:

    from visuelle2_tpu_torch.eval.client import ForecastClient
    client = ForecastClient("http://gpu-host:8080")
    forecast = client.forecast({"images": ..., "ts": ..., "mask": ...})

Any HTTP client in any language works — the wire format is numpy's own
``.npz`` both ways; this class packages the encode and decode and turns the
server's 400 reasons into raised ``ServerError``s.
"""

from __future__ import annotations

import io
import json
import socket
import time
import urllib.error
import urllib.request
from typing import Dict

import numpy as np


class ServerError(RuntimeError):
    """The server rejected the request (HTTP 400 body = the reason).

    Permanent: the same request will fail again — fix the batch."""


class TransientServerError(RuntimeError):
    """A server-side fault (HTTP 503 body = the reason).

    Retryable: the request itself is fine — device/runtime hiccup or a
    shutdown race; retry with backoff."""


class ForecastClient:
    """``retries`` re-attempts (with ``backoff_s * 2**attempt`` sleeps)
    cover the RETRYABLE fault classes only: 503s (device hiccup, shutdown
    race) and connection-level failures (refused/reset during a rolling
    restart or preemption drain, read timeouts).  Forecasting is pure —
    the server holds no per-request state — so re-sending after ANY of
    those, including a timeout where the reply was lost, is safe.
    Permanent 400s never retry.  Default ``retries=0`` raises on the
    first fault, matching the bare protocol."""

    def __init__(self, base_url: str, timeout: float = 120.0,
                 retries: int = 0, backoff_s: float = 0.5):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.retries = int(retries)
        self.backoff_s = backoff_s

    def health(self) -> dict:
        """Server signature: batch keys/shapes, requests/dispatches counters
        (their ratio is the achieved request-coalescing factor)."""
        with urllib.request.urlopen(f"{self.base_url}/health",
                                    timeout=self.timeout) as r:
            return json.loads(r.read())

    def forecast(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """POST a batch (1..B rows; all arrays share the sample axis) and
        return the model-space forecasts for exactly those rows.  Rescaling
        by the norm scalar stays with the caller, as in the reference's
        eval scripts."""
        buf = io.BytesIO()
        np.savez(buf, **{k: np.asarray(v) for k, v in batch.items()})
        data = buf.getvalue()
        for attempt in range(self.retries + 1):
            req = urllib.request.Request(f"{self.base_url}/forecast",
                                         data=data, method="POST")
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    return np.load(io.BytesIO(r.read()))["forecast"]
            except urllib.error.HTTPError as e:
                if e.code == 400:
                    raise ServerError(e.read().decode()) from None
                if e.code != 503:
                    raise  # unclassified HTTP error: treat as permanent
                err = TransientServerError(e.read().decode())
            except (urllib.error.URLError, ConnectionError,
                    TimeoutError) as e:
                reason = getattr(e, "reason", None)
                if isinstance(reason, socket.gaierror):
                    # DNS resolution failure: a misconfigured base_url —
                    # permanent; don't burn the backoff budget retrying it.
                    raise
                err = e  # refused/reset/timed out: retryable (pure call)
            if attempt == self.retries:
                raise err from None
            time.sleep(self.backoff_s * (2.0 ** attempt))
