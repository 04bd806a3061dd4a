"""Minimal HTTP inference server — stdlib and numpy only, counterpart of
``visuelle2_tpu/eval/server.py`` (``MicroBatcher``, ``make_server``,
``drain_and_close``, ``serve_forever``).  The code is framework-free, so it
is the JAX package's verbatim; ``forecast_fn`` and ``header`` come from
``visuelle2_tpu_torch.eval.export.make_forecaster`` or ``load_forecaster``.

Protocol (npz in / npz out):

* ``POST /forecast`` — body is an ``.npz`` containing the batch arrays
  (the header's keys).  Short batches are zero-padded to the export batch
  size per key and the response is sliced back, so clients may send 1..B
  rows.
* ``GET /health`` — JSON with the keys/shapes, a request counter, and the
  device-dispatch counter.

Concurrent small requests are coalesced into one device dispatch
(``MicroBatcher``): the call always runs the full export batch B, so packing
K requests' rows into one padded batch is a ~K× throughput win.  An idle
device dispatches immediately with whatever is queued; while a dispatch is in
flight, new arrivals queue and the next flush packs them FIFO up to the row
capacity.  Requests carrying ``img_idx`` are served one per dispatch.
``serve_forever`` serves until SIGTERM or SIGINT and drains in-flight
requests before it returns (exit 143 after a SIGTERM).
"""

from __future__ import annotations

import io
import json
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class _Pending:
    __slots__ = ("arrays", "rows", "event", "result", "error")

    def __init__(self, arrays, rows):
        self.arrays = arrays
        self.rows = rows
        self.event = threading.Event()
        self.result = None
        self.error = None


def _slice_samples(out, batch_rows, start, n):
    """Rows ``start:start+n`` of a model output, per SAMPLE.

    Window-flattened stfore models return [B*W, ...] rather than a
    sample-leading axis (models/cross_attn_rnn.py:270): reshape to a
    leading-B view first, slice samples, and flatten back.  The single
    source of truth for this convention — used by both the coalescing
    worker and the per-request dedup path."""
    if batch_rows and out.shape[0] != batch_rows:
        if out.shape[0] % batch_rows:
            raise ValueError(
                f"forecast rows {out.shape[0]} not a multiple of the "
                f"export batch {batch_rows}; cannot slice to {n} samples")
        w = out.shape[0] // batch_rows
        lead = out.reshape((batch_rows, w) + out.shape[1:])[start:start + n]
        return lead.reshape((n * w,) + out.shape[1:])
    return out[start:start + n]


def _validate_request(arrays, keys, shapes, dtypes, row_exempt=()) -> int:
    """Reject a malformed request with a precise reason; returns its rows.

    ``row_exempt`` names keys whose leading axis is NOT the sample axis
    (dedup artifacts' ``images`` is indexed in image SLOTS) — they still get
    the trailing-dims / capacity / dtype checks, only the shared-row-count
    check skips them.  Dtypes are checked per request: a float64 mask
    (numpy's default) concatenated into a shared pack would promote the
    whole combined array and fail the exported call for every coalesced
    client, not just the offender.
    """
    missing = set(keys) - set(arrays)
    if missing:
        raise ValueError(f"batch missing keys: {sorted(missing)}")
    rows = None
    for k in keys:
        a = np.asarray(arrays[k])
        want = shapes.get(k)  # absent in pre-"shapes" artifact headers
        if want is not None:
            if list(a.shape[1:]) != list(want[1:]):
                raise ValueError(f"'{k}' trailing dims {a.shape[1:]} "
                                 f"!= export {tuple(want[1:])}")
            if a.shape[0] > want[0]:
                raise ValueError(f"'{k}' has {a.shape[0]} rows > "
                                 f"export batch {want[0]}")
        want_dt = dtypes.get(k) if dtypes else None
        if want_dt is not None and a.dtype != np.dtype(want_dt):
            raise ValueError(f"'{k}' dtype {a.dtype} != export {want_dt}")
        if k in row_exempt:
            continue
        if rows is None:
            rows = a.shape[0]
        elif a.shape[0] != rows:
            raise ValueError(
                f"'{k}' has {a.shape[0]} rows but other keys have "
                f"{rows} — all arrays must share the sample axis")
    if rows == 0:
        raise ValueError("empty batch")
    return rows


class MicroBatcher:
    """Packs concurrent forecast requests into shared full-batch dispatches.

    ``forecast_fn`` is only ever called from the single worker thread, so the
    compiled call needs no lock.  ``submit`` blocks the calling (handler)
    thread until its slice of a dispatch is ready.
    """

    def __init__(self, forecast_fn, keys, shapes, dtypes=None):
        self._fn = forecast_fn
        self._keys = keys
        self._shapes = shapes
        self._dtypes = {k: np.dtype(v) for k, v in (dtypes or {}).items()}
        self._capacity = shapes["mask"][0] if "mask" in shapes else \
            next(iter(shapes.values()))[0]
        self._cv = threading.Condition()
        self._queue = []
        self._closed = False
        self.dispatches = 0
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- client API
    def submit(self, arrays) -> np.ndarray:
        rows = self._validate(arrays)
        req = _Pending(arrays, rows)
        with self._cv:
            if self._closed:
                raise RuntimeError("server shutting down")
            self._queue.append(req)
            self._cv.notify()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._worker.join(timeout=5)

    # --------------------------------------------------------------- internal
    def _validate(self, arrays) -> int:
        return _validate_request(arrays, self._keys, self._shapes,
                                 self._dtypes)

    def _take(self):
        """FIFO-pack queued requests into one dispatch, up to capacity."""
        take, rows = [], 0
        while self._queue and rows + self._queue[0].rows <= self._capacity:
            req = self._queue.pop(0)
            take.append(req)
            rows += req.rows
        return take, rows

    def _dispatch(self, take):
        """One padded device call serving every request in ``take``."""
        combined = {}
        for k in self._keys:
            parts = [np.asarray(r.arrays[k]) for r in take]
            a = parts[0] if len(parts) == 1 else np.concatenate(parts)
            want_rows = self._shapes[k][0]
            if a.shape[0] < want_rows:
                pad = [(0, want_rows - a.shape[0])] + \
                      [(0, 0)] * (a.ndim - 1)
                a = np.pad(a, pad)
            combined[k] = a
        out = np.asarray(self._fn(combined))
        self.dispatches += 1
        off = 0
        for r in take:
            r.result = _slice_samples(out, self._capacity, off, r.rows)
            off += r.rows

    def _loop(self):
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue:
                    return
                take, rows = self._take()
            try:
                self._dispatch(take)
            except Exception as first:
                if len(take) == 1:
                    # A singleton that failed would fail identically again:
                    # record the error instead of paying a second
                    # full-batch device call.
                    take[0].error = first
                else:
                    # One bad request must not fail its packmates: fall
                    # back to per-request dispatches so only the offender
                    # errors.
                    for r in take:
                        try:
                            self._dispatch([r])
                        except Exception as e:
                            r.error = e
            for r in take:
                r.event.set()


def make_server(forecast_fn, header, port: int = 0) -> ThreadingHTTPServer:
    """Build (not start) an HTTP server wrapping ``forecast_fn``.

    ``forecast_fn``/``header`` come from ``eval.export.make_forecaster``.
    ``port=0`` binds an ephemeral port (``server.server_address[1]``).
    """
    keys = header["keys"]
    shapes = {k: tuple(v) for k, v in header.get("shapes", {}).items()}
    # Export batch size (sample rows).  Window-flattened models
    # (CrossAttnRNN210-style stfore) return [B*W, out_len] rather than a
    # sample-leading axis (models/cross_attn_rnn.py:270), so short-batch
    # responses must be sliced per SAMPLE, not per output row.
    batch_rows = shapes.get("mask", (0,))[0]
    dedup = "img_idx" in keys
    stats = {"requests": 0, "dedup_dispatches": 0, "inflight": 0,
             "open_conns": 0}
    stats_lock = threading.Lock()
    batcher = None if dedup else MicroBatcher(forecast_fn, keys, shapes,
                                              header.get("dtypes"))
    lock = threading.Lock()

    def slice_rows(out, n):
        """Slice a model output back to the client's ``n`` real samples."""
        if n is None or n == out.shape[0]:
            return out
        return _slice_samples(out, batch_rows, 0, n)

    def run_dedup(arrays):
        """One dispatch per request: img_idx rows index the request's own
        image slots, so requests cannot be row-concatenated.  Validation
        matches the coalescing path's, except ``images`` is slot-indexed
        (not on the sample axis)."""
        _validate_request(arrays, keys, shapes, header.get("dtypes"),
                          row_exempt=("images",))
        n = np.asarray(arrays["mask"]).shape[0] if "mask" in arrays else None
        padded = {}
        for k in keys:
            a = np.asarray(arrays[k])
            want = shapes.get(k)
            if want is not None and a.shape[0] < want[0]:
                pad = [(0, want[0] - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
                a = np.pad(a, pad)
            padded[k] = a
        with lock:
            out = np.asarray(forecast_fn(padded))
        with stats_lock:
            stats["dedup_dispatches"] += 1
        return slice_rows(out, n)

    def run_batch(arrays):
        with stats_lock:  # handler threads are concurrent
            stats["requests"] += 1
        if batcher is not None:
            return batcher.submit(arrays)
        return run_dedup(arrays)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/health":
                return self._send(404, b"not found", "text/plain")
            body = json.dumps({
                "ok": True, "keys": keys,
                "shapes": {k: list(v) for k, v in shapes.items()},
                "requests": stats["requests"],
                "dispatches": batcher.dispatches if batcher else
                stats["dedup_dispatches"],
                "batched": batcher is not None,
                "inflight": stats["inflight"],
            }).encode()
            self._send(200, body, "application/json")

        def do_POST(self):
            if self.path != "/forecast":
                return self._send(404, b"not found", "text/plain")
            with stats_lock:
                stats["inflight"] += 1
            try:
                self._forecast()
            finally:
                with stats_lock:
                    stats["inflight"] -= 1

        def _forecast(self):
            try:
                length = self.headers["Content-Length"]
                if length is None:
                    # int(None) would raise TypeError, which the generic
                    # handler below maps to a RETRYABLE 503 — but a request
                    # without Content-Length is permanently malformed.
                    raise ValueError("missing Content-Length header")
                raw = self.rfile.read(int(length))
                with np.load(io.BytesIO(raw)) as z:
                    arrays = {k: z[k] for k in z.files}
                out = run_batch(arrays)
                buf = io.BytesIO()
                np.savez(buf, forecast=out)
                self._send(200, buf.getvalue(), "application/octet-stream")
            except (ValueError, KeyError, AssertionError) as e:
                # Malformed request -> permanent client error.
                self._send(400, f"{type(e).__name__}: {e}".encode(),
                           "text/plain")
            except Exception as e:
                # Server-side fault (device/runtime error, shutdown race):
                # 503 so clients and load balancers RETRY, instead of a 400
                # that marks retryable traffic as permanently bad.
                self._send(503, f"{type(e).__name__}: {e}".encode(),
                           "text/plain")

    class Server(ThreadingHTTPServer):
        # Drain coverage starts at socket ACCEPT, not at request dispatch:
        # a connection accepted just before server_close() whose handler is
        # still parsing the request line/headers hasn't touched
        # stats["inflight"] yet and would be invisible to the drain wait.
        # process_request runs synchronously on the accept thread before the
        # handler thread spawns; shutdown_request runs in the handler
        # thread's finally — together they bracket the whole connection
        # lifetime (HTTP/1.0 default: one request per connection).
        def process_request(self, request, client_address):
            with stats_lock:
                stats["open_conns"] += 1
            super().process_request(request, client_address)

        def shutdown_request(self, request):
            try:
                super().shutdown_request(request)
            finally:
                with stats_lock:
                    stats["open_conns"] -= 1

    srv = Server(("0.0.0.0", port), Handler)
    srv.batcher = batcher  # tests / shutdown hook
    # drain_and_close hook: open CONNECTIONS, not dispatched requests —
    # covers accepted-but-not-yet-parsed requests (see Server above).
    srv.inflight = lambda: stats["open_conns"]
    return srv


def drain_and_close(srv, grace_s: float = 10.0) -> None:
    """Stop accepting, let in-flight requests finish, release the device.

    Call AFTER the accept loop has exited (``srv.shutdown()`` or a
    ``serve_forever`` return).  Closes the listening socket immediately —
    new connections are refused, so load balancers fail over — then waits
    up to ``grace_s`` seconds for in-flight handler threads to write their
    responses before closing the MicroBatcher.  Handler threads are
    daemons: a client that stalls past the grace window cannot block
    process exit.
    """
    srv.server_close()
    deadline = time.monotonic() + grace_s
    while srv.inflight() > 0 and time.monotonic() < deadline:
        time.sleep(0.02)
    if srv.batcher is not None:
        srv.batcher.close()


def serve_forever(forecast_fn, header, port: int, grace_s: float = 10.0):
    """Serve until SIGTERM/SIGINT, then drain and exit.

    A cloud machine may be preempted, so the server follows the trainer's
    ``PreemptionWatch`` convention (``train/loop.py``): on SIGTERM it stops
    accepting at once, gives in-flight requests ``grace_s`` seconds to
    complete, and exits 143 so orchestrators tell a drained preemption from
    a crash.  A SIGINT drains the same way and returns.
    """
    srv = make_server(forecast_fn, header, port)
    got_sig = []

    def _on_sigterm(signum, frame):
        got_sig.append(signum)
        # shutdown() blocks until the serve loop (this thread) exits, so it
        # runs off this thread.
        threading.Thread(target=srv.shutdown, daemon=True).start()

    try:
        prev = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # not the main thread (embedded use): no handler
        prev = None
    print(f"serving on :{srv.server_address[1]} "
          f"(POST /forecast, GET /health)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        drain_and_close(srv, grace_s)
    if got_sig:
        print("SIGTERM: drained in-flight requests, exiting 143", flush=True)
        raise SystemExit(143)
