"""The port's serving loop and client on the CPU: ``serve_forever`` in a
subprocess (``cli.serve --artifact --http 0``) drains its in-flight request
on SIGTERM and exits 143; each package's client talks to the other
package's server; the client retries a 503 and never a 400; an artifact
served over HTTP answers as its callable does.

The servers wrap numpy callables (both are stdlib + numpy), except the
subprocess and the artifact test, which serve a tiny gated_v4 artifact
(tiny backbone at 32², E = H = 16, B = 4) on the CPU.
"""

import http.client
import io
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from visuelle2_tpu.eval import client as jclient
from visuelle2_tpu.eval import server as jserver
from visuelle2_tpu_torch.cli.export import synth_batch
from visuelle2_tpu_torch.eval import client, server
from visuelle2_tpu_torch.eval.export import export_forecaster, load_forecaster
from visuelle2_tpu_torch.models import VocabSizes, build

ROOT = pathlib.Path(__file__).resolve().parents[1]
HEADER = {"keys": ["mask", "ts"], "shapes": {"mask": [4], "ts": [4, 12]},
          "dtypes": {"mask": "float32", "ts": "float32"}}


def _double(batch):
    return batch["ts"] * 2.0 + batch["mask"][:, None]


def _request(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"mask": np.ones(n, np.float32), "ts": rng.random((n, 12)).astype(np.float32)}


class _Serving:
    """``make_server`` of one package on an ephemeral port, in a thread."""

    def __init__(self, make_server, fn, header=HEADER):
        self.srv = make_server(fn, header, port=0)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.server_close()
        if self.srv.batcher is not None:
            self.srv.batcher.close()
        self.thread.join(timeout=30)


@pytest.mark.parametrize("pair", ["port client, JAX server", "JAX client, port server"])
def test_each_client_talks_to_the_other_packages_server(pair):
    make_server = jserver.make_server if pair.startswith("port") else server.make_server
    Client = client.ForecastClient if pair.startswith("port") else jclient.ForecastClient
    with _Serving(make_server, _double) as s:
        c = Client(s.url, timeout=30)
        req = _request(3, seed=1)
        np.testing.assert_array_equal(c.forecast(req), _double(req))
        health = c.health()
        assert health["requests"] == 1 and health["keys"] == HEADER["keys"]
        with pytest.raises(Exception, match="dtype"):
            c.forecast(dict(req, ts=req["ts"].astype(np.float64)))


@pytest.mark.parametrize("package", ["port", "jax"])
def test_client_retries_a_503_and_never_a_400(package):
    Client = client.ForecastClient if package == "port" else jclient.ForecastClient
    calls = []

    def flaky(batch):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("device hiccup")
        return _double(batch)

    with _Serving(server.make_server, flaky) as s:
        req = _request(2)
        np.testing.assert_array_equal(
            Client(s.url, timeout=30, retries=2, backoff_s=0.01).forecast(req), _double(req))
        assert len(calls) == 2
        # A malformed request is refused once: no retry, no dispatch.
        before = Client(s.url).health()["requests"]
        errors = (client.ServerError, jclient.ServerError)
        with pytest.raises(errors, match="dtype"):
            Client(s.url, timeout=30, retries=3, backoff_s=0.01).forecast(
                dict(req, mask=req["mask"].astype(np.float64)))
        assert Client(s.url).health()["requests"] == before + 1 and len(calls) == 2
        # Without retries a 503 is raised as transient.
        calls.clear()
        transient = (client.TransientServerError, jclient.TransientServerError)
        with pytest.raises(transient, match="device hiccup"):
            Client(s.url, timeout=30).forecast(req)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    torch.set_num_threads(1)
    vocab = VocabSizes(5, 6, 5, 126)
    model = build("gated_v4", device="cpu", generator=torch.Generator().manual_seed(1),
                  vocab=vocab, output_len=12, embedding_dim=16, hidden_dim=16,
                  image_arch="tiny")
    path = str(tmp_path_factory.mktemp("art") / "gated_v4.v2torch")
    export_forecaster(model, synth_batch(4, 32, vocab, demand=True, output_len=12), path)
    return path, vocab


def test_artifact_served_over_http_answers_as_its_callable(artifact):
    path, vocab = artifact
    fn, header = load_forecaster(path, device="cpu")
    with _Serving(server.make_server, fn, header) as s:
        c = client.ForecastClient(s.url, timeout=120)
        full = synth_batch(4, 32, vocab, demand=True, output_len=12, seed=3)
        want = fn(full)
        short = {k: v[:2] for k, v in full.items()}
        got = c.forecast(short)
    assert got.shape == (2, 12)
    np.testing.assert_allclose(got, want[:2], rtol=0, atol=1e-5)


def test_serve_forever_drains_its_in_flight_request_on_sigterm(artifact):
    """``cli.serve --artifact --http 0`` in a subprocess: a request with half
    its body sent when the SIGTERM lands is still answered, no new
    connection is taken, and the process exits 143."""
    path, vocab = artifact
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "visuelle2_tpu_torch.cli.serve", "--artifact", path,
         "--http", "0", "--device", "cpu", "--drain_grace_s", "60"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving on :"):
                break
        assert lines and lines[-1].startswith("serving on :"), lines
        port = int(lines[-1].split(":")[1].split()[0])
        c = client.ForecastClient(f"http://127.0.0.1:{port}", timeout=120)
        req = synth_batch(2, 32, vocab, demand=True, output_len=12, seed=4)
        before = c.forecast(req)
        buf = io.BytesIO()
        np.savez(buf, **req)
        body = buf.getvalue()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.putrequest("POST", "/forecast")
        conn.putheader("Content-Length", str(len(body)))
        conn.endheaders()
        conn.send(body[: len(body) // 2])
        deadline = time.monotonic() + 60
        while c.health()["inflight"] < 1:
            assert time.monotonic() < deadline, "the request never reached its handler"
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 60
        while True:  # the listening socket closes: new connections are refused
            try:
                c.health()
            except OSError:
                break
            assert time.monotonic() < deadline, "still accepting after SIGTERM"
            time.sleep(0.05)
        conn.send(body[len(body) // 2:])
        resp = conn.getresponse()
        assert resp.status == 200
        np.testing.assert_array_equal(np.load(io.BytesIO(resp.read()))["forecast"], before)
        assert proc.wait(timeout=120) == 143
        assert "SIGTERM: drained in-flight requests, exiting 143" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        proc.stdout.close()
