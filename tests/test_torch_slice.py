"""The whole ported seq2seq family on the CPU: each variant vs its JAX model
(gated_v2 and gated_v4 also vs the JAX model's Pallas path), the modality
ablations, the strict weight bridge, and an HTTP round trip through the
port's server.

Small widths (tiny backbone, E=H=16, 32² images, B ≤ 8).  f32 tolerance
1e-4, as in tests/test_whole_model_golden.py: a whole forward stacks many
sums that run in another order in the two frameworks.
"""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest

import jax
import torch
from jax.experimental.pallas import tpu as pltpu

from __graft_entry__ import _synthetic_batch
from visuelle2_tpu.models import VocabSizes as JVocab
from visuelle2_tpu.models import build as jbuild
from visuelle2_tpu_torch.convert import load_jax_variables
from visuelle2_tpu_torch.eval.export import make_forecaster
from visuelle2_tpu_torch.eval.server import drain_and_close, make_server
from visuelle2_tpu_torch.models import VocabSizes, build

ATOL = 1e-4


def _kw(**extra):
    return dict(output_len=12, image_arch="tiny", embedding_dim=16, hidden_dim=16,
                **extra)


FAMILY = ("gtm", "m4ft", "gated_v1", "gated_v2", "gated_v3", "gated_v4")


def _jax_model(name="gated_v4", **extra):
    model = jbuild(name, vocab=JVocab(5, 6, 5, 126), **_kw(**extra))
    batch = _synthetic_batch(4, 32, seed=5)
    variables = model.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                           batch, train=False)
    return model, jax.tree_util.tree_map(np.array, variables)


def _port_model(variables, name="gated_v4", **extra):
    model = build(name, device="cpu", vocab=VocabSizes(5, 6, 5, 126), **_kw(**extra))
    return load_jax_variables(model, variables)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("autoregressive,use_img", [(False, True), (True, True),
                                                    (False, False)])
def test_gated_v4_matches_jax(autoregressive, use_img):
    jm, variables = _jax_model(autoregressive=autoregressive, use_img=use_img)
    batch = _synthetic_batch(6, 32, seed=11)
    want, _ = jm.apply(variables, batch, train=False)
    tm = _port_model(variables, autoregressive=autoregressive, use_img=use_img)
    with torch.inference_mode():
        got, aux = tm(_torch_batch(batch))
    assert aux is None and tuple(got.shape) == (6, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _assert_port_matches_jax(name, seed, **extra):
    jm, variables = _jax_model(name, **extra)
    batch = _synthetic_batch(6, 32, seed=seed)
    want, _ = jm.apply(variables, batch, train=False)
    with torch.inference_mode():
        got, aux = _port_model(variables, name, **extra)(_torch_batch(batch))
    assert aux is None and tuple(got.shape) == (6, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("autoregressive", [False, True])
@pytest.mark.parametrize("name", FAMILY)
def test_seq2seq_family_matches_jax(name, autoregressive):
    _assert_port_matches_jax(name, 13, autoregressive=autoregressive)


@pytest.mark.parametrize("name,ablation", [
    *((n, "use_img") for n in ("gtm", "m4ft", "gated_v1", "gated_v2", "gated_v3")),
    *((n, "use_text") for n in ("gtm", "m4ft", "gated_v2"))])
def test_ablations_match_jax(name, ablation):
    _assert_port_matches_jax(name, 14, **{ablation: False})


def test_gated_v2_matches_jax_pallas_path():
    """The JAX model on its Pallas path (fused gated MHA, interpret mode)."""
    _, variables = _jax_model("gated_v2")
    batch = _synthetic_batch(5, 32, seed=12)
    with pltpu.force_tpu_interpret_mode():
        want, _ = jbuild("gated_v2", vocab=JVocab(5, 6, 5, 126), use_pallas=True,
                         **_kw()).apply(variables, batch, train=False)
    with torch.inference_mode():
        got, _ = _port_model(variables, "gated_v2")(_torch_batch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_gated_v4_matches_jax_pallas_path():
    """The JAX model on its Pallas path (fused gated residual, interpret mode)."""
    _, variables = _jax_model()
    batch = _synthetic_batch(5, 32, seed=12)
    with pltpu.force_tpu_interpret_mode():
        want, _ = jbuild("gated_v4", vocab=JVocab(5, 6, 5, 126), use_pallas=True,
                         **_kw()).apply(variables, batch, train=False)
    with torch.inference_mode():
        got, _ = _port_model(variables)(_torch_batch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _drop(tree, path):
    for k in path[:-1]:
        tree = tree[k]
    del tree[path[-1]]


def test_bridge_is_strict():
    _, variables = _jax_model()
    port = lambda: build("gated_v4", device="cpu", vocab=VocabSizes(5, 6, 5, 126), **_kw())

    missing = jax.tree_util.tree_map(np.array, variables)
    _drop(missing, ("params", "fusion", "img_gate_fc", "bias"))
    with pytest.raises(KeyError, match="img_gate_fc/bias"):
        load_jax_variables(port(), missing)

    missing_stat = jax.tree_util.tree_map(np.array, variables)
    _drop(missing_stat, ("batch_stats", "image_encoder", "backbone", "bn1", "var"))
    with pytest.raises(KeyError, match="bn1/var"):
        load_jax_variables(port(), missing_stat)

    extra = jax.tree_util.tree_map(np.array, variables)
    extra["params"]["fusion"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="stray"):
        load_jax_variables(port(), extra)

    wrong = jax.tree_util.tree_map(np.array, variables)
    wrong["params"]["decoder_fc"]["kernel"] = np.zeros((16, 11), np.float32)
    with pytest.raises(ValueError, match="decoder_fc"):
        load_jax_variables(port(), wrong)


def test_bridge_is_strict_for_gated_v2():
    _, variables = _jax_model("gated_v2")
    port = lambda: build("gated_v2", device="cpu", vocab=VocabSizes(5, 6, 5, 126), **_kw())
    load_jax_variables(port(), variables)

    gate = ("params", "decoder", "layer0", "cross_attn", "gate_proj", "bias")
    missing = jax.tree_util.tree_map(np.array, variables)
    _drop(missing, gate)
    with pytest.raises(KeyError, match="cross_attn/gate_proj/bias"):
        load_jax_variables(port(), missing)

    extra = jax.tree_util.tree_map(np.array, variables)
    extra["params"]["gtrend_encoder"]["encoder"]["layer1"]["self_attn"]["stray"] = {
        "kernel": np.zeros((4, 4), np.float32)}
    with pytest.raises(ValueError, match="stray"):
        load_jax_variables(port(), extra)


def test_build_covers_only_the_slice():
    for name in FAMILY:
        model = build(name, device="cpu", **_kw())
        assert model.variant == name and not model.training
    for name in ("cross_attn_rnn_21", "cross_attn_rnn_210", "cross_attn_rnn_demand"):
        model = build(name, device="cpu", image_arch="tiny", attention_dim=16,
                      embedding_dim=16, hidden_dim=16)
        assert not model.training
    for name in ("gtm_v1", "oracle"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
            build(name, device="cpu")
    with pytest.raises(KeyError):
        build("no_such_model", device="cpu")
    with pytest.raises(ValueError, match="text-anchored"):
        build("gated_v4", device="cpu", use_text=False, **_kw())
    model = build("gated_v4", device="cpu", **_kw())
    assert not model.training
    model.train()
    forecast, _ = model(_torch_batch(_synthetic_batch(2, 32)),
                        generator=torch.Generator().manual_seed(0))
    assert forecast.shape == (2, 12) and torch.isfinite(forecast).all()


def test_http_round_trip_coalesces_and_matches_direct_forward():
    _, variables = _jax_model()
    model = _port_model(variables)
    example = _synthetic_batch(8, 32, seed=0)
    fn, header = make_forecaster(model, example, device="cpu")
    assert header["keys"] == sorted(example)
    assert header["shapes"]["images"] == [8, 32, 32, 3]
    srv = make_server(fn, header, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    requests = {n: _synthetic_batch(n, 32, seed=20 + n) for n in (1, 2, 3)}
    replies = {}

    def post(n):
        buf = io.BytesIO()
        np.savez(buf, **requests[n])
        req = urllib.request.Request(url + "/forecast", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            with np.load(io.BytesIO(resp.read())) as z:
                replies[n] = z["forecast"]

    try:
        clients = [threading.Thread(target=post, args=(n,)) for n in requests]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
        assert not any(c.is_alive() for c in clients)
        with urllib.request.urlopen(url + "/health", timeout=30) as resp:
            health = json.loads(resp.read())
    finally:
        srv.shutdown()
        drain_and_close(srv)
        thread.join(timeout=10)
    assert health["requests"] == 3 and 1 <= health["dispatches"] <= 3
    for n, batch in requests.items():
        with torch.inference_mode():
            direct, _ = model(_torch_batch(batch))
        assert replies[n].shape == (n, 12)
        np.testing.assert_allclose(replies[n], direct.numpy(), atol=1e-5, rtol=0)
