"""The ported CrossAttnRNN family on the CPU: each model vs its JAX model, on
the JAX package's XLA path and on its Pallas path (interpret mode), the
Demand ablations and attention weights, the strict weight bridge, and an
HTTP round trip of a small Demand through the port's server.

Small widths: tiny backbone, 64² images (2×2 = 4 patches, so the image
softmax runs over more than one), B ≤ 6; Demand E = A = 16, H = 20 (its
projected attention needs A == E), the window models A = 12 ≠ E = 16.
f32 tolerance 1e-4, as in tests/test_whole_model_golden.py: a whole forward
stacks many sums that run in another order in the two frameworks.
"""

import copy
import functools
import io
import json
import threading
import urllib.request

import numpy as np
import pytest

import jax
import torch
from jax.experimental.pallas import tpu as pltpu

from __graft_entry__ import _synthetic_batch, _synthetic_stfore_batch
from visuelle2_tpu.models import VocabSizes as JVocab
from visuelle2_tpu.models import build as jbuild
from visuelle2_tpu_torch.convert import load_jax_variables
from visuelle2_tpu_torch.eval.export import make_forecaster
from visuelle2_tpu_torch.eval.server import drain_and_close, make_server
from visuelle2_tpu_torch.models import VocabSizes, build
from visuelle2_tpu_torch.ops.cuda import additive_attention as taa

ATOL = 1e-4
IMAGE = 64
DEMAND = dict(attention_dim=16, embedding_dim=16, hidden_dim=20)
WINDOW = dict(attention_dim=12, embedding_dim=16, hidden_dim=20)


def _kw(name, **extra):
    dims = DEMAND if name == "cross_attn_rnn_demand" else WINDOW
    return dict(image_arch="tiny", **dims, **extra)


def _batch(name, n, seed, out_len):
    if name == "cross_attn_rnn_demand":
        return _synthetic_batch(n, IMAGE, seed=seed)
    return _synthetic_stfore_batch(n, IMAGE, seed=seed, windows=2, horizon=out_len)


@functools.lru_cache(maxsize=None)
def _full_variables(name):
    """The JAX variables of ``name`` with every modality (the parameters do
    not depend on ``out_len``; Demand's must match its 12-week series).  One
    init per model: an init runs a whole eager forward, the slowest step of
    these tests."""
    out_len = 12 if name == "cross_attn_rnn_demand" else 1
    model = jbuild(name, vocab=JVocab(5, 6, 5, 126), **_kw(name, out_len=out_len))
    variables = model.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                           _batch(name, 2, 5, out_len), train=False)
    return jax.tree_util.tree_map(np.array, variables)


# Option -> (its default, the subtrees of the full model's variables that
# the JAX model does not build when the option differs from it).
_UNBUILT = {
    "use_img": (True, [("static", "image_encoder"), ("decoder", "fusion", "img_attention")]),
    "use_trends": (True, [("ts_self_attention",), ("decoder", "fusion", "ts_attention"),
                          ("decoder", "fusion", "trend_linear")]),
    "faithful_temporal_bug": (False, [("static", "temp_encoder", n)
                                      for n in ("week", "month", "year")]),
}


def _jax_model(name, **extra):
    """(JAX model, its variables) for ``name`` under ``extra``."""
    model = jbuild(name, vocab=JVocab(5, 6, 5, 126), **_kw(name, **extra))
    variables = copy.deepcopy(_full_variables(name))
    for option, (default, paths) in _UNBUILT.items():
        if extra.get(option, default) != default:
            for path in paths:
                for col in variables.values():
                    _drop(col, path, missing_ok=True)
    return model, variables


def _port_model(variables, name, **extra):
    model = build(name, device="cpu", vocab=VocabSizes(5, 6, 5, 126), **_kw(name, **extra))
    return load_jax_variables(model, variables)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _compare(name, *, seed, n=5, pallas=False, **extra):
    """-> (port output, port aux, JAX output, JAX aux) on the same batch."""
    jm, variables = _jax_model(name, **extra)
    batch = _batch(name, n, seed, extra.get("out_len", 1))
    if pallas:
        with pltpu.force_tpu_interpret_mode():
            want, want_aux = jbuild(name, vocab=JVocab(5, 6, 5, 126), use_pallas=True,
                                    **_kw(name, **extra)).apply(variables, batch, train=False)
    else:
        want, want_aux = jm.apply(variables, batch, train=False)
    before = taa.fused_additive_attention.launches
    with torch.inference_mode():
        got, aux = _port_model(variables, name, **extra)(_torch_batch(batch))
    assert taa.fused_additive_attention.launches == before  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    return got, aux, want, want_aux


@pytest.mark.parametrize("extra", [
    {}, {"use_img": False}, {"use_att": False}, {"use_trends": False},
    {"faithful_temporal_bug": True}], ids=["all", "no_img", "no_att", "no_trends",
                                           "faithful_temporal_bug"])
def test_demand_matches_jax(extra):
    got, aux, _, want_aux = _compare("cross_attn_rnn_demand", seed=11, out_len=12, **extra)
    assert tuple(got.shape) == (5, 12, 1)
    assert sorted(aux) == sorted(want_aux)
    for key, alpha in aux.items():
        assert tuple(alpha.shape) == tuple(np.shape(want_aux[key]))
        np.testing.assert_allclose(alpha.numpy(), np.asarray(want_aux[key]), atol=1e-5,
                                   rtol=0)
    lengths = {"img": 4, "trend": 52,
               "multimodal": 1 + sum(extra.get(k, True) for k in ("use_img", "use_att",
                                                                 "use_trends"))}
    for key, alpha in aux.items():
        assert alpha.shape[-1] == lengths[key]


@pytest.mark.parametrize("name,out_len,shape", [("cross_attn_rnn_21", 1, (5, 2, 1)),
                                                ("cross_attn_rnn_210", 4, (10, 4))])
def test_window_models_match_jax(name, out_len, shape):
    got, aux, _, _ = _compare(name, seed=12, out_len=out_len)
    assert aux is None and tuple(got.shape) == shape


def test_window_model_without_image_matches_jax():
    _compare("cross_attn_rnn_210", seed=13, out_len=3, use_img=False)


@pytest.mark.parametrize("name,out_len", [("cross_attn_rnn_demand", 12),
                                          ("cross_attn_rnn_21", 1),
                                          ("cross_attn_rnn_210", 3)])
def test_models_match_jax_pallas_path(name, out_len):
    """The JAX model on its Pallas path (fused additive attention in
    interpret mode)."""
    _compare(name, seed=14, n=3, pallas=True, out_len=out_len)


def _drop(tree, path, missing_ok=False):
    for k in path[:-1]:
        if missing_ok and k not in tree:
            return
        tree = tree[k]
    if path[-1] in tree or not missing_ok:
        del tree[path[-1]]


def test_bridge_is_strict_for_demand():
    name = "cross_attn_rnn_demand"
    _, variables = _jax_model(name, out_len=12)
    port = lambda **kw: build(name, device="cpu", vocab=VocabSizes(5, 6, 5, 126),
                              **_kw(name, **kw))

    missing = jax.tree_util.tree_map(np.array, variables)
    _drop(missing, ("params", "decoder", "fusion", "ts_attention", "attn_linear", "bias"))
    with pytest.raises(KeyError, match="ts_attention/attn_linear/bias"):
        load_jax_variables(port(), missing)

    # The JAX tree of the faithful temporal encoder holds only `day`.
    with pytest.raises(ValueError, match="temp_encoder/week"):
        load_jax_variables(port(faithful_temporal_bug=True), variables)
    jm, faithful = _jax_model(name, out_len=12, faithful_temporal_bug=True)
    jm.apply(faithful, _batch(name, 2, 0, 12), train=False)  # the tree the JAX model reads
    with pytest.raises(KeyError, match="temp_encoder/week"):
        load_jax_variables(port(), faithful)


def test_projected_attention_needs_matching_widths():
    with pytest.raises(ValueError, match="attention_dim == embedding_dim"):
        build("cross_attn_rnn_demand", device="cpu", image_arch="tiny", attention_dim=12,
              embedding_dim=16, hidden_dim=20)


def test_http_round_trip_of_demand():
    name = "cross_attn_rnn_demand"
    _, variables = _jax_model(name, out_len=12)
    model = _port_model(variables, name, out_len=12)
    example = _synthetic_batch(6, IMAGE, seed=0)
    fn, header = make_forecaster(model, example, device="cpu")
    srv = make_server(fn, header, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    requests = {n: _synthetic_batch(n, IMAGE, seed=30 + n) for n in (1, 2)}
    replies = {}

    def post(n):
        buf = io.BytesIO()
        np.savez(buf, **requests[n])
        req = urllib.request.Request(url + "/forecast", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            with np.load(io.BytesIO(resp.read())) as z:
                replies[n] = z["forecast"]

    try:
        clients = [threading.Thread(target=post, args=(n,)) for n in requests]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=180)
        assert not any(c.is_alive() for c in clients)
        with urllib.request.urlopen(url + "/health", timeout=30) as resp:
            health = json.loads(resp.read())
    finally:
        srv.shutdown()
        drain_and_close(srv)
        thread.join(timeout=10)
    assert health["requests"] == 2 and 1 <= health["dispatches"] <= 2
    for n, batch in requests.items():
        with torch.inference_mode():
            direct, _ = model(_torch_batch(batch))
        assert replies[n].shape == (n, 12, 1)
        np.testing.assert_allclose(replies[n], direct.numpy(), atol=1e-5, rtol=0)
