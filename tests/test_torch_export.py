"""The port's serving artifact on the CPU: int8 weight storage against the
JAX package's, the port's artifacts against JAX's artifacts for the same
weights, every registry model's round trip, the refusals, and the CLIs that
write and read artifacts (``--export``, ``cli.export``, ``cli.serve``).

The JAX weights are the port model's own (``convert.to_jax_variables``), so
no JAX init runs; three ``jax.export`` calls in all (gated_v4 float and
int8, cross_attn_rnn_21 int8), cached per module.  Small sizes: tiny
backbone at 32², E = H = 16 (the window model A = 12, H = 20), B = 8.  f32
tolerance 1e-4, a whole forward's; int8 dequantization bit for bit.
"""

import functools
import io
import json
import os
import re
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax

from visuelle2_tpu.eval import export as jexport
from visuelle2_tpu.models import VocabSizes as JVocab
from visuelle2_tpu.models import build as jbuild
from visuelle2_tpu_torch.cli import export as export_cli
from visuelle2_tpu_torch.cli import forecast_dl, forecast_transformer, serve, train_dl
from visuelle2_tpu_torch.cli import train_transformer
from visuelle2_tpu_torch.convert import to_jax_variables
from visuelle2_tpu_torch.data.synthetic import make_synthetic_dataset
from visuelle2_tpu_torch.eval import export
from visuelle2_tpu_torch.models import VocabSizes, build, model_names
from visuelle2_tpu_torch.models.pretrained import flatten_variables

ATOL = 1e-4
VOCAB = (5, 6, 5, 126)
B, IMAGE = 8, 32
JAX_CASES = {  # build overrides of both packages, the batch's task
    "gated_v4": (dict(output_len=12, embedding_dim=16, hidden_dim=16, image_arch="tiny"),
                 dict(demand=True, output_len=12)),
    "cross_attn_rnn_21": (dict(out_len=1, attention_dim=12, embedding_dim=16, hidden_dim=20,
                               image_arch="tiny"), dict(demand=False, output_len=1)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one CPU thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(task, seed=0, **kw):
    return export_cli.synth_batch(B, IMAGE, VocabSizes(*VOCAB), seed=seed, **task, **kw)


@functools.lru_cache(maxsize=None)
def _port_model(name):
    kw, _ = JAX_CASES[name]
    return build(name, device="cpu", generator=torch.Generator().manual_seed(11),
                 vocab=VocabSizes(*VOCAB), **kw)


@functools.lru_cache(maxsize=None)
def _jax_artifact(name, quantize, directory):
    """JAX's ``export_forecaster`` -> ``load_forecaster`` for the port
    model's weights: its forecasts on a fresh batch, and the file."""
    kw, task = JAX_CASES[name]
    model = jbuild(name, vocab=JVocab(*VOCAB), **kw)
    path = os.path.join(directory, f"{name}-{quantize}.v2tpu")
    jexport.export_forecaster(model, to_jax_variables(_port_model(name)), _batch(task), path,
                              platforms=("cpu",), quantize=quantize, quantize_min_size=64)
    fn, header = jexport.load_forecaster(path)
    return np.asarray(fn(_batch(task, seed=5))), header, path


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("jax_artifacts"))


def test_int8_rule_matches_jax_bit_for_bit():
    """The unit tree of tests/test_export.py (its float32 leaves: the port's
    trees are float32) and an embedding-shaped table."""
    rng = np.random.default_rng(3)
    tree = {"params": {
        "kernel": rng.normal(size=(64, 96)).astype(np.float32) * 3.0,
        "bias": rng.normal(size=(96,)).astype(np.float32),
        "tiny": rng.normal(size=(2, 2)).astype(np.float32),
        "zero": np.zeros((64, 96), np.float32),
        "embedding": rng.normal(size=(126, 16)).astype(np.float32),
    }}
    materialize, n_q = jexport._quantize_variables(tree, min_size=1024)
    want = flatten_variables(jax.tree_util.tree_map(np.asarray, materialize()))
    stored, scales = export.quantize_int8(flatten_variables(tree), 1024)
    assert sorted(scales) == ["params/embedding", "params/kernel", "params/zero"]
    assert len(scales) == n_q and all(stored[k].dtype == np.int8 for k in scales)
    for k, w in want.items():
        got = export.dequantize_int8(stored[k], scales[k]) if k in scales else stored[k]
        assert got.dtype == w.dtype
        np.testing.assert_array_equal(got.view(np.uint32), w.view(np.uint32), err_msg=k)


def test_int8_artifact_weights_equal_jax_materialized(tmp_path):
    """A tiny gated_v4 at quantize_min_size=64: the loaded model's weights
    (embedding tables, Dense and conv kernels in their torch layouts) are
    the JAX artifact's dequantized constants, bit for bit."""
    model = _port_model("gated_v4")
    variables = to_jax_variables(model)
    materialize, n_q = jexport._quantize_variables(variables, min_size=64)
    want = flatten_variables(jax.tree_util.tree_map(np.asarray, materialize()))
    path = str(tmp_path / "q.v2torch")
    export.export_forecaster(model, _batch(JAX_CASES["gated_v4"][1]), path, quantize="int8",
                             quantize_min_size=64)
    fn, header = export.load_forecaster(path, device="cpu")
    assert header["quantize"] == "int8" and header["quantized_arrays"] == n_q
    got = flatten_variables(to_jax_variables(fn.model))
    assert got.keys() == want.keys()
    quantized = [k for k in got if not np.array_equal(got[k], flatten_variables(variables)[k])]
    assert any("embedding" in k for k in quantized) and any("kernel" in k for k in quantized)
    for k in want:
        np.testing.assert_array_equal(got[k].view(np.uint32), want[k].view(np.uint32),
                                      err_msg=k)


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["float", "int8"])
@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_artifact_matches_jax_artifact(jax_dir, tmp_path, name, quantize):
    """The port's artifact and JAX's for the same weights give the same
    forecasts on a fresh batch (cross_attn_rnn_21's float one against JAX's
    live model: three ``jax.export`` calls in all)."""
    _, task = JAX_CASES[name]
    path = str(tmp_path / "a.v2torch")
    size = export.export_forecaster(_port_model(name), _batch(task), path, quantize=quantize,
                                    quantize_min_size=64)
    fn, header = export.load_forecaster(path, device="cpu")
    got = fn(_batch(task, seed=5))
    if name == "cross_attn_rnn_21" and quantize is None:
        kw, _ = JAX_CASES[name]
        jm = jbuild(name, vocab=JVocab(*VOCAB), **kw)
        want, _ = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
            to_jax_variables(_port_model(name)), _batch(task, seed=5))
        want = np.asarray(want)
    else:
        want, jheader, _ = _jax_artifact(name, quantize, jax_dir)
        for k in ("keys", "shapes", "dtypes", "quantize", "quantized_arrays"):
            assert header.get(k) == jheader.get(k), k
    assert got.shape == want.shape and size == os.path.getsize(path)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


EVERY_MODEL = {
    **{name: (dict(output_len=12, embedding_dim=16, hidden_dim=16, image_arch="tiny",
                   vocab=VocabSizes(*VOCAB)), dict(demand=True, output_len=12))
       for name in ("gtm", "m4ft", "gated_v1", "gated_v2", "gated_v3", "gated_v4")},
    "gtm_v1": (dict(output_len=12, embedding_dim=16, hidden_dim=16, image_arch="tiny"),
               dict(demand=True, output_len=12, text_features=True)),
    "cross_attn_rnn_21": (dict(JAX_CASES["cross_attn_rnn_21"][0], vocab=VocabSizes(*VOCAB)),
                          dict(demand=False, output_len=1)),
    "cross_attn_rnn_210": (dict(out_len=10, attention_dim=12, embedding_dim=16, hidden_dim=20,
                                image_arch="tiny", use_teacher_forcing=False,
                                vocab=VocabSizes(*VOCAB)), dict(demand=False, output_len=10)),
    "cross_attn_rnn_demand": (dict(out_len=12, attention_dim=16, embedding_dim=16,
                                   hidden_dim=16, image_arch="tiny", use_teacher_forcing=False,
                                   vocab=VocabSizes(*VOCAB)), dict(demand=True, output_len=12)),
}


def test_every_registry_model_is_covered():
    assert sorted(EVERY_MODEL) == [n for n in model_names() if n != "oracle"]


@pytest.mark.parametrize("name", sorted(EVERY_MODEL))
def test_every_model_exports_and_reloads(tmp_path, name):
    kw, task = EVERY_MODEL[name]
    model = build(name, device="cpu", generator=torch.Generator().manual_seed(2), **kw)
    path = str(tmp_path / f"{name}.v2torch")
    export.export_forecaster(model, _batch(task), path, extra_header={"model": name})
    fn, header = export.load_forecaster(path, device="cpu")
    live, live_header = export.make_forecaster(model, _batch(task), device="cpu")
    assert header["registry"]["name"] == name and header["provenance"] == {"model": name}
    assert {k: header[k] for k in live_header} == live_header
    fresh = _batch(task, seed=7)
    np.testing.assert_array_equal(fn(fresh), live(fresh))


def test_dedup_artifact_round_trips(tmp_path):
    """A unique-image signature: 4 image slots feeding 8 rows by img_idx."""
    task = JAX_CASES["gated_v4"][1]
    model = _port_model("gated_v4")
    path = str(tmp_path / "dedup.v2torch")
    export.export_forecaster(model, _batch(task, image_slots=4), path)
    fn, header = export.load_forecaster(path, device="cpu")
    assert header["shapes"]["images"] == [4, IMAGE, IMAGE, 3] and "img_idx" in header["keys"]
    fresh = _batch(task, seed=9, image_slots=4)
    with torch.inference_mode():
        want = model({k: torch.from_numpy(v) for k, v in fresh.items()})[0].numpy()
    np.testing.assert_array_equal(fn(fresh), want)
    with pytest.raises(ValueError, match="shape"):  # 8 images where it has 4 slots
        fn(dict(fresh, images=np.concatenate([fresh["images"]] * 2)))


def test_each_package_refuses_the_others_artifact(jax_dir, tmp_path):
    _, _, jax_path = _jax_artifact("gated_v4", None, jax_dir)
    with pytest.raises(ValueError, match=r"visuelle2_tpu \(JAX, StableHLO\) artifact"):
        export.load_forecaster(jax_path, device="cpu")
    path = str(tmp_path / "mine.v2torch")
    export.export_forecaster(_port_model("gated_v4"), _batch(JAX_CASES["gated_v4"][1]), path)
    with pytest.raises(ValueError, match="not a visuelle2_tpu export"):
        jexport.load_forecaster(path)
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"0" * 64)
    with pytest.raises(ValueError, match="not a visuelle2_tpu_torch artifact"):
        export.load_forecaster(str(junk), device="cpu")
    # The header is JSON and the weights an npz: no pickle in the file.
    with open(path, "rb") as f:
        assert f.read(12) == export.MAGIC
        header = json.loads(f.read(int.from_bytes(f.read(8), "little")))
    assert header["registry"]["overrides"]["vocab"] == dict(zip(
        ("num_cat", "num_col", "num_fab", "num_store"), VOCAB))


def test_export_refusals(tmp_path, monkeypatch):
    model, task = _port_model("gated_v4"), JAX_CASES["gated_v4"][1]
    path = str(tmp_path / "x.v2torch")
    with pytest.raises(NotImplementedError, match="item 14"):
        export.export_forecaster(model, _batch(task), path, quantize="w8a8")
    with pytest.raises(ValueError, match="unsupported quantize"):
        export.export_forecaster(model, _batch(task), path, quantize="int4")
    with pytest.raises(ValueError, match="models.build"):
        export.export_forecaster(torch.nn.Linear(2, 2), _batch(task), path)
    assert not os.path.exists(path)
    export.export_forecaster(model, _batch(task), path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.load_forecaster(path)
    fn, _ = export.load_forecaster(path, device="cpu")
    bad = dict(_batch(task), mask=np.ones(B, np.float64))
    with pytest.raises(ValueError, match="dtype"):
        fn(bad)


# ------------------------------------------------------------------ the CLIs

SMALL = ["--device", "cpu", "--image_arch", "tiny", "--image_size", str(IMAGE),
         "--embedding_dim", "16", "--hidden_dim", "16", "--batch_size", str(B)]
FAMILIES = {"transformer": (train_transformer, forecast_transformer, ["--model", "gated_v4"]),
            "dl": (train_dl, forecast_dl, ["--attention_dim", "16"])}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("vis2")), num_train=8,
                                  num_test=20, image_size=IMAGE, rows_per_image=2)


@pytest.fixture(scope="module")
def checkpoints(dataset, tmp_path_factory):
    """One step of gated_v4 and of Demand through the train CLIs."""
    root = tmp_path_factory.mktemp("ck")
    out = {}
    for family, (train, _, flags) in FAMILIES.items():
        out[family] = str(root / family)
        with redirect_stdout(io.StringIO()):
            train.main(["--dataset_path", dataset, *SMALL, *flags, "--demand", "1",
                        "--epochs", "1", "--ckpt_dir", out[family]])
    return out


def _run(main, argv):
    """``main(argv)``'s result and its printed WAPE / MAE lines."""
    text = io.StringIO()
    with redirect_stdout(text):
        result = main(argv)
    return result, re.findall(r"^(?:WAPE|MAE): \S+$", text.getvalue(), re.M)


@pytest.mark.parametrize("quantize", ["none", "int8"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forecast_export_serves_the_scored_numbers(dataset, checkpoints, tmp_path, family,
                                                   quantize):
    """``forecast_* --ckpt_path --export`` then ``cli.serve --artifact``: the
    same printed WAPE and MAE (float), and ``cli.export`` from the
    checkpoint alone writes the same tensors."""
    _, forecast, flags = FAMILIES[family]
    art = str(tmp_path / "forecast.v2torch")
    scored, lines = _run(forecast.main, [
        "--dataset_path", dataset, "--device", "cpu", "--image_size", str(IMAGE),
        "--batch_size", str(B), "--ckpt_path", checkpoints[family], "--export", art,
        "--quantize", quantize])
    served, served_lines = _run(serve.main, ["--dataset_path", dataset, "--artifact", art,
                                             "--device", "cpu", "--image_size", str(IMAGE)])
    header, tree = export.read_artifact(art)
    assert "img_idx" in header["keys"]  # the forecast CLIs score with eval dedup
    assert header.get("quantize") == (quantize if quantize == "int8" else None)
    if quantize == "none":
        assert served_lines == lines[-2:] and len(lines) >= 2
        assert (served["wape"], served["mae"]) == (scored.wape, scored.mae)
    else:
        assert abs(served["wape"] - scored.wape) <= 0.05 * abs(scored.wape)
    name = "gated_v4" if family == "transformer" else "cross_attn_rnn_demand"
    assert header["registry"]["name"] == name
    # The dataset-free export of the same checkpoint.
    alone = str(tmp_path / "alone.v2torch")
    with redirect_stdout(io.StringIO()):
        export_cli.main(["--model", name, "--ckpt_path", checkpoints[family], "--out", alone,
                         "--vocab", "5,6,5", *SMALL, *(flags if family == "dl" else []),
                         "--quantize", quantize])
    alone_header, alone_tree = export.read_artifact(alone)
    assert "img_idx" not in alone_header["keys"]
    assert alone_header.get("quantized_arrays") == header.get("quantized_arrays")
    want, got = flatten_variables(tree), flatten_variables(alone_tree)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_serve_checks_gtm_v1_text_features(dataset, tmp_path):
    """A gtm_v1 artifact is scored on this host's text features, and one
    exported with another featurizer's is refused."""
    art = str(tmp_path / "gtm_v1.v2torch")
    scored, lines = _run(forecast_transformer.main, [
        "--dataset_path", dataset, "--model", "gtm_v1", *SMALL, "--export", art])
    header, _ = export.read_artifact(art)
    assert header["provenance"] == {"model": "gtm_v1", "text_fingerprint": "hashed-crc32-v1"}
    _, served_lines = _run(serve.main, ["--dataset_path", dataset, "--artifact", art,
                                        "--device", "cpu", "--image_size", str(IMAGE)])
    assert served_lines == lines[-2:]
    model = build("gtm_v1", device="cpu", output_len=12, embedding_dim=16, hidden_dim=16,
                  image_arch="tiny")
    other = str(tmp_path / "bert.v2torch")
    export.export_forecaster(model, _batch(dict(demand=True, output_len=12),
                                           text_features=True), other,
                             extra_header={"model": "gtm_v1",
                                           "text_fingerprint": "bert-base-uncased"})
    with pytest.raises(SystemExit, match="featurizer mismatch"):
        _run(serve.main, ["--dataset_path", dataset, "--artifact", other, "--device", "cpu",
                          "--image_size", str(IMAGE)])
