"""Scoring on the CPU: the port's metrics, ``score_split``, ``dump_attention``
and the two forecast CLIs against the JAX package's.

Small sizes: tiny backbone, E = H = 16 (Demand E = A = H = 16), 32² images,
a 48 / 24-row synthetic dataset, batches of 10 (a 4-row tail).  f32
tolerance 1e-4 relative on WAPE and MAE, and 1e-4 on attention weights, as
the whole-model tests hold a forward: the port runs the same sums in
another order.
"""

import json
import math
import os
import random
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from visuelle2_tpu.data.images import ImageStore as JStore
from visuelle2_tpu.data.loader import BatchLoader as JLoader
from visuelle2_tpu.data.pipeline import load_visuelle2 as jload
from visuelle2_tpu.eval import forecast as jforecast
from visuelle2_tpu.models import VocabSizes as JVocab
from visuelle2_tpu.models import build as jbuild
from visuelle2_tpu.models import model_names as jmodel_names
from visuelle2_tpu.ops import metrics as jmetrics
from visuelle2_tpu.parallel.mesh import make_mesh
from visuelle2_tpu.train import loop as jloop
from visuelle2_tpu_torch.cli import common, forecast_dl, forecast_transformer
from visuelle2_tpu_torch.convert import load_jax_variables
from visuelle2_tpu_torch.data.images import ImageStore
from visuelle2_tpu_torch.data.loader import BatchLoader
from visuelle2_tpu_torch.data.pipeline import load_visuelle2
from visuelle2_tpu_torch.data.synthetic import make_synthetic_dataset
from visuelle2_tpu_torch.eval import forecast
from visuelle2_tpu_torch.eval.profiler import batch_flops, peak_memory_bytes
from visuelle2_tpu_torch.models import VocabSizes, build, model_names
from visuelle2_tpu_torch.ops import metrics
from visuelle2_tpu_torch.train import loop
from visuelle2_tpu_torch.utils.seeding import seed_everything

RTOL = 1e-4
BATCH = 10
MODELS = {
    "gated_v4": dict(output_len=12, embedding_dim=16, hidden_dim=16),
    "cross_attn_rnn_demand": dict(out_len=12, embedding_dim=16, hidden_dim=16,
                                  attention_dim=16),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one CPU thread: the suite runs several workers on the same
    cores, and eight threads a worker oversubscribe them many times over
    (the small forwards here then ran 60x slower than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("vis2")), num_train=48,
                                  num_test=24, image_size=32, rows_per_image=3)


def _port_loader(path, batch_size=BATCH, **kw):
    arrays = load_visuelle2(path, "test", demand=True, output_len=12)
    store = ImageStore.build(path + "/images", arrays.image_paths, size=32)
    return BatchLoader(arrays, store, batch_size, **kw)


def _jax_loader(path, **kw):
    arrays = jload(path, "test", demand=True, output_len=12)
    store = JStore.build(path + "/images", arrays.image_paths, size=32)
    return JLoader(arrays, store, BATCH, native_prefetch=False, **kw)


@pytest.fixture(scope="module")
def converted(dataset):
    """name -> (JAX model, its variables, the port model with those weights)."""
    out = {}
    batch = next(iter(_jax_loader(dataset)))
    for name, dims in MODELS.items():
        extra = {"use_teacher_forcing": False} if "cross" in name else {}
        jm = jbuild(name, vocab=JVocab(5, 6, 5, 126), image_arch="tiny", **dims, **extra)
        # One compiled init: an eager one dispatches op by op, three times slower.
        init = jax.jit(lambda b, jm=jm: jm.init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)}, b, train=False))
        variables = jax.tree_util.tree_map(np.array, init(batch))
        tm = build(name, device="cpu", vocab=VocabSizes(5, 6, 5, 126), image_arch="tiny",
                   **dims)
        out[name] = (jm, variables, load_jax_variables(tm, variables))
    return out


def _close(got, want):
    assert math.isfinite(got) and abs(got - want) <= RTOL * abs(want), (got, want)


# -- metrics and target alignment ---------------------------------------------------

@pytest.mark.parametrize("case", ["golden", "random"])
def test_metrics_match_jax(case):
    rng = np.random.default_rng(4)
    if case == "golden":
        gt = np.array([[1.0, 2.0], [3.0, 4.0], [9.0, 9.0]], np.float32)
        pred = np.array([[1.0, 1.0], [3.0, 5.0], [0.0, 0.0]], np.float32)
        mask = np.array([1.0, 1.0, 0.0], np.float32)
    else:
        gt = rng.random((37, 12)).astype(np.float32)
        pred = rng.random((37, 12)).astype(np.float32)
        mask = (rng.random(37) < 0.8).astype(np.float32)
    assert metrics.calc_error_metrics(gt, pred) == jmetrics.calc_error_metrics(gt, pred)
    t = lambda a: torch.from_numpy(a)
    for fn in ("mae", "wape"):
        np.testing.assert_allclose(float(getattr(metrics, fn)(t(gt[0]), t(pred[0]), 53.0)),
                                   float(getattr(jmetrics, fn)(gt[0], pred[0], 53.0)),
                                   rtol=1e-6)
    for m in (mask, None):
        got = metrics.eval_metrics(t(gt), t(pred), None if m is None else t(m))
        want = jmetrics.eval_metrics(jnp.asarray(gt), jnp.asarray(pred),
                                     None if m is None else jnp.asarray(m))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
        assert metrics.finalize_metrics(got) == pytest.approx(
            jmetrics.finalize_metrics({k: float(v) for k, v in want.items()}), rel=1e-6)
    if case == "golden":
        out = metrics.finalize_metrics(metrics.eval_metrics(t(gt), t(pred), t(mask)))
        assert out["mae"] == pytest.approx(53.0 * 2.0 / 4)
        assert out["wape"] == pytest.approx(100 * 2.0 / 10.0)


@pytest.mark.parametrize("kind", ["stfore", "demand", "demand_3d", "no_mask"])
def test_target_and_pred_and_expand_mask_match_jax(kind):
    rng = np.random.default_rng(2)
    B = 4
    if kind == "stfore":
        batch = {"X": rng.random((B, 3, 2)), "y": rng.random((B, 3, 5))}
        f = rng.random((B * 3, 5))
    else:
        batch = {"ts": rng.random((B, 12))}
        f = rng.random((B, 12, 1) if kind == "demand_3d" else (B, 12))
    if kind != "no_mask":
        batch["mask"] = np.array([1.0, 1.0, 1.0, 0.0])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = loop.target_and_pred(tb, torch.from_numpy(f))
    want = jloop.target_and_pred(batch, f)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(loop.expand_mask(tb, got[0]).numpy(),
                                  np.asarray(jloop.expand_mask(batch, jnp.asarray(want[0]))))


# -- score_split ----------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODELS))
def test_score_split_matches_jax(dataset, converted, name):
    """Converted weights, the same split: WAPE and MAE within 1e-4 relative,
    the same row count; the dedup loader gives the same metrics."""
    jm, variables, tm = converted[name]
    want = jforecast.score_split(jm, variables, _jax_loader(dataset),
                                 mesh=make_mesh(data=1, model=1, devices=jax.devices()[:1]),
                                 measure_throughput=False, one_pass=False)
    results = [forecast.score_split(tm, _port_loader(dataset, dedup_images=dedup),
                                    measure_throughput=False) for dedup in (False, True)]
    for got in results:
        assert got.num_forecasts == want.num_forecasts == 24
        _close(got.wape, want.wape)
        _close(got.mae, want.mae)
        assert got.gflops_per_sample > 0 and got.peak_hbm_bytes is None
    # Dedup encodes each photo once (3 rows a photo): fewer backbone FLOPs.
    assert results[1].gflops_per_sample < results[0].gflops_per_sample


def test_score_split_one_pass_and_its_auto_rail(dataset, converted):
    tm = converted["gated_v4"][2]
    loader = _port_loader(dataset)
    r_batch = forecast.score_split(tm, loader, one_pass=False, timing_iters=3)
    r_one = forecast.score_split(tm, loader, one_pass=True, timing_iters=3)
    assert (r_batch.one_pass, r_one.one_pass) == (False, True)
    assert abs(r_one.wape - r_batch.wape) < 1e-3 and abs(r_one.mae - r_batch.mae) < 1e-4
    for r in (r_batch, r_one):
        assert r.forecasts_per_sec > 0 and r.forecasts_per_sec == r.forecasts_per_sec_per_chip
        assert len(r.forecasts_per_sec_windows) == forecast.TIMING_WINDOWS
        assert r.split_seconds > 0
        # The flop probe (the memory probe runs on the card only), one
        # forward a batch, the warm-up and the timed windows.
        assert r.forwards == 1 + len(loader) + 3 + forecast.TIMING_WINDOWS * 3
    auto = forecast.score_split(tm, loader, measure_throughput=False)
    assert auto.one_pass and auto.wape == r_one.wape
    with mock.patch.object(forecast, "one_pass_budget_bytes", lambda device: 1):
        fallback = forecast.score_split(tm, loader, measure_throughput=False)
    assert not fallback.one_pass and fallback.wape == r_batch.wape
    assert forecast.one_pass_budget_bytes(torch.device("cpu")) > 0


def test_score_split_rejects_an_empty_split(dataset, converted):
    empty = _port_loader(dataset, batch_size=100, drop_remainder=True)
    with pytest.raises(ValueError, match="zero batches"):
        forecast.score_split(converted["gated_v4"][2], empty)


def test_summary_and_profiler_match_jax_conventions(dataset, converted):
    kw = dict(wape=12.3456, mae=0.98765, num_forecasts=24, forecasts_per_sec=1234.5,
              forecasts_per_sec_per_chip=1234.5, gflops_per_sample=28.2, peak_hbm_bytes=3 << 30)
    assert forecast.ForecastResult(**kw).summary() == jforecast.ForecastResult(**kw).summary()
    tm = converted["gated_v4"][2]
    batch = next(iter(_port_loader(dataset)))
    assert batch_flops(tm, batch) > 0 and peak_memory_bytes(tm, batch) is None


def test_dump_attention_matches_jax(dataset, converted, tmp_path):
    """Demand's per-step alphas: the JAX tree-path keys, the same values."""
    jm, variables, tm = converted["cross_attn_rnn_demand"]
    jbatch = next(iter(_jax_loader(dataset)))
    keys = forecast.dump_attention(tm, next(iter(_port_loader(dataset))),
                                   str(tmp_path / "p.npz"))
    want_keys = jforecast.dump_attention(jm, variables, jbatch, str(tmp_path / "j.npz"))
    assert keys == want_keys == ["img", "multimodal", "trend"]
    with np.load(tmp_path / "p.npz") as got, np.load(tmp_path / "j.npz") as want:
        for k in keys:
            assert got[k].shape == want[k].shape and got[k].shape[:2] == (12, BATCH)
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0)
    assert forecast.dump_attention(converted["gated_v4"][2], next(iter(_port_loader(dataset))),
                                   str(tmp_path / "none.npz")) is None


# -- the CLIs -------------------------------------------------------------------------

SMALL = ["--device", "cpu", "--image_arch", "tiny", "--image_size", "32", "--batch_size",
         str(BATCH), "--embedding_dim", "16", "--hidden_dim", "16"]


def test_forecast_transformer_run(dataset, tmp_path, capsys):
    out = tmp_path / "m.json"
    args = forecast_transformer.build_parser().parse_args(
        ["--dataset_path", dataset, "--model", "gated_v4", "--demand", "1", "--output_len",
         "12", "--num_layers", "1", "--metrics_out", str(out), "--one_pass", "1",
         "--dump_attention", str(tmp_path / "a.npz"), *SMALL])
    assert (args.dedup_images, args.num_hidden_layers) == (1, 1)
    result = forecast_transformer.run(args)
    written = json.loads(out.read_text())
    assert sorted(written) == ["forecasts_per_sec_per_chip", "gflops_per_sample", "mae",
                               "num_forecasts", "peak_hbm_bytes", "wape"]
    assert written["num_forecasts"] == 24 and written["wape"] == result.wape
    assert all(math.isfinite(written[k]) for k in ("wape", "mae", "gflops_per_sample",
                                                   "forecasts_per_sec_per_chip"))
    text = capsys.readouterr().out
    assert f"WAPE: {result.wape}" in text and "model returns no attention aux" in text
    assert not (tmp_path / "a.npz").exists()
    # The same seed draws the same model: dedup and one-pass change nothing.
    again = forecast_transformer.main(
        ["--dataset_path", dataset, "--model", "gated_v4", "--dedup_images", "0",
         "--one_pass", "0", *SMALL])
    assert abs(again.wape - result.wape) < 1e-3 and abs(again.mae - result.mae) < 1e-4


def test_forecast_dl_run_dumps_demand_attention(dataset, tmp_path, capsys):
    result = forecast_dl.main(["--dataset_path", dataset, "--new_product", "1",
                               "--attention_dim", "16", "--dump_attention",
                               str(tmp_path / "a.npz"), *SMALL])
    assert result.num_forecasts == 24 and math.isfinite(result.wape)
    with np.load(tmp_path / "a.npz") as z:
        assert sorted(z) == ["img", "multimodal", "trend"]
        assert z["trend"].shape == (12, BATCH, 52) and z["img"].shape == (12, BATCH, 1)
    assert f"GFLOPS: {result.gflops_per_sample}" in capsys.readouterr().out


@pytest.mark.parametrize("task_mode,new_product,output_len,want", [
    (0, 1, 1, 12), (1, 0, 1, 10), (0, 0, 1, 1), (1, 0, 4, 4)])
def test_forecast_dl_horizon(task_mode, new_product, output_len, want):
    args = forecast_dl.build_parser().parse_args(
        ["--task_mode", str(task_mode), "--new_product", str(new_product),
         "--output_len", str(output_len)])
    assert forecast_dl.output_len_of(args) == want


@pytest.mark.parametrize("cli", ["transformer", "dl"])
@pytest.mark.parametrize("flags,match", [  # ids as when these cases raised
    (["--ckpt_path", "x"], "item 8"),
    pytest.param(["--quantize", "w8a8"], "[w8a8] int8 backbone", id="flags1-14"),
    pytest.param(["--quantize", "auto"], "[quantize auto]", id="flags2-14")])
def test_flags_not_ported_yet_raise(dataset, cli, flags, match, capsys):
    """Every flag here is ported now: a missing checkpoint directory is an
    error of its own; ``--quantize w8a8`` scores with the int8 backbone
    (calibrated on the test split's first batches) and ``auto`` picks the
    float path for the tiny test backbone, each saying so."""
    main = forecast_transformer.main if cli == "transformer" else forecast_dl.main
    if flags[0] == "--ckpt_path":
        with pytest.raises(FileNotFoundError, match="no such checkpoint directory"):
            main(["--dataset_path", dataset, *flags, *SMALL])
        return
    result = main(["--dataset_path", dataset, *flags, *SMALL])
    assert result.num_forecasts > 0 and np.isfinite([result.wape, result.mae]).all()
    out = capsys.readouterr().out
    assert match in out
    if flags[1] == "auto":
        assert "-> float path" in out


def test_cli_device_rules(dataset, monkeypatch):
    with pytest.raises(SystemExit, match="demand-only"):
        forecast_transformer.main(["--dataset_path", dataset, "--model", "gtm_v1",
                                   "--demand", "0", *SMALL])
    # gtm_v1 scores on the CPU when asked, on the ingest-time text features.
    r = forecast_transformer.main(["--dataset_path", dataset, "--model", "gtm_v1", *SMALL])
    assert r.num_forecasts == 24 and np.isfinite([r.wape, r.mae]).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = forecast_dl.build_parser().parse_args(["--gpu_num", "1"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.resolve_cli_device(args)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert common.resolve_cli_device(args) == torch.device("cuda:1")
    assert common.resolve_quantize(forecast_dl.build_parser().parse_args(
        ["--quantize", "none"])) == ""


def test_build_loaders_and_logger(dataset, tmp_path):
    args = forecast_dl.build_parser().parse_args(["--dataset_path", dataset, *SMALL])
    loaders, vocab, norm = common.build_loaders(args, demand=True, output_len=12,
                                                splits=("test",), dedup_eval_images=True)
    assert (vocab, norm) == (VocabSizes(5, 6, 5, 126), 53.0)
    assert loaders["test"].dedup_images and loaders["test"].image_slots == 4
    assert os.path.isfile(ImageStore.cache_path(dataset, "test", 32))
    # The train loader's grouped sampler (ported with the data plane).
    train = common.build_loaders(args, demand=True, output_len=12,
                                 dedup_train_images=True)[0]["train"]
    assert train.shuffle and train.dedup_images and train.unique_image_slots > 0
    log = common.JsonlLogger(str(tmp_path / "log" / "m.jsonl"))
    log({"wape": np.float32(1.5), "epoch": 2, "note": "x"})
    log.close()
    assert json.loads((tmp_path / "log" / "m.jsonl").read_text()) == \
        {"wape": 1.5, "epoch": 2.0, "note": "x"}


def test_model_names_and_seeding_match_jax():
    assert model_names() == jmodel_names()
    kw = dict(device="cpu", image_arch="tiny", embedding_dim=16, hidden_dim=16)
    a = build("gated_v4", generator=seed_everything(3), **kw)
    b = build("gated_v4", generator=seed_everything(3), **kw)
    c = build("gated_v4", generator=seed_everything(4), **kw)
    pa, pb, pc = (torch.cat([p.flatten() for p in m.parameters()]) for m in (a, b, c))
    assert torch.equal(pa, pb) and not torch.equal(pa, pc)
    draws = []
    for _ in range(2):
        seed_everything(5)
        draws.append((random.random(), np.random.rand(), torch.rand(1).item()))
    assert draws[0] == draws[1]
