"""The port's statistical baselines on the CPU, against the JAX package:
``ops/stats.py`` (naive, SES, Holt; teacher forcing on and off; windows of
T = 2 and T = 3 … 8), ``models/oracle.py``, the Holt grid against
``jnp.linspace`` bit for bit, the grid points Holt picks against the JAX
fit's round by round, the pinned Holt constants of
``tests/test_stats_and_metrics.py``, and ``cli/forecast_stat.py`` against the
JAX CLI on a synthetic dataset.

Tolerances: naive and SES within 1e-5 of JAX; Holt within 1e-5 of the
series' largest magnitude (the scale ``tests/test_stats_and_metrics.py``
holds Holt to: its SSEs are sums XLA contracts into FMAs on the CPU, and
the least-squares solve amplifies that rounding near a zero forecast);
the recorded Holt constants within rtol 1e-4; the CLI's WAPE and MAE within
1e-5 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visuelle2_tpu.cli import forecast_stat as jforecast_stat
from visuelle2_tpu.models.oracle import Oracle as JOracle
from visuelle2_tpu.ops import stats as jstats
from visuelle2_tpu_torch.cli import forecast_stat
from visuelle2_tpu_torch.data.synthetic import make_synthetic_dataset
from visuelle2_tpu_torch.models import Oracle, build
from visuelle2_tpu_torch.ops import stats

ATOL = 1e-5
PINNED = {  # tests/test_stats_and_metrics.py: series -> _holt_fit_forecast(x, 3)
    (3., 5., 4., 7., 8., 6., 9., 11.): (11.071446, 12.059547, 13.047647),
    (10., 8., 9., 5., 6., 3.): (2.33339, 1.047698, -0.237995),
}


def _windows(T, seed, B=3, W=4):
    rng = np.random.default_rng(seed)
    return (rng.random((B, W, T)) * rng.uniform(0.5, 3.0)).astype(np.float32)


@pytest.mark.parametrize("teacher_forcing", [True, False])
@pytest.mark.parametrize("method", ["naive", "ses"])
def test_naive_and_ses_match_jax_at_every_window_length(method, teacher_forcing):
    for T in range(2, 9):
        X = _windows(T, seed=10 * T)
        want = np.asarray(JOracle(method, teacher_forcing)(X))
        got = Oracle(method, teacher_forcing, device="cpu")(X)
        assert got.dtype == torch.float32 and got.shape == want.shape, (T, got.shape)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL,
                                   err_msg=f"{method} T={T}")


def test_layouts_and_closed_forms():
    X = _windows(2, seed=1, B=2, W=5)
    t = torch.from_numpy(X)
    assert stats.naive_forecast(t, True).shape == (2, 5, 1)
    assert stats.naive_forecast(t, False).shape == (2, 5, 1)
    assert stats.ses_forecast(t, False).shape == (2, 1, 5)
    assert stats.holt_forecast(t, False).shape == (2, 1, 5)
    # Holt on 2-point windows is the exact linear extrapolation.
    np.testing.assert_allclose(stats.holt_forecast(t, True)[..., 0].numpy(),
                               2 * X[:, :, 1] - X[:, :, 0], rtol=1e-6)
    # SES of a constant series is that constant.
    flat = torch.full((1, 1, 6), 3.5)
    np.testing.assert_allclose(stats.ses_forecast(flat, True).numpy(), 3.5, rtol=1e-6)


def test_grid_is_jnp_linspace_bit_for_bit():
    rng = np.random.default_rng(2)
    lo = rng.uniform(1e-4, 1.0, 500).astype(np.float32)
    hi = np.clip(lo + rng.uniform(0.0, 0.3, 500), 1e-4, 1.0).astype(np.float32)
    lo[:2], hi[:2] = np.float32(1e-4), np.float32(1.0)  # the first round's edges
    want = np.asarray(jax.jit(jax.vmap(lambda a, b: jnp.linspace(a, b, stats.HOLT_GRID)))(
        jnp.asarray(lo), jnp.asarray(hi)))
    got = stats.linspace(torch.from_numpy(lo), torch.from_numpy(hi), stats.HOLT_GRID)
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def _jax_picks(x):
    """The grid index each round of the JAX Holt fit picks for each series of
    x [N, T], by the JAX package's own SSE: ``_holt_fit_forecast``'s loop op
    by op (vmapped over the series), as ``tests/test_stats_and_metrics.py``
    calls it (the source of the pinned constants), with the picks recorded.
    Under ``jax.jit`` XLA contracts the recursion's multiply-adds into FMAs,
    and the flat SSE near the optimum then moves the third round's pick to a
    neighbour on many series: the JAX fit itself picks differently jitted
    and op by op.  The port computes without FMAs, so it is held to the op
    by op picks, and its forecasts to the jitted fit's too."""
    G, N = stats.HOLT_GRID, x.shape[0]
    sse = jax.vmap(jax.vmap(jstats._holt_free_init_sse, in_axes=(None, 0)))
    grid = jax.vmap(lambda a, b: jnp.linspace(a, b, G))
    lo, hi = jnp.full((N, 2), 1e-4, x.dtype), jnp.ones((N, 2), x.dtype)
    picks = []
    for _ in range(stats.HOLT_ROUNDS):
        aa, bb = jax.vmap(jnp.meshgrid)(grid(lo[:, 0], hi[:, 0]), grid(lo[:, 1], hi[:, 1]))
        ab = jnp.stack([aa.reshape(N, -1), bb.reshape(N, -1)], axis=-1)
        i = jnp.argmin(sse(x, ab)[0], axis=1)
        picks.append(np.asarray(i))
        step = (hi - lo) / (G - 1)
        chosen = ab[jnp.arange(N), i]
        lo, hi = jnp.clip(chosen - step, 1e-4, 1.0), jnp.clip(chosen + step, 1e-4, 1.0)
    return np.stack(picks, 1)


@pytest.mark.parametrize("T", range(2, 9))
def test_holt_matches_jax_and_picks_its_grid_points(T):
    X = _windows(T, seed=10 * T)
    for row, series in enumerate(s for s in PINNED if len(s) == T):
        X.reshape(-1, T)[row] = series
    for teacher_forcing in (True, False):
        want = np.asarray(JOracle("holt", teacher_forcing)(X))
        got = Oracle("holt", teacher_forcing, device="cpu")(X)
        assert got.shape == want.shape, got.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL * np.abs(X).max())
    if T == 2:
        return  # the closed form: no grid
    series = X.reshape(-1, T)
    _, _, picks = stats.holt_fit(torch.from_numpy(series))
    np.testing.assert_array_equal(picks.numpy(), _jax_picks(jnp.asarray(series)))
    jitted = np.asarray(JOracle("holt", True).jitted()(X))
    np.testing.assert_allclose(Oracle("holt", True, device="cpu")(X).numpy(), jitted, rtol=0,
                               atol=ATOL * np.abs(X).max())


def test_holt_keeps_the_pinned_constants():
    for s, recorded in PINNED.items():
        got = stats.holt_fit_forecast(torch.tensor([s]), 3)[0].numpy()
        np.testing.assert_allclose(got, recorded, rtol=1e-4)


def test_oracle_is_built_on_the_device_asked(monkeypatch):
    oracle = build("oracle", device="cpu", method="ses", use_teacher_forcing=True)
    assert isinstance(oracle, Oracle) and oracle.device == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown method"):
        build("oracle", device="cpu", method="arima")
    # The card unless asked: without a CUDA device, no device is an error.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build("oracle", method="naive")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("vis2")), num_train=8,
                                  num_test=40, image_size=32, rows_per_image=4)


@pytest.mark.parametrize("teacher_forcing", ["1", "0"])
@pytest.mark.parametrize("method", ["naive", "ses", "holt"])
def test_forecast_stat_matches_the_jax_cli(dataset, method, teacher_forcing, capsys):
    argv = ["--dataset_path", dataset, "--image_size", "32", "--batch_size", "16",
            "--method", method, "--use_teacher_forcing", teacher_forcing]
    want = jforecast_stat.run(jforecast_stat.build_parser().parse_args(argv))
    got = forecast_stat.main(argv + ["--device", "cpu"])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    out = capsys.readouterr().out.splitlines()
    assert out[-2:] == [f"Results for {method}", f"{got[0]},{got[1]}"]
