"""The port's data path on the CPU against the JAX package's: the pipeline
functions on the same numpy inputs, whole datasets written by either
generator and read by either pipeline, the image store and its cache, and
the batch loader key by key.

Every comparison is exact (arrays equal, dtypes equal): the port's numpy
pipeline must produce the JAX pipeline's arrays bit for bit from the same
files.  Small sizes: 48 / 24 rows, 32² images.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from visuelle2_tpu.data import pipeline as jp
from visuelle2_tpu.data.images import ImageStore as JStore
from visuelle2_tpu.data.loader import BatchLoader as JLoader
from visuelle2_tpu.data.synthetic import make_synthetic_dataset as jmake
from visuelle2_tpu_torch.data import pipeline as pp
from visuelle2_tpu_torch.data.images import ImageStore
from visuelle2_tpu_torch.data.loader import BatchLoader
from visuelle2_tpu_torch.data.synthetic import make_synthetic_dataset, weekly_mondays

ARRAY_KEYS = ("cat", "col", "fab", "store", "temporal", "gtrends", "X", "y", "ts",
              "split_idx")
LOADS = [("train", False, 1), ("train", False, 10), ("test", True, 12)]


def _assert_same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _assert_same_arrays(got, want):
    assert (got.demand, got.output_len) == (want.demand, want.output_len)
    for k in ARRAY_KEYS:
        g, w = getattr(got, k), getattr(want, k)
        assert (g is None) == (w is None), k
        if g is not None:
            _assert_same(g, w)
    assert got.image_paths.dtype == want.image_paths.dtype
    assert list(got.image_paths) == list(want.image_paths)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """One dataset written by each generator from the same seed and sizes."""
    root = tmp_path_factory.mktemp("data")
    kw = dict(num_train=48, num_test=24, image_size=32, seed=3, rows_per_image=2)
    return {"port": make_synthetic_dataset(str(root / "port"), **kw),
            "jax": jmake(str(root / "jax"), **kw)}


# -- pipeline functions on the same numpy inputs ------------------------------------

def _trend_frame(n, cols, start="2016-01-04"):
    dates = pd.date_range(start, periods=n, freq="W-MON")
    data = {c: f(np.arange(n, dtype=np.float64)) for c, f in cols.items()}
    return pd.DataFrame(data, index=dates)


def _trend_table(frame):
    return (frame.index.values.astype("datetime64[D]"),
            {c: frame[c].to_numpy(np.float64) for c in frame.columns})


@pytest.mark.parametrize("case", ["ramp_constant_sine", "short_history", "late_release",
                                  "exact_week_bounds", "random"])
def test_extract_gtrends_matches_jax(case):
    rng = np.random.default_rng(7)
    frame = _trend_frame(200, {"catA": lambda t: t, "colB": lambda t: 5.0 + 0 * t,
                               "fabC": np.sin, "catD": lambda t: rng.normal(50, 9, t.shape)})
    releases = {
        "ramp_constant_sine": [frame.index[100], frame.index[60]],
        "short_history": [frame.index[30], frame.index[3], frame.index[0]],
        "late_release": [frame.index[199] + pd.Timedelta(days=40)],
        # A release 364 days after an index date: both ends fall on dates.
        "exact_week_bounds": [frame.index[52], frame.index[53] + pd.Timedelta(days=1)],
        "random": list(frame.index[rng.integers(0, 200, 40)]
                       + pd.to_timedelta(rng.integers(0, 7, 40), "D")),
    }[case]
    n = len(releases)
    cats = rng.choice(["catA", "catD"], n)
    df = pd.DataFrame({"category": cats, "color": ["colB"] * n,
                       "fabric": rng.choice(["fabC", "catA"], n),
                       "release_date": pd.DatetimeIndex(releases)})
    want = jp.extract_gtrends(df, frame)
    index, trends = _trend_table(frame)
    names = df[["category", "color", "fabric"]].to_numpy()
    got = pp.extract_gtrends(df["release_date"].values.astype("datetime64[D]"), names,
                             index, trends)
    _assert_same(got, want)


def test_minmax_rows_stays_float32_and_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(0, 3, (6, 3, 52)).astype(np.float32)
    a[0, 1] = 2.5  # a constant row maps to 0
    a[2, 0, 30:] = 0.0
    _assert_same(pp._minmax_rows(a), jp._minmax_rows(a))
    assert pp._minmax_rows(a).dtype == np.float32


@pytest.mark.parametrize("dates", [
    ["2017-03-06", "2018-12-31"],
    # ISO week edge cases: 2016-01-03 is week 53 of 2015, 2018-12-31 week 1 of 2019.
    ["2016-01-03", "2015-12-28", "2020-12-31", "2021-01-04", "2019-06-03"],
])
def test_temporal_features_match_jax(dates):
    want = jp.temporal_features_from_dates(pd.Series(pd.to_datetime(dates)))
    got = pp.temporal_features_from_dates(np.array(dates, "datetime64[D]"))
    _assert_same(got, want)


@pytest.mark.parametrize("fn", ["clean", "frame1", "frame10", "encode"])
def test_pipeline_function_matches_jax(fn):
    rng = np.random.default_rng(21)
    sales = rng.integers(0, 10, size=(50, 12)).astype(float)
    restocks = rng.integers(5, 60, size=50).astype(float)
    if fn == "clean":
        for g, w in zip(pp.clean_restocked_sales(restocks, sales),
                        jp.clean_restocked_sales(restocks, sales)):
            _assert_same(g, w)
    elif fn.startswith("frame"):
        h = int(fn[5:])
        series = rng.random((7, 12))
        for g, w in zip(pp.frame_series(series, forecast_horizon=h),
                        jp.frame_series(series, forecast_horizon=h)):
            _assert_same(g, w)
    else:
        dicts = ({"a": 0, "b": 1}, {"x": 2, "y": 0}, {"s": 3})
        table = {"category": np.array(["a", "b", "a"], object),
                 "color": np.array(["y", "x", "x"], object),
                 "fabric": np.array(["s", "s", "s"], object),
                 "retail": np.array([3.0, 124.0, 0.0])}
        df = pd.DataFrame({**table, "retail": [3, 124, 0]})
        for g, w in zip(pp.encode_attributes(table, *dicts), jp.encode_attributes(df, *dicts)):
            _assert_same(g, w)


@pytest.mark.parametrize("demand,output_len", [(False, 1), (True, 12)])
def test_preprocess_rows_matches_preprocess_dataframe(demand, output_len):
    """Windows frame the restock-cleaned series; Demand's ts is the raw last
    12 columns, a float64 -> float32 cast."""
    frame = _trend_frame(200, {"c": lambda t: t, "k": np.cos, "f": np.sqrt},
                         start="2015-01-05")
    sales = np.arange(1, 13, dtype=float) / 53.0
    df = pd.DataFrame({"image_path": ["x.jpg", "y.jpg"], "category": ["c", "k"],
                       "color": ["k", "k"], "fabric": ["f", "c"], "retail": [3, 7],
                       "release_date": pd.to_datetime([frame.index[150], frame.index[40]]),
                       "restock": [10.0 / 53.0, 100.0]})
    for w in range(12):
        df[f"w{w}"] = [sales[w], sales[11 - w]]
    dicts = ({"c": 0, "k": 1}, {"k": 0}, {"f": 0, "c": 1})
    want = jp.preprocess_dataframe(df, frame, *dicts, demand=demand, output_len=output_len)
    table = {c: (df[c].values.astype("datetime64[D]") if c == "release_date"
                 else df[c].to_numpy(np.float64) if df[c].dtype.kind in "if"
                 else df[c].to_numpy(object)) for c in df.columns}
    got = pp.preprocess_rows(table, *_trend_table(frame), *dicts, demand=demand,
                             output_len=output_len)
    _assert_same_arrays(got, want)
    if not demand:
        assert got.split_idx[0] == 4  # 1+2+3+4+5 > 10 from week 5 on


def test_parse_float_reads_numbers_as_pandas_does():
    """pandas' C parser keeps 17 digits, leading zeros included: its float64
    differs from Python's ``float`` for many 17-digit texts (and then a
    restock comparison can flip); the port parses as pandas does."""
    import io

    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.normal(0, 1, 4000), rng.normal(0, 1e6, 1000),
                           rng.random(1000) * 1e-5, rng.gamma(2, 6, 2000) / 53,
                           np.arange(-3, 60) / 53.0])
    texts = ([repr(float(v)) for v in vals] + [f"{v:.6f}" for v in vals[:500]]
             + [f"{v:.20g}" for v in vals[:500]] + [f"{v:e}" for v in vals[:500]]
             + ["7", "-0", "+12.5", "1e300", "123456789012345678901", "5.", ".25",
                "-.5e-3", " 3.25 ", "1E5", "0.000000000000000000001234"])
    want = pd.read_csv(io.StringIO("x\n" + "\n".join(texts) + "\n"))["x"].to_numpy(np.float64)
    got = np.array([pp.parse_float(t) for t in texts])
    _assert_same(got, want)
    assert (got != np.array([float(t) for t in texts])).any()
    for bad in ("abc", "1e", "1.2.3", "--1", "."):
        with pytest.raises(ValueError):
            pp.parse_float(bad)


# -- whole datasets: either writer, either reader -------------------------------------

def test_weekly_mondays_match_pandas():
    _assert_same(weekly_mondays("2017-01-02", "2019-06-03"),
                 pd.date_range("2017-01-02", "2019-06-03", freq="W-MON")
                 .values.astype("datetime64[D]"))
    _assert_same(weekly_mondays("2015-01-05", periods=320),
                 pd.date_range("2015-01-05", periods=320, freq="W-MON")
                 .values.astype("datetime64[D]"))


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("split,demand,output_len", LOADS)
def test_load_visuelle2_matches_jax(datasets, writer, split, demand, output_len):
    path = datasets[writer]
    got = pp.load_visuelle2(path, split, demand=demand, output_len=output_len,
                            use_cache=False)
    want = jp.load_visuelle2(path, split, demand=demand, output_len=output_len,
                             use_cache=False)
    _assert_same_arrays(got, want)
    # Both generators drew the same numbers from the same seed.
    other = datasets["jax" if writer == "port" else "port"]
    _assert_same_arrays(got, pp.load_visuelle2(other, split, demand=demand,
                                               output_len=output_len, use_cache=False))


def test_synthetic_side_files_match_jax(datasets):
    assert pp.load_label_dicts(datasets["port"]) == jp.load_label_dicts(datasets["jax"])
    assert pp.load_norm_scalar(datasets["port"]) == jp.load_norm_scalar(datasets["jax"]) == 53.0
    assert sorted(os.listdir(os.path.join(datasets["port"], "images"))) == \
        sorted(os.listdir(os.path.join(datasets["jax"], "images")))


@pytest.mark.parametrize("first,second", [("port", "jax"), ("jax", "port")])
def test_arrays_cache_is_shared_with_jax(tmp_path, first, second):
    """Either package reads the other's ``.npz`` arrays cache (same file name
    and keys); a corrupt cache is rebuilt; a cached Demand load returns the
    requested horizon."""
    path = make_synthetic_dataset(str(tmp_path / "d"), num_train=8, num_test=6,
                                  image_size=8, write_images=False)
    load = {"port": pp.load_visuelle2, "jax": jp.load_visuelle2}
    made = load[first](path, "train", demand=False, output_len=1)
    cache = os.path.join(path, pp._cache_key("train", False, 1, 52))
    assert pp._cache_key("train", False, 1, 52) == jp._cache_key("train", False, 1, 52)
    assert os.path.isfile(cache)
    stamp = os.stat(cache).st_mtime_ns
    read = load[second](path, "train", demand=False, output_len=1)
    assert os.stat(cache).st_mtime_ns == stamp  # read, not rewritten
    _assert_same_arrays(read, made)
    with open(cache, "wb") as f:
        f.write(b"PK\x03\x04 truncated garbage")
    _assert_same_arrays(load[second](path, "train", demand=False, output_len=1), made)
    d12 = load[second](path, "test", demand=True, output_len=12)
    d6 = load[second](path, "test", demand=True, output_len=6)
    assert (d12.output_len, d6.output_len) == (12, 6)
    _assert_same(d6.ts, d12.ts)


# -- the image store ------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_image_store_build_matches_jax(datasets, writer, tmp_path):
    path = datasets[writer]
    arrays = pp.load_visuelle2(path, "train", demand=False, output_len=1, use_cache=False)
    cache_p, cache_j = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    got = ImageStore.build(path + "/images", arrays.image_paths, cache_file=cache_p, size=32)
    want = JStore.build(path + "/images", arrays.image_paths, cache_file=cache_j, size=32)
    _assert_same(got.pixels, want.pixels)
    _assert_same(got.row_to_img, want.row_to_img)
    assert got.pixels.shape[0] == len(arrays) // 2 and len(got) == len(arrays)
    _assert_same(got.gather([5, 0, 5]), want.gather([5, 0, 5]))
    # Each package's cache is valid for the other.
    for build, cache in ((ImageStore.build, cache_j), (JStore.build, cache_p)):
        stamp = os.stat(cache).st_mtime_ns
        other = build("/nonexistent", arrays.image_paths, cache_file=cache, size=32)
        assert os.stat(cache).st_mtime_ns == stamp
        _assert_same(other.pixels, want.pixels)
    assert ImageStore.cache_path(path, "train", 32) == JStore.cache_path(path, "train", 32)


def test_image_cache_invalidation_rebuilds(datasets, tmp_path):
    """A cache of another row subset, another size, or a truncated file is
    rebuilt, never served."""
    path = datasets["port"]
    arrays = pp.load_visuelle2(path, "train", demand=False, output_len=1, use_cache=False)
    cache, root = str(tmp_path / "imgs.npz"), path + "/images"
    sub = ImageStore.build(root, arrays.image_paths[:8], cache_file=cache, size=32)
    assert len(sub) == 8
    full = ImageStore.build(root, arrays.image_paths, cache_file=cache, size=32)
    assert len(full) == len(arrays)
    small = ImageStore.build(root, arrays.image_paths, cache_file=cache, size=16)
    assert small.pixels.shape[1] == 16
    with open(cache, "r+b") as f:
        f.truncate(os.path.getsize(cache) // 2)
    again = ImageStore.build(root, arrays.image_paths, cache_file=cache, size=32)
    _assert_same(again.pixels, full.pixels)
    # The rebuilt cache is whole again, and is what the JAX store reads.
    _assert_same(JStore.build("/nonexistent", arrays.image_paths, cache_file=cache,
                              size=32).pixels, full.pixels)
    with pytest.raises(ValueError, match="stale image cache"):
        BatchLoader(arrays, sub, batch_size=16)


def test_cache_written_from_numpy_is_read_without_decoding(tmp_path):
    """A store cache written from numpy pixels (no JPEG) is served as is:
    the path the card's machine, which has no PIL, takes."""
    path = make_synthetic_dataset(str(tmp_path / "d"), num_train=8, num_test=10,
                                  image_size=8, write_images=False, rows_per_image=4)
    arrays = pp.load_visuelle2(path, "test", demand=True, output_len=12)
    unique, row_to_img = ImageStore.unique_paths(arrays.image_paths)
    assert len(unique) == 3
    pixels = np.random.default_rng(0).integers(0, 256, (3, 8, 8, 3), dtype=np.uint8)
    cache = ImageStore.cache_path(path, "test", 8)
    ImageStore(pixels, row_to_img).write_cache(cache, arrays.image_paths)
    for build in (ImageStore.build, JStore.build):
        store = build(os.path.join(path, "images"), arrays.image_paths, cache_file=cache,
                      size=8)
        _assert_same(store.pixels, pixels)
        _assert_same(store.gather(np.arange(10)), pixels[row_to_img])


# -- the batch loader -----------------------------------------------------------------

def _loaders(datasets, demand, batch_size, **kw):
    path = datasets["jax"]
    h = 12 if demand else 1
    split = "test" if demand else "train"
    arrays = pp.load_visuelle2(path, split, demand=demand, output_len=h, use_cache=False)
    jarrays = jp.load_visuelle2(path, split, demand=demand, output_len=h, use_cache=False)
    store = ImageStore.build(path + "/images", arrays.image_paths, size=32)
    jstore = JStore.build(path + "/images", jarrays.image_paths, size=32)
    extras = kw.pop("extras", None)
    return (BatchLoader(arrays, store, batch_size, extras=extras, **kw),
            JLoader(jarrays, jstore, batch_size, native_prefetch=False, extras=extras, **kw))


LOADER_CASES = {
    "eval_tail": dict(demand=True, batch_size=10),
    "stfore_tail": dict(demand=False, batch_size=20),
    "shuffle": dict(demand=False, batch_size=16, shuffle=True, seed=5),
    "drop_remainder": dict(demand=False, batch_size=20, shuffle=True,
                           drop_remainder=True),
    "dedup": dict(demand=True, batch_size=10, dedup_images=True),
    "dedup_slots": dict(demand=True, batch_size=7, dedup_images=True, image_slots=6),
    "dedup_stfore": dict(demand=False, batch_size=16, dedup_images=True),
    "extras": dict(demand=True, batch_size=10,
                   extras={"text_features": np.arange(24 * 3, dtype=np.float32)
                           .reshape(24, 3)}),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_batch_loader_matches_jax(datasets, case):
    kw = dict(LOADER_CASES[case])
    port, ref = _loaders(datasets, kw.pop("demand"), kw.pop("batch_size"), **kw)
    assert len(port) == len(ref)
    assert port.image_slots == ref.image_slots
    epochs = 2 if port.shuffle else 1
    for epoch in range(epochs):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port) and want
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
                _assert_same(g[k].numpy(), np.asarray(w[k]))
    if port.shuffle:  # set_epoch pins the order, as in JAX
        port.set_epoch(0)
        ref.set_epoch(0)
        _assert_same(next(iter(port))["cat"].numpy(), next(iter(ref))["cat"])


def test_shuffled_dedup_waits_for_the_grouped_sampler(datasets):
    with pytest.raises(NotImplementedError, match="item 11"):
        _loaders(datasets, False, 16, shuffle=True, dedup_images=True)


@pytest.mark.cuda
def test_loader_pins_batches_for_a_cuda_target(datasets):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    port, _ = _loaders(datasets, True, 10, pin_memory=True)
    assert all(t.is_pinned() for t in next(iter(port)).values())


def test_chip_check_split_matches_jax(tmp_path):
    """The split the card check scores (1,000 test rows, 4 rows a photo,
    seed 0, no JPEGs) reads the same through both pipelines: 13,000 parsed
    sales figures and 1,000 trend windows."""
    path = make_synthetic_dataset(str(tmp_path / "d"), num_train=0, num_test=1000,
                                  write_images=False, rows_per_image=4, seed=0)
    for demand, h in ((True, 12), (False, 1)):
        _assert_same_arrays(
            pp.load_visuelle2(path, "test", demand=demand, output_len=h, use_cache=False),
            jp.load_visuelle2(path, "test", demand=demand, output_len=h, use_cache=False))
