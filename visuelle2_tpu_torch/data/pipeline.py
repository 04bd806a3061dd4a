"""VISUELLE-2 data pipeline on numpy, counterpart of
``visuelle2_tpu/data/pipeline.py``.

The same arrays, bit for bit, from the same dataset directory, with ``csv``,
``json``, ``datetime`` and numpy only: the card's machine has no pandas.
Where the JAX module works on a DataFrame this one works on a *table*, a
dict of column name -> 1-D numpy array in the file's column order
(``read_csv_table``).  What pandas does implicitly is kept explicit:

* every number is parsed to float64 first (``ts`` is then a float64 ->
  float32 cast, not a direct float32 parse, which can round differently),
  and parsed as pandas' C parser parses it (``parse_float``), which is not
  Python's ``float``: it keeps 17 digits, leading zeros included;
* dates are ``datetime64[D]``; ``release - 52 weeks`` is 364 days;
* ``.loc[a:b]`` on the date index is inclusive at both ends
  (``searchsorted`` left at ``a``, right at ``b``).

On-disk contract and array layout: as the JAX module's docstring gives them
(``X [N, W, 2]``, ``y [N, W, H]``, ``cat/col/fab/store [N]`` int32,
``temporal [N, 4]``, ``gtrends [N, 3, 52]``; Demand: ``ts [N, 12]``).
"""

from __future__ import annotations

import csv
import dataclasses
import datetime
import json
import os
import pickle
import zipfile
from typing import Dict, Optional

import numpy as np

TRAIN_WINDOW = 2
NUM_SALES_WEEKS = 12
DEFAULT_TREND_LEN = 52
DEFAULT_NORM_SCALAR = 53.0
TREND_LOOKBACK_DAYS = 7 * 52  # pd.DateOffset(weeks=52)

Table = Dict[str, np.ndarray]
# What ``np.load`` raises on a truncated, corrupt or foreign cache file.
CACHE_READ_ERRORS = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile,
                     pickle.UnpicklingError)


@dataclasses.dataclass
class Visuelle2Arrays:
    """The preprocessed split as host numpy arrays.

    ``X``/``y`` are None for the demand task; ``ts`` is None for stfore.
    ``image_paths`` index into the image store (see images.py).
    """

    demand: bool
    output_len: int
    cat: np.ndarray
    col: np.ndarray
    fab: np.ndarray
    store: np.ndarray
    temporal: np.ndarray
    gtrends: np.ndarray
    image_paths: np.ndarray
    X: Optional[np.ndarray] = None
    y: Optional[np.ndarray] = None
    ts: Optional[np.ndarray] = None
    split_idx: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return int(self.cat.shape[0])

    def subset(self, n: int) -> "Visuelle2Arrays":
        """The first ``n`` rows (``--quick_debug``)."""
        take = lambda a: None if a is None else a[:n]
        return Visuelle2Arrays(
            demand=self.demand, output_len=self.output_len,
            cat=take(self.cat), col=take(self.col), fab=take(self.fab),
            store=take(self.store), temporal=take(self.temporal),
            gtrends=take(self.gtrends), image_paths=take(self.image_paths),
            X=take(self.X), y=take(self.y), ts=take(self.ts),
            split_idx=take(self.split_idx))


def _to_date(text: str) -> np.datetime64:
    # "2019-03-04", "2019-03-04 00:00:00" or "2019-03-04T..." -> the day.
    return np.datetime64(text.strip()[:10], "D")


_POW10 = [float(f"1e{k}") for k in range(309)]
_MAX_DIGITS = 17


def parse_float(text: str) -> float:
    """A number as pandas' C CSV parser reads it (``precise_xstrtod``, its
    default): at most 17 digits are kept — leading zeros count, so
    "0.33962264150943394" keeps 16 significant digits — accumulated in
    float64 as ``n * 10 + d``, then scaled by one multiplication or division
    by a float64 power of ten.  Python's ``float`` rounds correctly and so
    differs from it in the last bit of about 2 numbers in 3 with 17
    significant digits, which can flip a comparison such as the restock
    cleaning's.  Empty text is NaN; text that is not a number raises
    ``ValueError``."""
    s = text.strip()
    if not s:
        return float("nan")
    p, n = 0, len(s)
    negative = s[0] == "-"
    if s[0] in "+-":
        p = 1
    number, exponent, digits, start = 0.0, 0, 0, p
    while p < n and "0" <= s[p] <= "9":
        if digits < _MAX_DIGITS:
            number = number * 10.0 + (ord(s[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and s[p] == ".":
        p += 1
        while p < n and "0" <= s[p] <= "9":
            if digits < _MAX_DIGITS:
                number = number * 10.0 + (ord(s[p]) - 48)
                digits += 1
                exponent -= 1
            p += 1
    if p == start or (p == start + 1 and s[start] == "."):
        raise ValueError(f"not a number: {text!r}")
    if negative:
        number = -number
    if p < n and s[p] in "eE":
        e_text = s[p + 1:]
        if not e_text.lstrip("+-").isdigit() or len(e_text.lstrip("+-")) > _MAX_DIGITS:
            raise ValueError(f"not a number: {text!r}")
        exponent += int(e_text)
        p = n
    if p != n:
        raise ValueError(f"not a number: {text!r}")
    if exponent > 308:
        return float("inf") if number > 0 else float("-inf") if number < 0 else 0.0
    if exponent >= 0:
        return number * _POW10[exponent]
    if exponent < -308:
        return 0.0 if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def read_csv_table(path: str, *, date_columns=(), index_col: bool = False):
    """Read a CSV into a table of columns: ``date_columns`` as
    ``datetime64[D]``, columns whose every cell parses as a number as
    float64 (as pandas parses them), the rest as object arrays of ``str``.
    With ``index_col`` the first column is returned apart, as dates:
    ``(index, table)``."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    if index_col:
        date_columns = (*date_columns, header[0])
    cols = list(zip(*body)) if body else [()] * len(header)
    table: Table = {}
    for name, cells in zip(header, cols):
        if name in date_columns:
            table[name] = np.array([_to_date(c) for c in cells], "datetime64[D]")
            continue
        try:
            table[name] = np.array([parse_float(c) for c in cells], np.float64)
        except ValueError:
            table[name] = np.array(cells, dtype=object)
    if not index_col:
        return table
    return table.pop(header[0]), table


def clean_restocked_sales(restocks: np.ndarray, sales: np.ndarray):
    """Zero weekly sales past the restock total: every week whose running
    total (over the original series) exceeds the restock figure is zeroed.
    Returns ``(clean_sales, split_idx)``, ``split_idx`` the first zeroed week
    (0 when none was)."""
    sales = np.asarray(sales, dtype=np.float64)
    restocks = np.asarray(restocks, dtype=np.float64)
    over = sales.cumsum(axis=1) > restocks[:, None]
    clean = np.where(over, 0.0, sales)
    any_over = over.any(axis=1)
    first_over = over.argmax(axis=1)
    split_idx = np.where(any_over, first_over, 0).astype(np.int64)
    return clean, split_idx


def frame_series(clean_sales: np.ndarray, train_window: int = TRAIN_WINDOW,
                 forecast_horizon: int = 1):
    """Sliding windows: ``12 - train_window - H + 1`` per item (10 for
    H=1, 1 for H=10)."""
    n, weeks = clean_sales.shape
    num_windows = weeks - train_window - forecast_horizon + 1
    if num_windows < 1:
        raise ValueError(f"horizon {forecast_horizon} too long for {weeks}-week series")
    sw = np.lib.stride_tricks.sliding_window_view(
        clean_sales, train_window + forecast_horizon, axis=1)
    sw = sw[:, :num_windows]
    X = sw[..., :train_window].astype(np.float32)
    y = sw[..., train_window:].astype(np.float32)
    return np.ascontiguousarray(X), np.ascontiguousarray(y)


def _minmax_rows(a: np.ndarray) -> np.ndarray:
    """Per-row min-max scaling (sklearn ``MinMaxScaler``): constant rows map
    to 0.  Works in the input's dtype (float32 here), as the JAX module does."""
    lo = a.min(axis=-1, keepdims=True)
    hi = a.max(axis=-1, keepdims=True)
    denom = np.where(hi > lo, hi - lo, a.dtype.type(1.0))
    return ((a - lo) / denom).astype(np.float32)


def extract_gtrends(release_date: np.ndarray, names: np.ndarray, trend_index: np.ndarray,
                    trends: Table, trend_len: int = DEFAULT_TREND_LEN) -> np.ndarray:
    """Per-item trend history: for each item and each of its
    category/color/fabric (``names`` [N, 3]), the 52 weeks of ``trends``
    (columns over the sorted ``trend_index`` dates) from ``release - 52
    weeks`` to ``release``, both ends included; when that slice is short,
    everything up to the release date; then min-max scaled per item and
    trend.  Short rows keep their zero padding through the scaling."""
    values = {name: np.asarray(v, np.float64) for name, v in trends.items()}
    release = np.asarray(release_date, "datetime64[D]")
    start = release - np.timedelta64(TREND_LOOKBACK_DAYS, "D")
    lo = np.searchsorted(trend_index, start, side="left")
    hi = np.searchsorted(trend_index, release, side="right")

    n = len(release)
    out = np.zeros((n, 3, trend_len), dtype=np.float32)
    for i in range(n):
        l, h = int(lo[i]), int(hi[i])
        for t in range(3):
            column = values[names[i, t]]
            series = column[l:h][-52:][:trend_len]
            if len(series) < trend_len:
                series = column[:h][-52:][:trend_len]
            out[i, t, : len(series)] = series
    return _minmax_rows(out)


def temporal_features_from_dates(release_date: np.ndarray) -> np.ndarray:
    """day / ISO week / month / year, each ÷ its column max."""
    days = [datetime.date.fromisoformat(str(d)) for d in
            np.asarray(release_date, "datetime64[D]")]
    feats = np.array([(d.day, d.isocalendar()[1], d.month, d.year) for d in days],
                     np.float64).reshape(len(days), 4)
    return (feats / feats.max(axis=0)).astype(np.float32)


def encode_attributes(table: Table, cat_dict: Dict[str, int], col_dict: Dict[str, int],
                      fab_dict: Dict[str, int]):
    """String attribute -> int id through the label dicts; the store id raw
    from ``retail``."""
    cat = np.asarray([cat_dict[v] for v in table["category"]], np.int32)
    col = np.asarray([col_dict[v] for v in table["color"]], np.int32)
    fab = np.asarray([fab_dict[v] for v in table["fabric"]], np.int32)
    store = np.asarray(table["retail"]).astype(np.int32)
    return cat, col, fab, store


def preprocess_rows(table: Table, trend_index: np.ndarray, trends: Table,
                    cat_dict, col_dict, fab_dict, *, demand: bool, output_len: int,
                    trend_len: int = DEFAULT_TREND_LEN) -> Visuelle2Arrays:
    """Full preprocessing of one split's table (the JAX
    ``preprocess_dataframe``).  The last 13 columns are the restock figure,
    then 12 weeks of sales; windows frame the cleaned series, while Demand's
    ``ts`` is the raw sales."""
    last = list(table)[-13:]
    sales_block = np.stack([np.asarray(table[c], np.float64) for c in last], axis=1)
    restocks, sales = sales_block[:, 0], sales_block[:, -NUM_SALES_WEEKS:]

    X = y = ts = split_idx = None
    if demand:
        ts = sales.astype(np.float32)
    else:
        clean, split_idx = clean_restocked_sales(restocks, sales)
        X, y = frame_series(clean, forecast_horizon=output_len)

    names = np.stack([np.asarray(table[k]) for k in ("category", "color", "fabric")], axis=1)
    gt = extract_gtrends(table["release_date"], names, trend_index, trends, trend_len)
    temporal = temporal_features_from_dates(table["release_date"])
    cat, col, fab, store = encode_attributes(table, cat_dict, col_dict, fab_dict)
    image_paths = np.array(list(table["image_path"]), dtype=object)

    return Visuelle2Arrays(
        demand=demand, output_len=output_len, cat=cat, col=col, fab=fab,
        store=store, temporal=temporal, gtrends=gt, image_paths=image_paths,
        X=X, y=y, ts=ts, split_idx=split_idx)


def _load_label_dict(path_no_ext: str) -> Dict[str, int]:
    """A str -> int label dict from ``<stem>.json`` or ``<stem>.pt``."""
    if os.path.isfile(path_no_ext + ".json"):
        with open(path_no_ext + ".json") as f:
            return {k: int(v) for k, v in json.load(f).items()}
    pt = path_no_ext + ".pt"
    if os.path.isfile(pt):
        import torch

        return dict(torch.load(pt, weights_only=False))
    raise FileNotFoundError(f"no label dict at {path_no_ext}.(json|pt)")


def load_label_dicts(dataset_path: str):
    return tuple(_load_label_dict(os.path.join(dataset_path, f"{k}_labels"))
                 for k in ("category", "color", "fabric"))


def load_norm_scalar(dataset_path: str) -> float:
    """``stfore_sales_norm_scalar.npy``, 53.0 when absent."""
    p = os.path.join(dataset_path, "stfore_sales_norm_scalar.npy")
    if os.path.isfile(p):
        return float(np.load(p))
    return DEFAULT_NORM_SCALAR


def _cache_key(split: str, demand: bool, output_len: int, trend_len: int) -> str:
    mode = "demand" if demand else f"stfore_h{output_len}"
    return f"visuelle2_{split}_processed_{mode}_t{trend_len}.npz"


def _read_cache(cache_path: str, output_len: int) -> Optional[Visuelle2Arrays]:
    try:
        with np.load(cache_path, allow_pickle=True) as z:
            opt = lambda k: z[k] if k in z else None
            return Visuelle2Arrays(
                demand=bool(z["demand"]),
                # The requested horizon: demand arrays do not depend on it
                # and share one cache file.
                output_len=output_len,
                cat=z["cat"], col=z["col"], fab=z["fab"], store=z["store"],
                temporal=z["temporal"], gtrends=z["gtrends"],
                image_paths=z["image_paths"],
                X=opt("X"), y=opt("y"), ts=opt("ts"), split_idx=opt("split_idx"))
    except CACHE_READ_ERRORS:
        return None  # rebuilt by the caller


def load_visuelle2(dataset_path: str, split: str, *, demand: bool, output_len: int,
                   trend_len: int = DEFAULT_TREND_LEN,
                   use_cache: bool = True) -> Visuelle2Arrays:
    """Load and preprocess one split, with the JAX module's ``.npz`` cache
    (same file name and keys; written atomically, rebuilt when corrupt)."""
    cache_path = os.path.join(dataset_path, _cache_key(split, demand, output_len, trend_len))
    if use_cache and os.path.isfile(cache_path):
        cached = _read_cache(cache_path, output_len)
        if cached is not None:
            return cached

    table = read_csv_table(os.path.join(dataset_path, f"stfore_{split}.csv"),
                           date_columns=("release_date",))
    trend_index, trends = read_csv_table(
        os.path.join(dataset_path, "vis2_gtrends_data.csv"), index_col=True)
    cat_dict, col_dict, fab_dict = load_label_dicts(dataset_path)
    arrays = preprocess_rows(table, trend_index, trends, cat_dict, col_dict, fab_dict,
                             demand=demand, output_len=output_len, trend_len=trend_len)

    if use_cache:
        payload = dict(
            demand=arrays.demand, output_len=arrays.output_len, cat=arrays.cat,
            col=arrays.col, fab=arrays.fab, store=arrays.store,
            temporal=arrays.temporal, gtrends=arrays.gtrends,
            image_paths=arrays.image_paths)
        for k in ("X", "y", "ts", "split_idx"):
            v = getattr(arrays, k)
            if v is not None:
                payload[k] = v
        tmp = f"{cache_path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, **payload)
        os.replace(tmp, cache_path)
    return arrays
