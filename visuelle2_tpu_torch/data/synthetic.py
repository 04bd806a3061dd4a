"""Synthetic mini-VISUELLE2 generator, counterpart of
``visuelle2_tpu/data/synthetic.py``.

Writes a dataset directory with the full on-disk contract
(``stfore_{train,test}.csv``, label dicts, ``vis2_gtrends_data.csv``, an
``images/`` JPEG tree and ``stfore_sales_norm_scalar.npy``) from the same
random draws, in the same order, as the JAX generator: the same ``seed`` and
sizes give the same numbers.  numpy and ``csv`` only — the weekly Monday
dates come from ``datetime64`` arithmetic — and PIL is imported only to
write JPEGs (``write_images=True``).
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np

CATEGORIES = ["long sleeve", "culottes", "short sleeves", "doll dress"]
COLORS = ["black", "red", "blue", "white", "yellow"]
FABRICS = ["cotton", "wool", "silk", "polyester"]
NUM_STORES = 125  # store_num of the reference trainers

TRENDS_START, TRENDS_WEEKS = "2015-01-05", 320   # a Monday; covers 2015-2020
RELEASE_FIRST, RELEASE_LAST = "2017-01-02", "2019-06-03"  # Mondays


def weekly_mondays(first: str, last: str = None, periods: int = None) -> np.ndarray:
    """Weekly dates from the Monday ``first``: through ``last`` inclusive, or
    ``periods`` of them (``pd.date_range(..., freq="W-MON")``)."""
    start = np.datetime64(first, "D")
    if periods is None:
        periods = int((np.datetime64(last, "D") - start).astype(np.int64)) // 7 + 1
    return start + 7 * np.arange(periods)


def _write_csv(path: str, header, rows) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def _num(v) -> str:
    return repr(float(v))  # shortest round-trip float text


def make_synthetic_dataset(path: str, *, num_train: int = 64, num_test: int = 32,
                           image_size: int = 32, seed: int = 0,
                           write_images: bool = True,
                           rows_per_image: int = 1) -> str:
    """Create a synthetic dataset at ``path`` and return it.

    ``rows_per_image > 1`` makes consecutive rows share one product photo, as
    VISUELLE2 rows (per product and store) do; the loader's ``dedup_images``
    path encodes each once."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(path, "images"), exist_ok=True)

    for name, vals in (("category", CATEGORIES), ("color", COLORS),
                       ("fabric", FABRICS)):
        with open(os.path.join(path, f"{name}_labels.json"), "w") as f:
            json.dump({v: i for i, v in enumerate(vals)}, f)

    dates = weekly_mondays(TRENDS_START, periods=TRENDS_WEEKS)
    trend_cols = CATEGORIES + COLORS + FABRICS
    tt = np.arange(len(dates))[:, None]
    phase = rng.uniform(0, 2 * np.pi, size=(1, len(trend_cols)))
    trend_vals = (
        50 + 30 * np.sin(2 * np.pi * tt / 52 + phase)
        + rng.normal(0, 5, size=(len(dates), len(trend_cols))))
    _write_csv(os.path.join(path, "vis2_gtrends_data.csv"), ["date"] + trend_cols,
               ([str(d)] + [_num(v) for v in row] for d, row in zip(dates, trend_vals)))
    release_weeks = weekly_mondays(RELEASE_FIRST, RELEASE_LAST)

    def make_split(split: str, n: int, offset: int):
        cats = rng.choice(CATEGORIES, n)
        cols = rng.choice(COLORS, n)
        fabs = rng.choice(FABRICS, n)
        stores = rng.integers(0, NUM_STORES, n)
        release = rng.choice(release_weeks, n)

        # Launch-decay sales: peak early then decay, scaled by a per-item level.
        weeks = np.arange(12)[None, :]
        level = rng.gamma(2.0, 6.0, size=(n, 1))
        decay = np.exp(-weeks / rng.uniform(2, 8, size=(n, 1)))
        sales = np.maximum(0, level * decay + rng.normal(0, 1.0, (n, 12))).round()
        sales = np.minimum(sales, 53.0)
        restock = sales.sum(axis=1) + rng.integers(0, 20, n)
        # A few items oversell their restock so the cleaning path is exercised.
        oversold = rng.random(n) < 0.2
        restock[oversold] = np.maximum(1, sales[oversold, :6].sum(axis=1))

        img_paths = [f"{split}_{offset + i // rows_per_image}.jpg" for i in range(n)]
        if write_images:
            from PIL import Image

            for rel in dict.fromkeys(img_paths):
                arr = rng.integers(0, 255, (image_size, image_size, 3), dtype=np.uint8)
                Image.fromarray(arr).save(os.path.join(path, "images", rel), quality=85)

        # The last 13 columns: the restock figure, then 12 weekly sales, both
        # already divided by the norm scalar 53.
        header = (["image_path", "category", "color", "fabric", "retail",
                   "release_date", "restock"] + [f"w{w}" for w in range(12)])
        rows = ([img_paths[i], cats[i], cols[i], fabs[i], int(stores[i]), str(release[i]),
                 _num(restock[i] / 53.0)] + [_num(v / 53.0) for v in sales[i]]
                for i in range(n))
        _write_csv(os.path.join(path, f"stfore_{split}.csv"), header, rows)

    make_split("train", num_train, 0)
    make_split("test", num_test, num_train)
    np.save(os.path.join(path, "stfore_sales_norm_scalar.npy"), np.float64(53.0))
    return path
