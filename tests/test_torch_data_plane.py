"""The port's data plane on the CPU: the native prefetch engine
(``visuelle2_tpu_torch/native``) as ``tests/test_native_prefetch.py`` tests
the JAX one, the loader's double-buffered iteration, and the grouped dedup
train sampler against the JAX loader (the train half of
``tests/test_image_dedup.py``).  Every comparison of data is exact.
"""

import gc

import numpy as np
import pytest
import torch

from visuelle2_tpu.data.images import ImageStore as JStore
from visuelle2_tpu.data.loader import BatchLoader as JLoader
from visuelle2_tpu.data.pipeline import load_visuelle2 as jload
from visuelle2_tpu_torch import native
from visuelle2_tpu_torch.data.images import ImageStore
from visuelle2_tpu_torch.data.loader import BatchLoader
from visuelle2_tpu_torch.data.pipeline import load_visuelle2
from visuelle2_tpu_torch.models import VocabSizes, build
from visuelle2_tpu_torch.train.loop import TrainConfig, Trainer, mse_loss, target_and_pred

DUP = 4  # rows sharing one photo


@pytest.fixture(scope="module")
def engine():
    return native.PrefetchEngine(num_threads=4)


@pytest.fixture(scope="module")
def arrays_and_store(synthetic_dataset):
    """The train split with DUP rows a photo, in both packages' stores."""
    arrays = load_visuelle2(synthetic_dataset, "train", demand=True, output_len=12)
    jarrays = jload(synthetic_dataset, "train", demand=True, output_len=12)
    n = len(arrays)
    pixels = np.random.default_rng(3).integers(0, 255, (-(-n // DUP), 32, 32, 3),
                                               dtype=np.uint8)
    row_to_img = np.arange(n) // DUP
    return arrays, ImageStore(pixels, row_to_img), jarrays, JStore(pixels, row_to_img)


# ------------------------------------------------------------ the engine

def test_gather_matches_numpy(engine, rng):
    src = rng.integers(0, 255, (200, 17, 13, 3), dtype=np.uint8)
    idx = rng.integers(0, 200, 64).astype(np.int64)
    np.testing.assert_array_equal(engine.gather(src, idx), src[idx])


def test_async_submit_wait(engine, rng):
    src = rng.integers(0, 255, (500, 64), dtype=np.uint8)
    idx1, idx2 = (rng.permutation(500)[:128].astype(np.int64) for _ in range(2))
    out1, out2 = np.empty((128, 64), np.uint8), np.empty((128, 64), np.uint8)
    h1, h2 = engine.submit(src, idx1, out1), engine.submit(src, idx2, out2)
    engine.wait(h1)
    engine.wait(h2)
    np.testing.assert_array_equal(out1, src[idx1])
    np.testing.assert_array_equal(out2, src[idx2])


def test_large_rows(engine, rng):
    # Rows past the 2 MB chunk size: jobs of several chunks.
    src = rng.integers(0, 255, (8, 3 * 1024 * 1024), dtype=np.uint8)
    idx = np.array([5, 1, 7, 0], np.int64)
    np.testing.assert_array_equal(engine.gather(src, idx), src[idx])


def test_engine_refuses_what_would_write_out_of_bounds(engine):
    src = np.zeros((4, 8), np.uint8)
    with pytest.raises(IndexError):
        engine.gather(src, np.array([4], np.int64))
    with pytest.raises(TypeError):
        engine.gather(src, np.array([0], np.int32))
    with pytest.raises(ValueError):
        engine.gather(src, np.array([0], np.int64), np.empty((1, 7), np.uint8))


def test_library_builds_under_build_keyed_by_its_source():
    lib = native.library_path()
    assert lib.parent == native.BUILD_DIR and lib.parent.parts[-2:] == (
        "build", "visuelle2_tpu_torch")
    native.load_library()
    assert lib.is_file()
    assert not list(native.SOURCE.parent.glob("*.so"))  # never in the package


def test_a_failed_build_raises_with_the_compilers_stderr(tmp_path, monkeypatch):
    bad = tmp_path / "prefetch.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="error"):
            native.load_library()
        assert not list((tmp_path / "build").glob("*.so"))
    finally:
        native.load_library.cache_clear()


def test_abandoned_iterator_completes_its_inflight_gather(arrays_and_store):
    """Dropping an iterator mid-epoch must not free the buffer C++ workers
    are still writing."""
    arrays, store, _, _ = arrays_and_store
    loader = BatchLoader(arrays, store, 8, shuffle=True, drop_remainder=True)
    assert loader._engine is not None
    for _ in range(20):
        next(iter(loader))
        gc.collect()
    ref = BatchLoader(arrays, store, 8, shuffle=True, drop_remainder=True,
                      native_prefetch=False)
    loader.set_epoch(3)
    ref.set_epoch(3)
    for got, want in zip(loader, ref):
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_prefetched_batches_equal_numpy_gathers_with_a_fresh_buffer_each(arrays_and_store):
    arrays, store, _, _ = arrays_and_store
    loader = BatchLoader(arrays, store, 10)  # a ragged tail: 48 rows
    ref = BatchLoader(arrays, store, 10, native_prefetch=False)
    got, want = list(loader), list(ref)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for k in w:
            assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k
    assert len({b["images"].data_ptr() for b in got}) == len(got)
    assert torch.count_nonzero(got[-1]["images"][8:]) == 0  # the padded tail


# ---------------------------------------------------- the grouped sampler

@pytest.mark.parametrize("batch_size,seed", [(16, 21), (8, 4), (12, 0)])
def test_grouped_sampler_blocks_equal_jax(arrays_and_store, batch_size, seed):
    arrays, store, jarrays, jstore = arrays_and_store
    kw = dict(shuffle=True, seed=seed, drop_remainder=True, dedup_images=True)
    port = BatchLoader(arrays, store, batch_size, **kw)
    ref = JLoader(jarrays, jstore, batch_size, native_prefetch=False, **kw)
    assert port.unique_image_slots == ref.unique_image_slots
    assert port.image_slots == ref.image_slots
    for _ in range(3):
        got, want = port._epoch_index_blocks(), ref._epoch_index_blocks()
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    port.set_epoch(1)
    ref.set_epoch(1)
    for g, w in zip(port, ref):
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)


def test_slot_multiple_rounds_up_as_jax(arrays_and_store):
    arrays, store, jarrays, jstore = arrays_and_store
    for multiple in (1, 3, 8):
        kw = dict(shuffle=True, dedup_images=True, image_slots_multiple=multiple)
        port = BatchLoader(arrays, store, 16, **kw)
        ref = JLoader(jarrays, jstore, 16, native_prefetch=False, **kw)
        assert (port.unique_image_slots, port.image_slots) == \
            (ref.unique_image_slots, ref.image_slots)
        assert port.image_slots % multiple == 0
        assert next(iter(port))["images"].shape[0] == port.image_slots


def test_train_dedup_grouped_shuffle_covers_every_row(arrays_and_store):
    arrays, store, _, _ = arrays_and_store
    loader = BatchLoader(arrays, store, 16, shuffle=True, drop_remainder=True,
                         dedup_images=True)
    assert loader._engine is None  # unique-image batches gather in numpy
    orders = []
    for _ in range(3):
        blocks = loader._epoch_index_blocks()
        order = np.concatenate(blocks)
        assert len(np.unique(order)) == len(order) <= len(arrays)
        imgs = store.row_to_img[order]
        runs = 1 + int(np.sum(imgs[1:] != imgs[:-1]))
        assert runs == len(np.unique(imgs))  # rows sharing a photo are contiguous
        for b in blocks:
            assert len(np.unique(store.image_indices(b))) <= loader.image_slots
        orders.append(order)
    assert not np.array_equal(orders[0], orders[1])


def test_train_dedup_slot_bound_is_tight_and_safe():
    rng = np.random.default_rng(0)
    for _ in range(5):
        sizes = rng.integers(1, 9, size=40)
        row_to_img = np.repeat(np.arange(len(sizes)), sizes)
        n = len(row_to_img)
        store = ImageStore(np.zeros((len(sizes), 4, 4, 3), np.uint8), row_to_img=row_to_img)

        class _A:
            demand = True

            def __len__(self):
                return n

        a = _A()
        a.cat = a.col = a.fab = a.store = np.zeros(n, np.int32)
        a.temporal = np.zeros((n, 4), np.float32)
        a.gtrends = np.zeros((n, 3, 8), np.float32)
        a.ts = np.zeros((n, 12), np.float32)
        loader = BatchLoader(a, store, 16, shuffle=True, dedup_images=True)
        for _ in range(4):
            for b in loader:  # the gather asserts uniques <= image_slots
                assert b["images"].shape[0] == loader.image_slots


def test_dedup_gradient_parity_through_the_gather(synthetic_dataset):
    """Duplication 1 with a shuffled block: ``img_idx`` is a real
    permutation, so the gather's backward must route each row's gradient to
    its slot.  Eval-mode loss (BatchNorm statistics and dropout masks cannot
    align between the two layouts); the same gradients as the expanded
    batch within 1e-6, as the JAX test's."""
    arrays = load_visuelle2(synthetic_dataset, "train", demand=True, output_len=12)
    pixels = np.random.default_rng(7).integers(0, 255, (len(arrays), 32, 32, 3),
                                               dtype=np.uint8)
    dedup = next(iter(BatchLoader(arrays, ImageStore(pixels), 16, shuffle=True, seed=3,
                                  dedup_images=True)))
    assert dedup["images"].shape[0] == 16
    assert torch.any(dedup["img_idx"] != torch.arange(16))
    expanded = {k: v for k, v in dedup.items() if k != "img_idx"}
    expanded["images"] = dedup["images"][dedup["img_idx"].long()]
    model = build("gated_v4", device="cpu", generator=torch.Generator().manual_seed(0),
                  vocab=VocabSizes(5, 6, 5, 126), output_len=12, embedding_dim=16,
                  hidden_dim=16, image_arch="tiny").eval()

    def grads(batch):
        model.zero_grad()
        out, _ = model(batch)
        target, pred = target_and_pred(batch, out)
        mse_loss(target, pred, batch["mask"]).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}

    g_dedup, g_expanded = grads(dedup), grads(expanded)
    assert sorted(g_dedup) == sorted(g_expanded)
    assert any("backbone" in n for n in g_dedup)
    for n in g_dedup:
        torch.testing.assert_close(g_dedup[n], g_expanded[n], atol=1e-6, rtol=0)


def test_train_loop_converges_with_dedup(arrays_and_store):
    """A few grouped-sampler epochs at duplication 4 train the flagship:
    losses finite and falling."""
    arrays, store, _, _ = arrays_and_store
    loader = BatchLoader(arrays, store, 16, shuffle=True, drop_remainder=True,
                         dedup_images=True)
    assert loader.image_slots < 16
    model = build("gated_v4", device="cpu", generator=torch.Generator().manual_seed(0),
                  vocab=VocabSizes(5, 6, 5, 126), output_len=12, embedding_dim=16,
                  hidden_dim=16, image_arch="tiny")
    trainer = Trainer(model, TrainConfig(learning_rate=5e-3, epochs=3))
    state = trainer.init_state()
    losses = []
    for epoch in range(3):
        loader.set_epoch(epoch)
        for batch in loader:
            state, metrics = trainer.train_step(state, batch)
            losses.append(float(metrics["loss"]))
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
