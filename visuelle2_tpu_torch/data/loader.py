"""Host-side batch assembly, counterpart of ``visuelle2_tpu/data/loader.py``.

Batches are numpy gathers from the preprocessed arrays and the image store,
padded to a static batch size with a ``mask`` of real rows, handed out as
dicts of torch CPU tensors with the JAX batch's keys, dtypes and values.
With ``pin_memory`` (the caller's target is a CUDA device) each tensor is
pinned, so the copy to the card can run asynchronously.

Not here yet: the grouped shuffle sampler (``shuffle=True`` with
``dedup_images``) and the native prefetch engine (ROADMAP Queue 1 item 11),
and ``shard_batch`` (item 12).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from visuelle2_tpu_torch.data.images import ImageStore
from visuelle2_tpu_torch.data.pipeline import Visuelle2Arrays

Batch = Dict[str, torch.Tensor]


def _pad_to(a: np.ndarray, n: int) -> np.ndarray:
    if a.shape[0] == n:
        return a
    pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


class BatchLoader:
    """Iterates static-shape batches over a ``Visuelle2Arrays`` split.

    The tail batch is zero-padded and ``mask`` marks its real rows
    (``drop_remainder`` drops it instead).  ``shuffle`` permutes the rows
    with ``default_rng(seed + epoch)``, the epoch counting up per iteration
    unless ``set_epoch`` pins it.

    ``dedup_images`` (eval order only): rows are ordered by image, and each
    batch ships its unique images in ``image_slots`` slots (the most any
    batch needs, unless given; spare slots repeat the batch's images
    cyclically) plus an ``img_idx`` row -> slot map, so the model encodes
    each photo once.
    """

    def __init__(self, arrays: Visuelle2Arrays, images: Optional[ImageStore],
                 batch_size: int, *, shuffle: bool = False, seed: int = 21,
                 drop_remainder: bool = False,
                 extras: Optional[Dict[str, np.ndarray]] = None,
                 dedup_images: bool = False, image_slots: int = 0,
                 pin_memory: bool = False):
        self.arrays = arrays
        self.images = images
        if images is not None and len(images) != len(arrays):
            raise ValueError(
                f"ImageStore maps {len(images)} rows but the split has "
                f"{len(arrays)} — a stale image cache (different subset or "
                f"--image_size)? Delete it so it rebuilds")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.pin_memory = pin_memory
        self.dedup_images = bool(dedup_images and images is not None)
        if self.dedup_images and shuffle:
            raise NotImplementedError(
                "the grouped shuffle sampler (shuffle=True with dedup_images) is "
                "ported in ROADMAP Queue 1 item 11 (data plane)")
        self.image_slots = 0
        if self.dedup_images:
            self._dedup_order = np.argsort(images.row_to_img, kind="stable")
            blocks = self._split_blocks(self._dedup_order)
            slots = max((len(np.unique(images.image_indices(b))) for b in blocks),
                        default=1)
            if image_slots and image_slots < slots:
                raise ValueError(
                    f"image_slots={image_slots} < the {slots} unique-"
                    f"image slots this split/batch-size requires")
            self.image_slots = int(image_slots or slots)
        # Per-item side arrays gathered and padded with the batch.
        self.extras = extras or {}
        for k, v in self.extras.items():
            if len(v) != len(arrays):
                raise ValueError(f"extras[{k!r}] has {len(v)} rows, the split {len(arrays)}")
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.arrays)
        if self.drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        """Pin the next iteration's shuffle to ``(seed, epoch)``."""
        self._epoch = int(epoch)

    def _gather_numpy(self, idx: np.ndarray, pad_to: int) -> Dict[str, np.ndarray]:
        a = self.arrays
        batch = {"cat": a.cat[idx], "col": a.col[idx], "fab": a.fab[idx],
                 "store": a.store[idx], "temporal": a.temporal[idx],
                 "gtrends": a.gtrends[idx]}
        if a.demand:
            batch["ts"] = a.ts[idx]
        else:
            batch["X"] = a.X[idx]
            batch["y"] = a.y[idx]
        for k, v in self.extras.items():
            batch[k] = v[idx]
        mask = np.zeros(pad_to, np.float32)
        mask[: len(idx)] = 1.0
        batch = {k: _pad_to(v, pad_to) for k, v in batch.items()}
        batch["mask"] = mask
        if self.images is None:
            return batch
        if self.dedup_images:
            uniq, inv = np.unique(self.images.image_indices(idx), return_inverse=True)
            assert len(uniq) <= self.image_slots, (len(uniq), self.image_slots)
            if len(uniq) < self.image_slots:
                # Spare slots repeat the batch's own images: img_idx never
                # addresses them, and they stay in-distribution.
                uniq = uniq[np.resize(np.arange(len(uniq)), self.image_slots)]
            batch["images"] = self.images.pixels[uniq]
            img_idx = np.zeros(pad_to, np.int32)
            img_idx[: len(inv)] = inv.astype(np.int32)
            batch["img_idx"] = img_idx
        else:
            batch["images"] = _pad_to(self.images.gather(idx), pad_to)
        return batch

    def _to_tensors(self, batch: Dict[str, np.ndarray]) -> Batch:
        out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if self.pin_memory:
            out = {k: v.pin_memory() for k, v in out.items()}
        return out

    def _split_blocks(self, order: np.ndarray):
        n = len(order)
        stop = (n // self.batch_size) * self.batch_size if self.drop_remainder else n
        return [order[s: s + self.batch_size] for s in range(0, stop, self.batch_size)]

    def _epoch_index_blocks(self):
        if self.dedup_images:
            return self._split_blocks(self._dedup_order)
        order = np.arange(len(self.arrays))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
            self._epoch += 1
        return self._split_blocks(order)

    def __iter__(self) -> Iterator[Batch]:
        return self.iter_from(0)

    def iter_from(self, skip_blocks: int) -> Iterator[Batch]:
        """The epoch from batch ``skip_blocks`` on: the skipped batches are
        never assembled (a mid-epoch resume, ``train/loop.py``)."""
        for idx in self._epoch_index_blocks()[skip_blocks:]:
            yield self._to_tensors(self._gather_numpy(idx, self.batch_size))
