"""Host-side batch assembly, counterpart of ``visuelle2_tpu/data/loader.py``.

Batches are numpy gathers from the preprocessed arrays and the image store,
padded to a static batch size with a ``mask`` of real rows, handed out as
dicts of torch CPU tensors with the JAX batch's keys, dtypes and values.
With ``pin_memory`` (the caller's target is a CUDA device) each tensor is
pinned, so the copy to the card can run asynchronously.

Without dedup, a batch's images are gathered by the native prefetch engine
(``native/``: C++ worker threads) while the previous batch is consumed, into
a fresh buffer for every batch (pinned when ``pin_memory`` is set, gathered
straight into it): a buffer is never reused, so a ``non_blocking`` copy to
the card still reading one batch never races the next batch's gather.
``native_prefetch=False`` gathers with numpy instead; a failed build of the
engine raises.

Data parallel (``rank``, ``world``): ``batch_size`` is the global batch, and
each rank's loader yields its contiguous row block of every global batch
(``batch_size / world`` rows, its share of the padding and the ``mask``),
gathering only its own rows' images: no process holds the whole batch.
Every rank sees the same number of batches.  ``shard_batch`` cuts this
rank's block out of a host batch instead (the JAX ``shard_batch``).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from visuelle2_tpu_torch.data.images import ImageStore
from visuelle2_tpu_torch.data.pipeline import Visuelle2Arrays
from visuelle2_tpu_torch.utils import tracing

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

    ``dedup_images``: each batch ships its unique images in ``image_slots``
    slots (spare slots repeat the batch's images cyclically) plus an
    ``img_idx`` row -> slot map, so the model encodes each photo once.
    Without ``shuffle`` (eval) rows are ordered by image and the slot count
    is the most any batch needs.  With ``shuffle`` (training: the grouped
    sampler) each epoch permutes the groups of rows that share a photo, then
    the rows inside each group, from ``default_rng(seed + epoch)``, as the
    JAX loader does; the slot count is a bound that holds for every
    permutation: a window of B consecutive rows over contiguous groups meets
    at most 2 boundary groups plus as many of the smallest groups as fit in
    the other B - 2 rows.  ``unique_image_slots`` is that requirement before
    ``image_slots`` is forced (an artifact's signature) or rounded up to
    ``image_slots_multiple`` (the data-parallel degree; 1 on one card): the
    true duplication factor is ``batch_size / unique_image_slots``.  Under
    data parallelism each rank ships its block of the global batch's slots
    (``image_slots`` must divide by ``world``), and ``img_idx`` indexes the
    global slot axis.

    Against the duplicate-encode batch, per-row losses and the gather's
    gradients are the same up to two train-mode deviations (the JAX
    loader's): BatchNorm statistics weight each unique photo once, and rows
    that share a photo share one dropout mask on its image features.
    """

    def __init__(self, arrays: Visuelle2Arrays, images: Optional[ImageStore],
                 batch_size: int, *, shuffle: bool = False, seed: int = 21,
                 drop_remainder: bool = False,
                 extras: Optional[Dict[str, np.ndarray]] = None,
                 dedup_images: bool = False, image_slots: int = 0,
                 image_slots_multiple: int = 1, pin_memory: bool = False,
                 native_prefetch: bool = True, rank: int = 0, world: int = 1):
        if world < 1 or not 0 <= rank < world or batch_size % world:
            raise ValueError(f"rank {rank} of world {world}: the batch of {batch_size} "
                             f"rows must divide into the ranks")
        self.rank, self.world = rank, world
        self.local_batch_size = batch_size // world
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
        self.image_slots = self.unique_image_slots = 0
        if self.dedup_images:
            self._dedup_order = np.argsort(images.row_to_img, kind="stable")
            if shuffle:
                sizes = np.sort(np.bincount(images.row_to_img))
                sizes = sizes[sizes > 0]
                interior = int(np.searchsorted(np.cumsum(sizes), batch_size - 2,
                                               side="right"))
                slots = min(len(sizes), batch_size, interior + 2)
                firsts = np.unique(images.row_to_img[self._dedup_order],
                                   return_index=True)[1]
                self._groups = np.split(self._dedup_order, firsts[1:])
            else:
                slots = max((len(np.unique(images.image_indices(b)))
                             for b in self._split_blocks(self._dedup_order)), default=1)
            self.unique_image_slots = int(slots)
            if image_slots and image_slots < slots:
                raise ValueError(
                    f"image_slots={image_slots} < the {slots} unique-"
                    f"image slots this split/batch-size requires")
            multiple = max(1, int(image_slots_multiple))
            self.image_slots = int(image_slots or -(-slots // multiple) * multiple)
            if self.image_slots % world:
                raise ValueError(f"image_slots={self.image_slots} do not divide into "
                                 f"{world} ranks (image_slots_multiple)")
        # Per-item side arrays gathered and padded with the batch.
        self.extras = extras or {}
        for k, v in self.extras.items():
            if len(v) != len(arrays):
                raise ValueError(f"extras[{k!r}] has {len(v)} rows, the split {len(arrays)}")
        self._epoch = 0
        self._engine = None
        if native_prefetch and images is not None and not self.dedup_images:
            # Dedup batches gather only the unique images: too few to be
            # worth the double-buffered path.
            from visuelle2_tpu_torch import native

            self._engine = native.shared_engine()

    def __len__(self) -> int:
        n = len(self.arrays)
        if self.drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        """Pin the next iteration's shuffle to ``(seed, epoch)``."""
        self._epoch = int(epoch)

    def _gather_rows(self, idx: np.ndarray, pad_to: int) -> Dict[str, np.ndarray]:
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
        return batch

    def _local_rows(self, idx: np.ndarray) -> np.ndarray:
        """This rank's rows of the global batch ``idx`` (its padding rows
        are the ones past them)."""
        if self.world == 1:
            return idx
        lo = self.rank * self.local_batch_size
        return idx[lo: lo + self.local_batch_size]

    def _gather_numpy(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        """This rank's batch of the global batch ``idx``."""
        pad_to = self.local_batch_size
        rows = self._local_rows(idx)
        batch = self._gather_rows(rows, pad_to)
        if self.images is None:
            return batch
        if self.dedup_images:
            uniq, inv = np.unique(self.images.image_indices(idx), return_inverse=True)
            assert len(uniq) <= self.image_slots, (len(uniq), self.image_slots)
            if len(uniq) < self.image_slots:
                # Spare slots repeat the batch's own images: img_idx never
                # addresses them, and they stay in-distribution.
                uniq = uniq[np.resize(np.arange(len(uniq)), self.image_slots)]
            per = self.image_slots // self.world
            batch["images"] = self.images.pixels[uniq[self.rank * per: (self.rank + 1) * per]]
            img_idx = np.zeros(pad_to, np.int32)
            local_inv = inv[self.rank * pad_to: self.rank * pad_to + len(rows)]
            img_idx[: len(rows)] = local_inv.astype(np.int32)
            batch["img_idx"] = img_idx
        else:
            batch["images"] = _pad_to(self.images.gather(rows), pad_to)
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
            if not self.shuffle:
                return self._split_blocks(self._dedup_order)
            rng = np.random.default_rng(self.seed + self._epoch)
            self._epoch += 1
            parts = [rng.permutation(self._groups[g])
                     for g in rng.permutation(len(self._groups))]
            order = np.concatenate(parts) if parts else np.zeros(0, np.int64)
            return self._split_blocks(order)
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
        never assembled (a mid-epoch resume, ``train/loop.py``).  Assembling
        each batch (and, with the engine, starting the next one's gather) is
        a host span ``loader.batch`` (``utils/tracing.py``), closed before
        the batch is yielded."""
        blocks = self._epoch_index_blocks()[skip_blocks:]
        if self._engine is None or not blocks:
            for idx in blocks:
                with tracing.span("loader.batch"):
                    batch = self._to_tensors(self._gather_numpy(idx))
                yield batch
            return
        blocks = [self._local_rows(idx) for idx in blocks]
        # Double-buffered: the engine gathers batch t + 1's images while
        # batch t is consumed.
        pending = None
        try:
            # The first submit sits inside the try: the finally must wait for
            # any gather in flight, since C++ workers write into its buffer.
            pending = self._submit(blocks[0])
            for nxt in blocks[1:] + [None]:
                with tracing.span("loader.batch"):
                    idx, images, handle = pending
                    pending = None
                    self._engine.wait(handle)
                    batch = self._to_tensors(self._gather_rows(idx, self.local_batch_size))
                    batch["images"] = images
                    pending = self._submit(nxt) if nxt is not None else None
                yield batch
        finally:
            # An abandoned iterator (``next(iter(loader))``) still lets the
            # gather in flight finish before its buffer can be freed.
            if pending is not None:
                self._engine.wait(pending[2])

    def _submit(self, idx: np.ndarray):
        """Start gathering ``idx``'s images (this rank's rows) into a fresh
        buffer of this rank's batch size (pinned under ``pin_memory``); rows
        past ``len(idx)`` are zeros."""
        pixels = self.images.pixels
        n = len(idx)
        images = torch.empty((self.local_batch_size,) + pixels.shape[1:], dtype=torch.uint8,
                             pin_memory=self.pin_memory)
        images[n:] = 0
        img_idx = np.ascontiguousarray(self.images.image_indices(idx), np.int64)
        return idx, images, self._engine.submit(pixels, img_idx, images[:n].numpy())


def shard_batch(batch, mesh=None, device=None) -> Batch:
    """This rank's contiguous row block of the host batch ``batch``
    (logically global; numpy arrays or CPU tensors) on ``device``, the
    counterpart of the JAX ``shard_batch``.  A dedup batch's ``images`` are
    cut by the slot axis (``img_idx`` keeps its global slot indices).  The
    copy runs non-blocking from pinned memory to a CUDA device.  With no mesh
    (or one rank) it is the whole batch, moved.  ``device`` defaults to the
    rank's (``parallel.distributed.initialize``), else the CPU."""
    from visuelle2_tpu_torch.parallel import distributed
    from visuelle2_tpu_torch.parallel.mesh import batch_rank_world

    rank, world = batch_rank_world(mesh)
    device = torch.device(device or distributed.current_device() or "cpu")
    out = {}
    for key, value in batch.items():
        t = torch.as_tensor(value)
        if world > 1:
            n = t.shape[0]
            if n % world:
                raise ValueError(f"{key}: {n} rows do not divide into {world} ranks")
            t = t[rank * (n // world): (rank + 1) * (n // world)]
        t = t.contiguous()
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t.to(device)
    return out
