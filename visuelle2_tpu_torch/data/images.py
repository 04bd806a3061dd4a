"""Image store and on-device normalization, counterpart of
``visuelle2_tpu/data/images.py``.

``ImageStore`` holds a split's product photos decoded once, as uint8
``[U, S, S, 3]`` (NHWC) over the *unique* image paths, with ``row_to_img``
mapping dataset rows to them; batch assembly is a memory gather.  Its
``.npz`` cache (``images_{split}_{size}.npz``: ``pixels``, ``row_to_img``,
``paths_crc32``) has the JAX store's file name and keys.  A valid cache is
read with numpy alone; PIL is imported only to decode JPEGs when the cache
is missing or stale, which the card's machine (no PIL) never needs.

Only uint8 bytes cross the host-to-device boundary; the ``÷255`` and the
ImageNet mean/std run on the device (``normalize_images``), in the working
dtype (bf16 on the main path), as in the JAX package, so bf16 rounds at the
same places.
"""

from __future__ import annotations

import functools
import os
import zlib
from typing import Optional, Sequence

import numpy as np
import torch

from visuelle2_tpu_torch.data.pipeline import CACHE_READ_ERRORS

IMAGE_SIZE = 299
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=None)
def _normalize_constants(dtype, device):
    """255, the mean and the std in ``dtype`` on ``device``, made once: a
    tensor made from Python numbers on the card is a copy the host waits
    for, which a train step must not make."""
    return tuple(torch.tensor(v, dtype=dtype, device=device)
                 for v in (255.0, IMAGENET_MEAN, IMAGENET_STD))


def normalize_images(uint8_nhwc: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [..., H, W, 3] -> normalized [..., H, W, 3] in ``dtype``
    (torchvision ``ToTensor`` + ``Normalize``)."""
    scale, mean, std = _normalize_constants(dtype, uint8_nhwc.device)
    return (uint8_nhwc.to(dtype) / scale - mean) / std


class ImageStore:
    """Decode-once, deduplicated uint8 image cache."""

    def __init__(self, pixels: np.ndarray, row_to_img: Optional[np.ndarray] = None):
        assert pixels.dtype == np.uint8 and pixels.ndim == 4
        self.pixels = pixels
        if row_to_img is None:
            row_to_img = np.arange(pixels.shape[0], dtype=np.int64)
        self.row_to_img = np.asarray(row_to_img, np.int64)

    def __len__(self) -> int:
        return int(self.row_to_img.shape[0])

    def image_indices(self, rows) -> np.ndarray:
        return self.row_to_img[np.asarray(rows)]

    def gather(self, rows) -> np.ndarray:
        return np.ascontiguousarray(self.pixels[self.image_indices(rows)])

    @staticmethod
    def cache_path(dataset_path: str, split: str, size: int = IMAGE_SIZE) -> str:
        return os.path.join(dataset_path, f"images_{split}_{size}.npz")

    @staticmethod
    def _paths_digest(image_paths) -> int:
        return zlib.crc32("\n".join(map(str, image_paths)).encode())

    @staticmethod
    def unique_paths(image_paths: Sequence[str]):
        """``(unique sorted paths, row_to_img)``: the store's image order."""
        unique, row_to_img = np.unique(np.asarray(image_paths), return_inverse=True)
        return unique, row_to_img.astype(np.int64)

    def write_cache(self, cache_file: str, image_paths: Sequence[str]) -> None:
        """Write the store as the cache of a split with ``image_paths``,
        atomically: an interrupted write leaves no truncated file behind."""
        tmp = f"{cache_file}.{os.getpid()}.tmp.npz"
        np.savez(tmp, pixels=self.pixels, row_to_img=self.row_to_img,
                 paths_crc32=np.int64(self._paths_digest(image_paths)))
        os.replace(tmp, cache_file)

    @classmethod
    def _read_cache(cls, cache_file: str, image_paths, size: int) -> Optional["ImageStore"]:
        # Validate before trusting: a cache of another row subset
        # (--quick_debug), another --image_size, or an interrupted write is
        # rebuilt, never served.
        try:
            with np.load(cache_file) as z:
                if (int(z["paths_crc32"]) == cls._paths_digest(image_paths)
                        and z["pixels"].shape[1] == size
                        and z["row_to_img"].shape[0] == len(image_paths)):
                    return cls(z["pixels"], z["row_to_img"])
        except CACHE_READ_ERRORS:
            pass
        return None

    @classmethod
    def build(cls, img_root: str, image_paths: Sequence[str],
              cache_file: Optional[str] = None, size: int = IMAGE_SIZE) -> "ImageStore":
        if cache_file and os.path.isfile(cache_file):
            store = cls._read_cache(cache_file, image_paths, size)
            if store is not None:
                return store

        from PIL import Image, ImageFile

        ImageFile.LOAD_TRUNCATED_IMAGES = True  # as the reference's loader

        unique, row_to_img = cls.unique_paths(image_paths)
        pixels = np.zeros((len(unique), size, size, 3), np.uint8)
        for i, rel in enumerate(unique):
            img = Image.open(os.path.join(img_root, str(rel))).convert("RGB")
            img = img.resize((size, size), Image.BILINEAR)
            pixels[i] = np.asarray(img, dtype=np.uint8)
        store = cls(pixels, row_to_img)
        if cache_file:
            store.write_cache(cache_file, image_paths)
        return store
