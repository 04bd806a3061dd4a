"""Products made from the seed: what both serving and training draw rows from.

One product is a row of the VISUELLE 2.0 Demand batch: a uint8 photo
[S, S, 3] (``photos``), category, colour, fabric and store ids, four temporal features
in [0, 1], three Google-trend series of 52 weeks in [0, 1] (min-max scaled,
as the dataset's are) and 12 weeks of normalised sales ``ts`` in [0, 1].
Everything is drawn on the device in a few large calls from a generator
seeded by the run's seed and copied to host memory, where the port's
loaders and clients take it from.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.weights import sub_seed

CHUNK = 256  # photos drawn a call: bounds the device memory the draw takes


def make_products(n: int, image_size: int, vocab: Dict[str, int], seed: int, device,
                  out_len: int = 12) -> Dict[str, np.ndarray]:
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))

    def ints(high):
        return torch.randint(0, high, (n,), generator=gen, device=device,
                             dtype=torch.int64).to(torch.int32).cpu().numpy()

    out = {"cat": ints(vocab["num_cat"]), "col": ints(vocab["num_col"]),
           "fab": ints(vocab["num_fab"]), "store": ints(vocab["num_store"])}
    for key, shape in (("temporal", (n, 4)), ("gtrends", (n, 3, 52)), ("ts", (n, out_len))):
        out[key] = torch.rand(shape, generator=gen, device=device).cpu().numpy()
    images = np.empty((n, image_size, image_size, 3), np.uint8)
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        images[lo:hi] = photos(hi - lo, image_size, gen, device).cpu().numpy()
    out["images"] = images
    return out


def photos(n: int, size: int, gen, device) -> torch.Tensor:
    """``n`` uint8 NHWC photos: a random 8 x 8 colour layout blown up
    bilinearly to ``size`` x ``size``, plus pixel noise (σ 8 levels), so
    that photos differ as product shots do, by colour and shape, and not
    only as white noise does."""
    coarse = torch.rand((n, 3, 8, 8), generator=gen, device=device) * 255.0
    img = torch.nn.functional.interpolate(coarse, size=(size, size), mode="bilinear",
                                          align_corners=False)
    img = img + 8.0 * torch.randn(img.shape, generator=gen, device=device)
    return img.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def rows(products: Dict[str, np.ndarray], idx: np.ndarray) -> Dict[str, np.ndarray]:
    """The batch of ``idx``'s products, with ``mask`` ones."""
    batch = {k: np.ascontiguousarray(v[idx]) for k, v in products.items()}
    batch["mask"] = np.ones(len(idx), np.float32)
    return batch


def to_torch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``, the ids as int64 for the
    reference's embedding lookups."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        out[k] = t.long() if k in ("cat", "col", "fab", "store") else t
    return out
