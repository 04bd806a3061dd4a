"""On-device image normalization, counterpart of
``visuelle2_tpu/data/images.py::normalize_images``.

Only uint8 bytes cross the host-to-device boundary; the ``÷255`` and the
ImageNet mean/std run on the device.  The arithmetic runs in the working
dtype (bf16 on the main path), as in the JAX package, so bf16 rounds at the
same places.
"""

from __future__ import annotations

import torch

IMAGE_SIZE = 299
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(uint8_nhwc: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [..., H, W, 3] -> normalized [..., H, W, 3] in ``dtype``
    (torchvision ``ToTensor`` + ``Normalize``)."""
    dev = uint8_nhwc.device
    x = uint8_nhwc.to(dtype) / torch.tensor(255.0, dtype=dtype, device=dev)
    mean = torch.tensor(IMAGENET_MEAN, dtype=dtype, device=dev)
    std = torch.tensor(IMAGENET_STD, dtype=dtype, device=dev)
    return (x - mean) / std
