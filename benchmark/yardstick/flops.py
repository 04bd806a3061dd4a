"""The benchmark's own count of a forward's and a train step's work, from shapes.

Frozen here so that what an implementation does cannot change what is
counted: the same model at the same shapes counts the same operations
whatever kernels run it.  An operation is one multiply or one add; a
multiply-add counts 2.  Only the products of convolutions and matrix
products (and the additive attention's energies and scaling) are counted.
Element-wise work (BatchNorm, ReLU, softmax, the pool, normalising the
image, the GRU gates) is left out: it is a few per cent of the operations and
is memory-bound, so a roofline over operations would not be set by it.

A backbone's convolutions are a table of their own,
``backbones/<image_arch>_<image_size>.json``, found from the configuration
(``resnet101_299.json`` is a copy of the port's ``perf/roofline.py``
table).  The work outside the backbone is the model family's
``heads_flops`` (``reference/families/<registry>.py``), built from the
counts below.

A convolution's taps that fall on its zero padding are not counted, as
XLA's cost analysis does not count them (counting them would add 0.93 GFLOP
a sample, 3.3%).  At 299 x 299 the table gives 27.99 GFLOP a sample for the
backbone, and with gated_v4's heads (0.07) 28.07, against the 28.18 that
XLA's cost analysis gave for the whole gated_v4 forward (``bench.py``).  The
0.11 GFLOP between them is XLA's count of element-wise work left out here
(BatchNorm, ReLU, the pool, the image normalisation, softmax);
``tests/test_bench_flops.py`` holds the two within 1%.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

BACKBONES = Path(__file__).resolve().parent / "backbones"
TREND_LEN = 52
NUM_TRENDS = 3


@functools.lru_cache(maxsize=None)
def backbone_table(arch: str = "resnet101", image: int = 299) -> dict:
    """``backbones/<arch>_<image>.json``: ``convs`` (name, H_in, C_in,
    C_out, k, stride, count), ``out_channels``, the frozen stages' name
    prefixes and the first trainable convolutions."""
    path = BACKBONES / f"{arch}_{image}.json"
    if not path.is_file():
        raise KeyError(f"no convolution table for {arch} at {image}: add {path}")
    with open(path) as f:
        table = json.load(f)
    table["convs"] = [tuple(c) for c in table["convs"]]
    return table


def conv_out_dim(h: int, k: int, stride: int) -> int:
    pad = k // 2
    return (h + 2 * pad - k) // stride + 1


def valid_taps(h_in: int, k: int, stride: int) -> int:
    """Along one spatial dim, the kernel taps over all outputs that fall on
    the input and not on its zero padding."""
    pad = k // 2
    return sum(0 <= o * stride - pad + t < h_in
               for o in range(conv_out_dim(h_in, k, stride)) for t in range(k))


def conv_flops(h_in: int, c_in: int, c_out: int, k: int, stride: int) -> int:
    """One sample's convolution: 2 x C_out x C_in x the taps on the input
    (square images), as XLA's cost analysis counts it: a tap on the zero
    padding is work the input does not need."""
    taps = valid_taps(h_in, k, stride)
    return 2 * taps * taps * c_out * c_in


def backbone_forward_flops(arch: str = "resnet101", image: int = 299) -> int:
    """The backbone's convolutions, one sample."""
    return sum(conv_flops(h, ci, co, k, s) * n
               for _, h, ci, co, k, s, n in backbone_table(arch, image)["convs"])


def backbone_train_flops(arch: str = "resnet101", image: int = 299) -> int:
    """One sample's forward and backward under the freeze split: every
    convolution forward; the trainable stages backward at twice their
    forward (input and weight gradients), except that the first trainable
    convolutions (whose input is a frozen stage's output) need only their
    weight gradient; nothing of the frozen stages backward."""
    table = backbone_table(arch, image)
    frozen, first = tuple(table["frozen_stages"]), set(table["first_trainable"])
    total = 0
    for name, h, ci, co, k, s, n in table["convs"]:
        f = conv_flops(h, ci, co, k, s) * n
        total += f
        if name.startswith(frozen):
            continue
        total += f if name in first else 2 * f
    return total


def backbone_bytes(batch: int, arch: str = "resnet101", image: int = 299,
                   act_bytes: int = 2, weight_bytes: int = 4) -> int:
    """The least a backbone call must move: its input image batch in the
    working dtype, every convolution's weight once (float32 masters, cast
    on the way in) and its output [B, C, h, w] in the working dtype (a
    ResNet halves the image five times)."""
    table = backbone_table(arch, image)
    weights = sum(ci * co * k * k * n for _, _, ci, co, k, _, n in table["convs"])
    h_out = image
    for k, s in ((7, 2), (3, 2), (3, 2), (3, 2), (3, 2)):
        h_out = conv_out_dim(h_out, k, s)
    return (batch * image * image * 3 * act_bytes + weights * weight_bytes
            + batch * table["out_channels"] * h_out * h_out * act_bytes)


def linear_flops(rows: int, d_in: int, d_out: int) -> int:
    return 2 * rows * d_in * d_out


def mha_flops(lq: int, lk: int, d: int) -> int:
    """q, k, v, out projections and the scores and weighted sum."""
    proj = linear_flops(lq, d, d) * 2 + linear_flops(lk, d, d) * 2
    return proj + 2 * 2 * lq * lk * d


def gru_flops(steps: int, d_in: int, h: int) -> int:
    return steps * (linear_flops(1, d_in, 3 * h) + linear_flops(1, h, 3 * h))


def additive_attention_flops(L: int, De: int, Dd: int, A: int, weight_on: str) -> int:
    """One row of ``fused_additive_attention`` (the port's ``ops/cuda/
    roofline.py`` count): enc·We, dec·Wd, the energies' product with v and
    the scaling, 2 a multiply-add."""
    Dw = De if weight_on == "inputs" else A
    return 2 * L * De * A + 2 * Dd * A + 2 * L * A + L * Dw


def heads_flops(model: dict) -> int:
    """One row outside the backbone, by the model family's own count."""
    from benchmark.reference.model import family

    return family(model["registry"]).heads_flops(model)


def forward_flops_per_row(config: dict) -> int:
    """One row's forward for a configuration file's contents."""
    m = config["model"]
    return backbone_forward_flops(m["image_arch"], config["image_size"]) + heads_flops(m)


def train_flops_per_row(config: dict) -> int:
    """Forward and backward of one row: the backbone by the freeze split,
    the heads at three times their forward (every head trains)."""
    m = config["model"]
    return backbone_train_flops(m["image_arch"], config["image_size"]) + 3 * heads_flops(m)
