"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the 700 W power limit), and the least time a piece of
work could take on it.

``f32_accurate_bound_s`` and ``additive_attention_cost`` are frozen copies of
the port's ``ops/cuda/roofline.py`` rule: float32 work may run outside the
tensor cores or as three TF32 products per multiply-add, and the bound takes
the lesser of the two, so a kernel on the tensor cores cannot read above
100% of it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {
    "f32": 67e12,       # float32 outside the tensor cores
    "tf32": 494.7e12,   # tensor cores
    "bf16": 989e12,     # tensor cores
    "int8": 1979e12,    # tensor cores
}
TF32_PRODUCTS_PER_F32 = 3  # 3xTF32: float32 accuracy on the tensor cores
MFU_PEAK = PEAK_OPS_PER_S["bf16"]  # the peak a step's model FLOPs are held to


def bound_s(n_bytes: float, ops: float, kind: str) -> float:
    """The larger of the bytes over the HBM rate and the operations over
    the peak rate of ``kind``."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind])


def f32_accurate_bound_s(n_bytes: float, ops: float) -> float:
    return min(bound_s(n_bytes, ops, "f32"),
               bound_s(n_bytes, TF32_PRODUCTS_PER_F32 * ops, "tf32"))


def additive_attention_cost(B: int, L: int, De: int, Dd: int, A: int, weight_on: str):
    """``(bytes, operations)`` of one ``fused_additive_attention`` call,
    float32: enc, dec and the weights in; out [B, L, Dw] and α [B, L] out;
    enc·We, dec·Wd, the energies' product with v and the scaling."""
    Dw = De if weight_on == "inputs" else A
    n_bytes = 4 * (B * L * De + B * Dd + De * A + Dd * A + A + 1 + B * L * Dw + B * L)
    ops = 2 * B * L * De * A + 2 * B * Dd * A + 2 * B * L * A + B * L * Dw
    return n_bytes, ops
