"""Bounds on one NVIDIA H100 SXM for the work of each TPU kernel.

A kernel's bound is the least time the card could take for its work: the
larger of the bytes it must move (each distinct input read once, each
output written once) over the HBM rate, and the operations it does over
the card's peak rate for their type (NVIDIA's data sheet, dense rates, at
the 700 W power limit).  The bound is arithmetic on shapes: it needs no card.
``chip_smoke.py`` computes each ported kernel's bound from the shapes of its
run with these functions.
"""

from __future__ import annotations

from visuelle2_tpu_torch.ops.cuda.read_reduce import TILE_M

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {
    "f32": 67e12,     # float32 outside the tensor cores
    "bf16": 989e12,   # tensor cores
    "int8": 1979e12,  # tensor cores
}


def bound_ms(n_bytes: float, ops: float, kind: str = "f32"):
    """(least ms, "bytes" or "operations", whichever sets it)."""
    bytes_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / PEAK_OPS_PER_S[kind]
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def gated_residual_cost(B: int, D: int, C: int):
    """``fused_gated_residual``: x [B, D], ctx [B, C], Wx, Wc, b in; out
    [B, D]; the two products and the gate epilogue, in f32."""
    n_bytes = 4 * (B * D + B * C + D * D + C * D + D + B * D)
    flops = 2 * B * D * (D + C) + 4 * B * D
    return n_bytes, flops


def gated_mha_cost(B: int, Lq: int, Lk: int, D: int, num_heads: int, variant: str,
                   *, self_attention: bool):
    """``fused_gated_mha``, f32.  ``self_attention``: query, key and value
    are one tensor; otherwise key and value are one tensor (the decoder's
    cross-attention over the trend memory), as on the model path.  FLOPs of
    the q/k/v projections, scores, probabilities·v, gate and output
    product, 2 per multiply-add."""
    d = D // num_heads
    G = d if variant == "head" else D
    activations = B * Lq * D if self_attention else B * Lq * D + B * Lk * D
    weights = 4 * D * D + 4 * D + G * G + G
    n_bytes = 4 * (activations + Lq * Lk + weights + B * Lq * D)
    flops = 2 * B * ((Lq + 2 * Lk) * D * D + 2 * Lq * Lk * D + Lq * D * G + Lq * D * D)
    return n_bytes, flops


def additive_attention_cost(B: int, L: int, De: int, Dd: int, A: int, weight_on: str):
    """``fused_additive_attention``, f32: enc, dec and the weights in; out
    [B, L, Dw] and α [B, L] out.  FLOPs of enc·We, dec·Wd, the energy's
    product with v and the scaling, 2 per multiply-add."""
    Dw = De if weight_on == "inputs" else A
    n_bytes = 4 * (B * L * De + B * Dd + De * A + Dd * A + A + 1 + B * L * Dw + B * L)
    flops = 2 * B * L * De * A + 2 * B * Dd * A + 2 * B * L * A + B * L * Dw
    return n_bytes, flops


def gru_sequence_cost(B: int, T: int, H: int):
    """``fused_gru_sequence``'s recurrence, f32 (the input projection runs
    outside it): gi [B, T, 3H], W_h, b_h and h0 in; outs [B, T, H] and h_T
    out.  Per step the [B, H]·[H, 3H] product and about ten operations per
    gate element of the epilogue."""
    n_bytes = 4 * (B * T * 3 * H + 3 * H * H + 3 * H + B * H + B * T * H + B * H)
    flops = T * (2 * B * H * 3 * H + 10 * B * H)
    return n_bytes, flops


def probe_gemm_cost(m: int, k: int, n: int, kind: str):
    """The conv-floor probe GEMMs: x [m, k] · w [k, n].  ``kind`` "bf16":
    bf16 in and out (f32 sums inside); "int8": int8 in, int32 out.  FLOPs
    2 per multiply-add, at the tensor cores' rate for ``kind``."""
    if kind == "bf16":
        n_bytes = 2 * (m * k + k * n + m * n)
    elif kind == "int8":
        n_bytes = m * k + k * n + 4 * m * n
    else:
        raise ValueError(f"kind is 'bf16' or 'int8', not {kind!r}")
    return n_bytes, 2 * m * k * n


def read_reduce_cost(m: int, k: int):
    """The conv-floor read probe: x [m, k] bf16 read once, one (8, 128) f32
    partial written per 2048-row tile, one f32 add per element of x."""
    n_bytes = 2 * m * k + 4 * 8 * 128 * (m // TILE_M)
    return n_bytes, m * k
