"""Fused multi-head attention with the gated_v2 epilogues: the CUDA kernel's
wrapper and its plain PyTorch version.

Replaces ``visuelle2_tpu/ops/pallas/gated_mha.py::fused_gated_mha``:

    q, k, v = query @ Wq + bq, key @ Wk + bk, value @ Wv + bv
    ctx_h   = softmax(q_h·k_hᵀ·d^-½ + mask)·v_h                per head
    head:   y = merge(ctx_h ⊙ σ(q_h @ Wg + bg)) @ Wo + bo     Wg [d, d]
    pure:   y = (merge(ctx) ⊙ σ(query @ Wg + bg)) @ Wo + bo   Wg [D, D]

query [B, Lq, D], key/value [B, Lk, D], mask [Lq, Lk] additive (zeros for
no mask), weights in the JAX ``[in, out]`` layout; float32 only.

The kernel is ``csrc/gated_mha.cu`` (its note gives the bound and the
design).  ``fused_gated_mha`` checks its inputs the same way on every device,
takes the plain version only for tensors on the CPU, and for CUDA tensors
launches the kernel or raises — there is no fallback.
``fused_gated_mha.launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from visuelle2_tpu_torch.ops.cuda import _build
from visuelle2_tpu_torch.ops.heads import merge_heads, split_heads

_THREADS_PER_BLOCK = 512
_MAX_SMEM_BYTES = 232448  # 227 KB: what one Hopper block may use
VARIANTS = ("pure", "head")


def fused_gated_mha_plain(query, key, value, mask, wq, bq, wk, bk, wv, bv,
                          wg, bg, wo, bo, *, num_heads: int, variant: str = "pure"):
    """The XLA formula of ``_GatedMHABase`` in torch: the CPU path and the
    kernel's reference."""
    d = query.shape[-1] // num_heads
    qh = split_heads(query @ wq + bq, num_heads)
    kh = split_heads(key @ wk + bk, num_heads)
    vh = split_heads(value @ wv + bv, num_heads)
    scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * (d ** -0.5) + mask
    ctx = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), vh)
    if variant == "head":
        merged = merge_heads(ctx * torch.sigmoid(qh @ wg + bg))
    else:
        merged = merge_heads(ctx) * torch.sigmoid(query @ wg + bg)
    return merged @ wo + bo


def _smem_bytes(Lq: int, Lk: int, D: int) -> int:
    """Dynamic shared memory of one block; layout in csrc/gated_mha.cu."""
    warps = _THREADS_PER_BLOCK // 32
    return 4 * (3 * Lq * D + 3 * Lk * D + Lk * (D + 1) + warps * Lk)


def _validate(named, *, num_heads: int, variant: str) -> None:
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise ValueError(f"fused_gated_mha takes float32 only; {name} is {t.dtype}")
    query, key, value = named["query"], named["key"], named["value"]
    if query.dim() != 3 or key.dim() != 3 or key.shape != value.shape \
            or query.shape[0] != key.shape[0] or query.shape[2] != key.shape[2] \
            or 0 in query.shape or 0 in key.shape:
        raise ValueError(f"query [B, Lq, D] and key, value [B, Lk, D], all non-empty, "
                         f"expected; got {tuple(query.shape)}, {tuple(key.shape)}, "
                         f"{tuple(value.shape)}")
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    B, Lq, D = query.shape
    Lk = key.shape[1]
    if num_heads < 1 or D % num_heads:
        raise ValueError(f"D={D} does not split into {num_heads} heads")
    G = D // num_heads if variant == "head" else D
    want = {"mask": (Lq, Lk), "wq": (D, D), "bq": (D,), "wk": (D, D), "bk": (D,),
            "wv": (D, D), "bv": (D,), "wg": (G, G), "bg": (G,), "wo": (D, D),
            "bo": (D,)}
    bad = {n: tuple(named[n].shape) for n, s in want.items() if tuple(named[n].shape) != s}
    if bad:
        raise ValueError(f"fused_gated_mha ({variant}, D={D}, {num_heads} heads, "
                         f"Lq={Lq}, Lk={Lk}): wrong shapes {bad}; expected "
                         f"{ {n: want[n] for n in bad} }")
    devices = {t.device for t in named.values()}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {sorted(map(str, devices))}")
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"fused_gated_mha needs contiguous inputs; {name} is not")
    smem = _smem_bytes(Lq, Lk, D)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"Lq={Lq}, Lk={Lk}, D={D} needs {smem} bytes of shared memory "
                         f"per block, more than the {_MAX_SMEM_BYTES} a block may use")


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load_library()
    fn = lib.v2t_fused_gated_mha_f32
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def fused_gated_mha(query, key, value, mask, wq, bq, wk, bk, wv, bv, wg, bg, wo, bo,
                    *, num_heads: int, variant: str = "pure"):
    """Gated multi-head attention -> [B, Lq, D]; arguments as in the JAX
    package's ``fused_gated_mha``."""
    named = dict(query=query, key=key, value=value, mask=mask, wq=wq, bq=bq, wk=wk,
                 bk=bk, wv=wv, bv=bv, wg=wg, bg=bg, wo=wo, bo=bo)
    _validate(named, num_heads=num_heads, variant=variant)
    if query.device.type == "cpu":
        return fused_gated_mha_plain(*named.values(), num_heads=num_heads,
                                     variant=variant)
    if query.device.type != "cuda":
        raise ValueError(f"fused_gated_mha runs on cuda or cpu, not {query.device}")
    B, Lq, D = query.shape
    Lk = key.shape[1]
    lib, fn = _kernel()
    out = torch.empty_like(query)
    # d^-½ as the JAX package forms it: a Python float, rounded to float32.
    scale = (D // num_heads) ** -0.5
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        code = fn(*(t.data_ptr() for t in named.values()), out.data_ptr(),
                  B, Lq, Lk, D, num_heads, scale, int(variant == "head"),
                  _THREADS_PER_BLOCK, _smem_bytes(Lq, Lk, D), stream)
    _build.check(lib, code, "fused_gated_mha")
    fused_gated_mha.launches += 1
    return out


fused_gated_mha.launches = 0
