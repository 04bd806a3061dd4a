"""The conv-floor read-bandwidth probe: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces ``scripts/perf_pallas_convfloor.py::_pallas_read_reduce``: x [M, K]
bf16 is read once, and each 2048-row tile t gives the (8, 128) f32 partial

    out[8 t + j, c] = Σ_i x[2048 t + 8 i + j, c] + bias[j, c]    (c < 128)

so ``read_reduce(x, bias)`` is [8·M/2048, 128] f32.  With ``full_k=True``
it returns the whole [8·M/2048, K] buffer the kernel writes, whose columns
past 128 hold the same sums without the bias: they are what keeps every
load of x in the kernel, and the card test checks them.  M must be a
multiple of 2048 (the output is defined per tile), K a multiple of 64 and
at least 128.

The kernel is ``csrc/read_reduce.cu`` (its note gives the bound and the
design).  The wrapper takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises — there is no fallback.
``read_reduce.launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from visuelle2_tpu_torch.ops.cuda import _build

TILE_M = 2048
_SLICE_COLS = 64  # columns of x one block reads


def read_reduce_plain(x, bias, *, full_k: bool = False):
    """The same sums in torch: the CPU path and the kernel's reference."""
    m, k = x.shape
    full = x.view(m // TILE_M, TILE_M // 8, 8, k).float().sum(1)
    full[..., :128] += bias
    full = full.reshape(-1, k)
    return full if full_k else full[:, :128]


def _validate(x, bias):
    if x.dtype != torch.bfloat16 or bias.dtype != torch.float32:
        raise ValueError(f"read_reduce takes x in bfloat16 and bias in float32, got "
                         f"{x.dtype} and {bias.dtype}")
    if x.dim() != 2 or tuple(bias.shape) != (8, 128):
        raise ValueError(f"read_reduce: x [M, K] and bias [8, 128] expected, got "
                         f"{tuple(x.shape)} and {tuple(bias.shape)}")
    m, k = x.shape
    if m == 0 or m % TILE_M:
        raise ValueError(f"read_reduce: M={m} must be a positive multiple of {TILE_M} "
                         "(one partial per tile)")
    if k < 128 or k % _SLICE_COLS:
        raise ValueError(f"read_reduce: K={k} must be a multiple of {_SLICE_COLS} and "
                         "at least 128")
    if x.device != bias.device:
        raise ValueError(f"read_reduce: x and bias on one device, got {x.device} and "
                         f"{bias.device}")


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load_library()
    fn = lib.v2t_read_reduce_bf16
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def read_reduce(x, bias, *, full_k: bool = False):
    """x [M, K] bf16, bias [8, 128] f32 -> [8·M/2048, 128] f32 (or the
    [8·M/2048, K] buffer with ``full_k``)."""
    _validate(x, bias)
    if x.device.type == "cpu":
        return read_reduce_plain(x, bias, full_k=full_k)
    if x.device.type != "cuda":
        raise ValueError(f"read_reduce runs on cuda or cpu, not {x.device}")
    for name, t in (("x", x), ("bias", bias)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"read_reduce needs contiguous, 16-byte aligned inputs; "
                             f"{name} is not")
    m, k = x.shape
    lib, fn = _kernel()
    full = torch.empty(8 * (m // TILE_M), k, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), bias.data_ptr(), full.data_ptr(), m, k, stream)
    _build.check(lib, code, "read_reduce")
    read_reduce.launches += 1
    return full if full_k else full[:, :128]


read_reduce.launches = 0
