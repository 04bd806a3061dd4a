"""The conv-floor probe GEMMs: the CUDA kernels' wrappers and their plain
PyTorch versions.

Replace ``scripts/perf_pallas_convfloor.py::_pallas_matmul`` and
``::_pallas_matmul_int8``:

    matmul_bf16(x, w)  x [M, K] bf16 · w [K, N] bf16 -> [M, N] bf16, the
                       f32 sum rounded to bf16 once
    matmul_int8(x, w)  x [M, K] int8 · w [K, N] int8 -> [M, N] int32, exact

The kernels are ``csrc/probe_gemm_bf16.cu`` (bf16: TMA and wgmma, a
persistent grid) and ``csrc/probe_gemm.cu`` (int8: cp.async and mma.sync);
each file's note gives the bound and the design.  Both take any M >= 1 (the
ragged last row tile is masked in the kernel), N in {64, 128, 256, 512} and K
a multiple of the 128-byte chunk they stage x in (64 bf16, 128 int8).  Both
keep all of w in one block's shared memory, which bounds K for each N
(``smem_bytes``): in bf16 K <= 1536, 768, 384, 192 at N = 64, 128, 256, 512
(w plus at least two stages of x), in int8 K <= 1536, 1280, 768, 384; past
that a wrapper raises on CUDA tensors.  A wrapper takes the plain version
only for tensors on the CPU (at any K); for CUDA tensors it launches the
kernel or raises — there is no fallback.  Each wrapper's ``launches``
counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from visuelle2_tpu_torch.ops.cuda import _build

_MAX_SMEM_BYTES = 232448  # 227 KB: what one Hopper block may use
_CHUNK_BYTES = 128  # bytes of one x row that either kernel stages at a time
# csrc/probe_gemm.cu (int8): ring depth, warps and warp tile.
_STAGES, _WARPS, _WARP_ROWS, _WARP_COLS = 4, 8, 32, 64
# csrc/probe_gemm_bf16.cu: most ring stages, alignment slack + barriers.
_BF16_MAX_STAGES, _BF16_FIXED_BYTES = 8, 1024 + 256
N_ALLOWED = (64, 128, 256, 512)


def matmul_bf16_plain(x, w):
    """bf16 of the f32 product: the CPU path and the kernel's reference."""
    return (x.float() @ w.float()).to(torch.bfloat16)


def matmul_int8_plain(x, w):
    """The exact int32 product, on the CPU and on CUDA: float64 holds every
    partial sum of int8 products exactly (each at most 2^14), and
    ``torch.matmul`` has no int32 CUDA path."""
    return (x.double() @ w.double()).round().to(torch.int32)


def bf16_tolerance(x, w, want):
    """Largest |kernel − plain| allowed for ``matmul_bf16``: one bf16 ulp of
    the result (rtol 2^-7) beyond twice the f32 sums' reordering bound,
    K·2^-24·(|x|·|w|) for each sum (Higham's γ_K).  Both sides round an f32
    sum of the same products to bf16 once, in another order; the JAX probe's
    own parity check allows 2e-2 (``scripts/perf_pallas_convfloor.py:336``),
    which this bound stays well inside."""
    k = x.shape[1]
    return 2.0 ** -7 * want.float().abs() + 2 * k * 2.0 ** -24 * (x.float().abs() @ w.float().abs())


def bf16_tile_rows(N: int) -> int:
    """Rows of the bf16 kernel's tile: 128, or 64 at N = 512, where each
    consumer warpgroup takes half of the columns."""
    return 64 if N > 256 else 128


def bf16_stages(K: int, N: int) -> int:
    """Stages of x the bf16 kernel's ring gets beside w: as many as fit,
    at most eight (below 2 the shape does not fit)."""
    free = _MAX_SMEM_BYTES - _BF16_FIXED_BYTES - K * N * 2
    return min(_BF16_MAX_STAGES, free // (bf16_tile_rows(N) * _CHUNK_BYTES))


def smem_bytes(K: int, N: int, esize: int) -> int:
    """Dynamic shared memory of one block of the kernel for ``esize``-byte
    inputs (2: bf16, 1: int8); layouts in the kernels' sources.  Past
    227 KB when the shape does not fit."""
    if esize == 2:
        stages = max(2, bf16_stages(K, N))
        return _BF16_FIXED_BYTES + K * N * 2 + stages * bf16_tile_rows(N) * _CHUNK_BYTES
    bm = _WARP_ROWS * (_WARPS // (N // _WARP_COLS))
    return K * N * esize + _STAGES * bm * _CHUNK_BYTES


def _validate(name, x, w, dtype):
    for arg, t in (("x", x), ("w", w)):
        if t.dtype != dtype:
            raise ValueError(f"{name} takes {dtype} only; {arg} is {t.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] or x.shape[0] == 0:
        raise ValueError(f"{name}: x [M, K] and w [K, N] with M > 0 expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    K, N = w.shape
    chunk = _CHUNK_BYTES // x.element_size()
    if K % chunk or K == 0:
        raise ValueError(f"{name}: K={K} must be a positive multiple of {chunk}")
    if N not in N_ALLOWED:
        raise ValueError(f"{name}: N={N} must be one of {N_ALLOWED}")
    if x.device != w.device:
        raise ValueError(f"{name}: x and w on one device, got {x.device} and {w.device}")


@functools.lru_cache(maxsize=None)
def _kernel(symbol):
    lib = _build.load_library()
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _launch(name, symbol, x, w, out_dtype):
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    for arg, t in (("x", x), ("w", w)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} needs contiguous, 16-byte aligned inputs; {arg} is not")
    (M, K), N = x.shape, w.shape[1]
    smem = smem_bytes(K, N, x.element_size())
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"{name}: K={K}, N={N} needs {smem} bytes of shared memory per "
                         f"block, more than the {_MAX_SMEM_BYTES} a block may use")
    lib, fn = _kernel(symbol)
    out = torch.empty(M, N, dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N, smem, stream)
    _build.check(lib, code, name)
    return out


def matmul_bf16(x, w):
    """x [M, K] bf16 · w [K, N] bf16 -> [M, N] bf16 (f32 sums)."""
    _validate("matmul_bf16", x, w, torch.bfloat16)
    if x.device.type == "cpu":
        return matmul_bf16_plain(x, w)
    out = _launch("matmul_bf16", "v2t_probe_matmul_bf16", x, w, torch.bfloat16)
    matmul_bf16.launches += 1
    return out


def matmul_int8(x, w):
    """x [M, K] int8 · w [K, N] int8 -> [M, N] int32, exact."""
    _validate("matmul_int8", x, w, torch.int8)
    if x.device.type == "cpu":
        return matmul_int8_plain(x, w)
    out = _launch("matmul_int8", "v2t_probe_matmul_int8", x, w, torch.int32)
    matmul_int8.launches += 1
    return out


matmul_bf16.launches = 0
matmul_int8.launches = 0
