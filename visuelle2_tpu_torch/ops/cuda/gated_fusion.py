"""Fused context-conditioned gated residual: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces ``visuelle2_tpu/ops/pallas/gated_fusion.py::fused_gated_residual``:

    g   = σ(x @ Wx + ctx @ Wc + b)
    out = x + x·g   (residual=True)   or   x·g   (residual=False)

x [B, D], ctx [B, C], Wx [D, D], Wc [C, D], b [D]; float32 only (the main
path feeds f32: the pooled image mean is cast to f32 before the fusion).

The kernel is ``csrc/gated_fusion.cu`` (its note gives the bound and the
design).  ``fused_gated_residual`` takes the plain version only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises — there is no
fallback.  ``fused_gated_residual.launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from visuelle2_tpu_torch.ops.cuda import _build

_THREADS_PER_BLOCK = 256
_MAX_SMEM_BYTES = 232448  # 227 KB: what one Hopper block may use


def fused_gated_residual_plain(x, ctx, wx, wc, b, *, residual: bool = True):
    """The same formula in torch: the CPU path and the kernel's reference."""
    g = torch.sigmoid(x @ wx + ctx @ wc + b)
    gated = x * g
    return x + gated if residual else gated


def _smem_bytes(D: int, C: int, rows: int) -> int:
    """Dynamic shared memory of one block; layout in csrc/gated_fusion.cu."""
    return 4 * (D * D + C * D + D + rows * (D + C))


def _validate(x, ctx, wx, wc, b) -> None:
    named = {"x": x, "ctx": ctx, "wx": wx, "wc": wc, "b": b}
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise ValueError(f"fused_gated_residual takes float32 only; "
                             f"{name} is {t.dtype}")
    if x.dim() != 2 or ctx.dim() != 2 or x.shape[0] != ctx.shape[0] or x.shape[0] == 0:
        raise ValueError(f"x [B, D] and ctx [B, C] with B > 0 expected, got "
                         f"{tuple(x.shape)} and {tuple(ctx.shape)}")
    B, D = x.shape
    C = ctx.shape[1]
    if tuple(wx.shape) != (D, D) or tuple(wc.shape) != (C, D) or tuple(b.shape) != (D,):
        raise ValueError(f"weights Wx [{D}, {D}], Wc [{C}, {D}], b [{D}] expected, got "
                         f"{tuple(wx.shape)}, {tuple(wc.shape)}, {tuple(b.shape)}")
    devices = {t.device for t in named.values()}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {sorted(map(str, devices))}")


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load_library()
    fn = lib.v2t_fused_gated_residual_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def fused_gated_residual(x, ctx, wx, wc, b, *, residual: bool = True):
    """x [B, D], ctx [B, C], Wx [D, D], Wc [C, D], b [D] ->
    ``x + x·σ(xWx + ctxWc + b)`` (or the pure gate with residual=False)."""
    _validate(x, ctx, wx, wc, b)
    if x.device.type == "cpu":
        return fused_gated_residual_plain(x, ctx, wx, wc, b, residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gated_residual runs on cuda or cpu, not {x.device}")
    for name, t in (("x", x), ("ctx", ctx), ("wx", wx), ("wc", wc), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"fused_gated_residual needs contiguous inputs; {name} is not")
    B, D = x.shape
    C = ctx.shape[1]
    if D > 1024:
        raise ValueError(f"D={D} > 1024: one thread per output column per block")
    rows = max(1, _THREADS_PER_BLOCK // D)
    smem = _smem_bytes(D, C, rows)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"D={D}, C={C} needs {smem} bytes of shared memory per "
                         f"block, more than the {_MAX_SMEM_BYTES} a block may use")
    lib, fn = _kernel()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), ctx.data_ptr(), wx.data_ptr(), wc.data_ptr(),
                  b.data_ptr(), out.data_ptr(), B, D, C, rows, smem,
                  int(residual), stream)
    _build.check(lib, code, "fused_gated_residual")
    fused_gated_residual.launches += 1
    return out


fused_gated_residual.launches = 0
