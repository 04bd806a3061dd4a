"""Fused context-conditioned gated residual: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces ``visuelle2_tpu/ops/pallas/gated_fusion.py::fused_gated_residual``:

    g   = σ(x @ Wx + ctx @ Wc + b)
    out = x + x·g   (residual=True)   or   x·g   (residual=False)

x [B, D], ctx [B, C], Wx [D, D], Wc [C, D], b [D]; float32 only (the main
path feeds f32: the pooled image mean is cast to f32 before the fusion).

The kernel is ``csrc/gated_fusion.cu`` (its note gives the bound and the
design): each output's (D + C)-long sum cut into interleaved k-splits over
lanes and warps, summed in a fixed order.  ``launch_plan`` sizes the grid
and the splits.  ``fused_gated_residual`` takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises —
there is no fallback.  ``fused_gated_residual.launches`` counts the kernel
launches.

Where an input needs a gradient the call runs under a
``torch.autograd.Function`` (``_GatedResidual``): its forward is the kernel on
the card (the plain version on the CPU), its backward the formula in torch
ops on both devices, with g recomputed from the saved inputs:

    dpre = dout·x·g(1−g)
    dx   = dout·(1+g) (residual) or dout·g (pure), + dpre·Wxᵀ
    dctx = dpre·Wcᵀ,  dWx = xᵀ·dpre,  dWc = ctxᵀ·dpre,  db = Σ_rows dpre

The Pallas original has no VJP (the JAX package trains on the XLA formula),
so there is no backward kernel: the backward launches none.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from visuelle2_tpu_torch.ops.cuda import _build

_WARP, _MAX_WARPS = 32, 8
_TERMS = 8       # about this many terms in each k-split's partial sum
_H100_SMS = 132
_MAX_GRID_Y = 65535


def fused_gated_residual_plain(x, ctx, wx, wc, b, *, residual: bool = True):
    """The same formula in torch: the CPU path and the kernel's reference."""
    g = torch.sigmoid(x @ wx + ctx @ wc + b)
    gated = x * g
    return x + gated if residual else gated


def launch_plan(B: int, D: int, C: int, *, vec: int, sms: int = _H100_SMS) -> dict:
    """How a call runs (csrc/gated_fusion.cu): ``vec`` columns a unit (4
    where D % 4 == 0 and the weights are 16-byte aligned, else 1); ``cub``
    units a CTA's column tile, the least power of two up to 32 that holds
    them; its lanes split into the units and ``32 // cub`` k-splits, and
    ``warps`` warps (up to 8) make ``splits`` k-splits of about 8 of the
    D + C terms each; ``rows`` rows a CTA, the fewest of 1, 2 and 4 that
    keep the grid within two CTAs an SM; ``grid`` (row tiles, column
    tiles).  Raises ValueError past the 65,535 column tiles a grid may have
    (D over 8.3 million)."""
    units = D // vec
    cub = min(_WARP, 1 << max(0, units - 1).bit_length())
    ksub = _WARP // cub
    warps = min(_MAX_WARPS, max(1, -(-(D + C) // (ksub * _TERMS))))
    col_tiles = -(-units // cub)
    if col_tiles > _MAX_GRID_Y:
        raise ValueError(f"D={D} needs {col_tiles} column tiles, more than the "
                         f"{_MAX_GRID_Y} a grid may have")
    rows = next((r for r in (1, 2) if -(-B // r) * col_tiles <= 2 * sms), 4)
    return {"vec": vec, "cub": cub, "warps": warps, "splits": ksub * warps, "rows": rows,
            "grid": (-(-B // rows), col_tiles)}


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
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def gated_residual_backward(dout, x, ctx, wx, wc, b, *, residual: bool = True,
                            needs=(True,) * 5):
    """(dx, dctx, dWx, dWc, db) of the gated residual at ``dout``; a gradient
    whose ``needs`` entry is false is None."""
    g = torch.sigmoid(x @ wx + ctx @ wc + b)
    dpre = dout * x * g * (1 - g)
    dx = dctx = dwx = dwc = db = None
    if needs[0]:
        dx = (dout * (1 + g) if residual else dout * g) + dpre @ wx.t()
    if needs[1]:
        dctx = dpre @ wc.t()
    if needs[2]:
        dwx = x.t() @ dpre
    if needs[3]:
        dwc = ctx.t() @ dpre
    if needs[4]:
        db = dpre.sum(0)
    return dx, dctx, dwx, dwc, db


class _GatedResidual(torch.autograd.Function):
    """The kernel (plain on the CPU) forward, the formula backward."""

    @staticmethod
    def forward(ctx, x, context, wx, wc, b, residual):
        ctx.residual = residual
        ctx.save_for_backward(x, context, wx, wc, b)
        return _forward(x, context, wx, wc, b, residual)

    @staticmethod
    def backward(ctx, dout):
        grads = gated_residual_backward(dout, *ctx.saved_tensors, residual=ctx.residual,
                                        needs=ctx.needs_input_grad[:5])
        return (*grads, None)


def fused_gated_residual(x, ctx, wx, wc, b, *, residual: bool = True):
    """x [B, D], ctx [B, C], Wx [D, D], Wc [C, D], b [D] ->
    ``x + x·σ(xWx + ctxWc + b)`` (or the pure gate with residual=False);
    under autograd where an input needs a gradient."""
    _validate(x, ctx, wx, wc, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, ctx, wx, wc, b)):
        return _GatedResidual.apply(x, ctx, wx, wc, b, residual)
    return _forward(x, ctx, wx, wc, b, residual)


def _forward(x, ctx, wx, wc, b, residual: bool):
    """The validated call: the plain version for CPU tensors, else the kernel."""
    if x.device.type == "cpu":
        return fused_gated_residual_plain(x, ctx, wx, wc, b, residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gated_residual runs on cuda or cpu, not {x.device}")
    for name, t in (("x", x), ("ctx", ctx), ("wx", wx), ("wc", wc), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"fused_gated_residual needs contiguous inputs; {name} is not")
    B, D = x.shape
    C = ctx.shape[1]
    aligned = wx.data_ptr() % 16 == 0 and (C == 0 or wc.data_ptr() % 16 == 0)
    plan = launch_plan(B, D, C, vec=4 if D % 4 == 0 and aligned else 1,
                       sms=torch.cuda.get_device_properties(x.device).multi_processor_count)
    lib, fn = _kernel()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), ctx.data_ptr(), wx.data_ptr(), wc.data_ptr(),
                  b.data_ptr(), out.data_ptr(), B, D, C, int(residual), plan["rows"],
                  plan["vec"], plan["cub"], plan["warps"], stream)
    _build.check(lib, code, "fused_gated_residual")
    fused_gated_residual.launches += 1
    return out


fused_gated_residual.launches = 0
