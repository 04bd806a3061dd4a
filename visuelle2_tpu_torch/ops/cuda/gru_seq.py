"""GRU recurrence over a sequence: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``visuelle2_tpu/ops/pallas/gru_seq.py::fused_gru_sequence``:
x [B, T, I], W_i [I, 3H], W_h [H, 3H], b_i, b_h [3H], h0 [B, H] (zeros when
None) -> (outs [B, T, H], h_T [B, H]), gate order (r, z, n), float32 only.
As in the JAX wrapper, the input projection ``gi = x @ W_i + b_i`` is one
``torch.matmul`` before the kernel, which runs only the recurrence.

The kernel is ``csrc/gru_seq.cu`` (its note gives the bound and the design).
``fused_gru_sequence`` checks its inputs the same way on every device, takes
the plain version (the step loop of ``ops/gru.py``) only for tensors on the
CPU, and for CUDA tensors launches the kernel or raises — there is no
fallback.  ``fused_gru_sequence.launches`` counts the calls that launched the
kernel (one call issues its T step launches on the stream).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from visuelle2_tpu_torch.ops.cuda import _build
from visuelle2_tpu_torch.ops.gru import gru_sequence

_MAX_SMEM_BYTES = 232448  # 227 KB: what one Hopper block may use
_ROWS_PER_BLOCK, _KC = 32, 64  # csrc/gru_seq.cu: the launched tile's rows, slice depth
_STATIC_SMEM_BYTES = 4 * _KC * 3 * 16  # csrc/gru_seq.cu: one W_h slice


# The step loop of ``ops/gru.py``: the CPU path and the kernel's reference.
fused_gru_sequence_plain = gru_sequence


def cudnn_gru(w_i, w_h, b_i, b_h) -> torch.nn.GRU:
    """``torch.nn.GRU`` (cuDNN on the card) computing the same function with
    the same weights, transposed to its layout: the library yardstick that
    the kernel's time is held against.  The port never runs it."""
    I, H3 = w_i.shape
    gru = torch.nn.GRU(I, H3 // 3, batch_first=True, device=w_i.device)
    with torch.no_grad():
        for p, v in ((gru.weight_ih_l0, w_i.t()), (gru.weight_hh_l0, w_h.t()),
                     (gru.bias_ih_l0, b_i), (gru.bias_hh_l0, b_h)):
            p.copy_(v)
    return gru.eval()


def _smem_bytes(H: int) -> int:
    """Dynamic shared memory of one block; layout in csrc/gru_seq.cu."""
    return 4 * _ROWS_PER_BLOCK * (_KC * -(-H // _KC) + 4)


def _validate(named) -> None:
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise ValueError(f"fused_gru_sequence takes float32 only; {name} is {t.dtype}")
    x, w_h = named["x"], named["w_h"]
    if x.dim() != 3 or 0 in x.shape or w_h.dim() != 2 or w_h.shape[0] == 0:
        raise ValueError(f"x [B, T, I] and W_h [H, 3H], all non-empty, expected; got "
                         f"{tuple(x.shape)}, {tuple(w_h.shape)}")
    B, T, I = x.shape
    H = w_h.shape[0]
    want = {"w_i": (I, 3 * H), "w_h": (H, 3 * H), "b_i": (3 * H,), "b_h": (3 * H,),
            "h0": (B, H)}
    bad = {n: tuple(named[n].shape) for n, s in want.items()
           if n in named and tuple(named[n].shape) != s}
    if bad:
        raise ValueError(f"fused_gru_sequence (B={B}, I={I}, H={H}): wrong shapes {bad}; "
                         f"expected { {n: want[n] for n in bad} }")
    devices = {t.device for t in named.values()}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {sorted(map(str, devices))}")
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"fused_gru_sequence needs contiguous inputs; {name} is not")
    smem = _smem_bytes(H) + _STATIC_SMEM_BYTES
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"H={H} needs {smem} bytes of shared memory per block, more "
                         f"than the {_MAX_SMEM_BYTES} a block may use")


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load_library()
    fn = lib.v2t_fused_gru_sequence_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def fused_gru_sequence(x, w_i, w_h, b_i, b_h, h0=None):
    """GRU over x [B, T, I] -> (outs [B, T, H], h_T [B, H]); arguments as in
    the JAX package's ``fused_gru_sequence``."""
    named = dict(x=x, w_i=w_i, w_h=w_h, b_i=b_i, b_h=b_h)
    if h0 is not None:
        named["h0"] = h0
    _validate(named)
    if x.device.type == "cpu":
        return gru_sequence(x, w_i, w_h, b_i, b_h, h0)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gru_sequence runs on cuda or cpu, not {x.device}")
    B, T, I = x.shape
    H = w_h.shape[0]
    lib, fn = _kernel()
    gi = torch.addmm(b_i, x.reshape(B * T, I), w_i).reshape(B, T, 3 * H)
    h0 = x.new_zeros(B, H) if h0 is None else h0
    outs = x.new_empty(B, T, H)
    h_last = x.new_empty(B, H)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(gi.data_ptr(), w_h.data_ptr(), b_h.data_ptr(), h0.data_ptr(),
                  outs.data_ptr(), h_last.data_ptr(), B, T, H, _smem_bytes(H), stream)
    _build.check(lib, code, "fused_gru_sequence")
    fused_gru_sequence.launches += 1
    return outs, h_last


fused_gru_sequence.launches = 0
