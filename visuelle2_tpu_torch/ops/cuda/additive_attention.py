"""Fused Bahdanau additive attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``visuelle2_tpu/ops/pallas/additive_attention.py::fused_additive_attention``:

    h = enc @ We,  s = dec @ Wd,  e = tanh(h + s) @ v + vb,  α = softmax_L(e)
    out = α ⊙ enc   (weight_on="inputs")   or   α ⊙ h   ("projected")

enc [B, L, De], dec [B, Dd], We [De, A], Wd [Dd, A], v [A, 1], vb [1] ->
(out [B, L, Dw], α [B, L]), Dw = De for "inputs" and A for "projected";
float32 only.

The kernel is ``csrc/additive_attention.cu`` (its note gives the bound and
the design).  ``fused_additive_attention`` checks its inputs the same way on
every device, takes the plain version only for tensors on the CPU, and for
CUDA tensors launches the kernel or raises — there is no fallback.
``fused_additive_attention.launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from visuelle2_tpu_torch.ops.cuda import _build

_MAX_SMEM_BYTES = 232448  # 227 KB: what one Hopper block may use
WEIGHT_ON = ("inputs", "projected")
_THREADS = 256  # csrc/additive_attention.cu: kThreads


def fused_additive_attention_plain(enc, dec, we, wd, v, vb, *, weight_on: str = "inputs"):
    """The XLA formula of ``AdditiveAttention`` in torch: the CPU path and
    the kernel's reference."""
    h = enc @ we
    s = dec @ wd
    energy = (torch.tanh(h + s[:, None, :]) @ v)[..., 0] + vb[0]
    alpha = torch.softmax(energy, dim=1)
    base = enc if weight_on == "inputs" else h
    return alpha[..., None] * base, alpha


def _tile(rows: int):
    """(rows, columns) of h each energy thread keeps, by the B·L rows of the
    call; a block covers 16× as many of each.  Few rows (the fused tokens)
    take small tiles, so that the call still has many blocks."""
    return (1, 4) if rows <= 2048 else (8, 8)


def _smem_bytes(L: int) -> int:
    """Dynamic shared memory of the softmax block; layout in
    csrc/additive_attention.cu (the other three kernels' is static, under 48 KB)."""
    return 4 * (L + _THREADS // 32)


def _validate(named, *, weight_on: str) -> None:
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise ValueError(f"fused_additive_attention takes float32 only; "
                             f"{name} is {t.dtype}")
    if weight_on not in WEIGHT_ON:
        raise ValueError(f"weight_on {weight_on!r} is not one of {WEIGHT_ON}")
    enc, dec = named["enc"], named["dec"]
    if enc.dim() != 3 or dec.dim() != 2 or enc.shape[0] != dec.shape[0] \
            or 0 in enc.shape or 0 in dec.shape:
        raise ValueError(f"enc [B, L, De] and dec [B, Dd], all non-empty, expected; "
                         f"got {tuple(enc.shape)}, {tuple(dec.shape)}")
    B, L, De = enc.shape
    Dd = dec.shape[1]
    A = named["we"].shape[-1]
    want = {"we": (De, A), "wd": (Dd, A), "v": (A, 1), "vb": (1,)}
    bad = {n: tuple(named[n].shape) for n, s in want.items() if tuple(named[n].shape) != s}
    if bad or A == 0:
        raise ValueError(f"fused_additive_attention (De={De}, Dd={Dd}, A={A}): wrong "
                         f"shapes {bad}; expected We [De, A], Wd [Dd, A], v [A, 1], "
                         f"vb [1], A > 0")
    devices = {t.device for t in named.values()}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {sorted(map(str, devices))}")
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"fused_additive_attention needs contiguous inputs; "
                             f"{name} is not")
    smem = _smem_bytes(L)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"L={L} needs {smem} bytes of shared memory per block, more "
                         f"than the {_MAX_SMEM_BYTES} a block may use")


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load_library()
    fn = lib.v2t_fused_additive_attention_f32
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def fused_additive_attention(enc, dec, we, wd, v, vb, *, weight_on: str = "inputs"):
    """Additive attention -> (out [B, L, Dw], α [B, L]); arguments as in the
    JAX package's ``fused_additive_attention``."""
    named = dict(enc=enc, dec=dec, we=we, wd=wd, v=v, vb=vb)
    _validate(named, weight_on=weight_on)
    if enc.device.type == "cpu":
        return fused_additive_attention_plain(*named.values(), weight_on=weight_on)
    if enc.device.type != "cuda":
        raise ValueError(f"fused_additive_attention runs on cuda or cpu, not {enc.device}")
    B, L, De = enc.shape
    Dd, A = wd.shape
    projected = weight_on == "projected"
    lib, fn = _kernel()
    out = enc.new_empty(B, L, A if projected else De)
    alpha = enc.new_empty(B, L)
    rows, cols = _tile(B * L)
    # Scratch: S = dec @ Wd, and one partial energy per block of 16·cols
    # columns of A.
    s = enc.new_empty(B, A)
    e_part = enc.new_empty(B, -(-A // (16 * cols)), L)
    with torch.cuda.device(enc.device):
        stream = torch.cuda.current_stream(enc.device).cuda_stream
        code = fn(*(t.data_ptr() for t in (*named.values(), out, alpha, s, e_part)),
                  B, L, De, Dd, A, int(projected), rows, cols, _smem_bytes(L), stream)
    _build.check(lib, code, "fused_additive_attention")
    fused_additive_attention.launches += 1
    return out, alpha


fused_additive_attention.launches = 0
