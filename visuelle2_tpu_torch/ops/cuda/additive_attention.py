"""Fused Bahdanau additive attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``visuelle2_tpu/ops/pallas/additive_attention.py::fused_additive_attention``:

    h = enc @ We,  s = dec @ Wd,  e = tanh(h + s) @ v + vb,  α = softmax_L(e)
    out = α ⊙ enc   (weight_on="inputs")   or   α ⊙ h   ("projected")

enc [B, L, De], dec [B, Dd], We [De, A], Wd [Dd, A], v [A, 1], vb [1] ->
(out [B, L, Dw], α [B, L]), Dw = De for "inputs" and A for "projected";
float32 only.

The kernel is ``csrc/additive_attention.cu`` (its note gives the bound and
the design): two launches a call, a grouped GEMM for h = enc·We and s =
dec·Wd on the tensor cores in 3xTF32 (three TF32 ``wgmma`` products per
multiply-add, their sum restarted each 32-deep chunk and the chunks added in
float32), then one block per batch row for the energies, the softmax and the
scaling.  ``launch_plan`` picks the GEMM's tile width from the shape.
``fused_additive_attention`` checks its inputs the same way on every device,
takes the plain version only for tensors on the CPU, and for CUDA tensors
launches the kernel or raises — there is no fallback.
``fused_additive_attention.launches`` counts the calls that launched it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from visuelle2_tpu_torch.ops.cuda import _build

_MAX_SMEM_BYTES = 232448  # 227 KB: what one Hopper block may use
WEIGHT_ON = ("inputs", "projected")
# csrc/additive_attention.cu: the GEMM's tile rows and column widths, and
# the attend block's warps.
_BM, _BNS = 128, (128, 104, 64, 32)
_ATTEND_WARPS = 32
_H100_SMS = 132
# The cost model's fixed cost of a tile, in columns of work: loading and
# splitting its 128 rows of enc, which every tile does whatever its width.
_TILE_OVERHEAD = 64


def fused_additive_attention_plain(enc, dec, we, wd, v, vb, *, weight_on: str = "inputs"):
    """The XLA formula of ``AdditiveAttention`` in torch: the CPU path and
    the kernel's reference."""
    h = enc @ we
    s = dec @ wd
    energy = (torch.tanh(h + s[:, None, :]) @ v)[..., 0] + vb[0]
    alpha = torch.softmax(energy, dim=1)
    base = enc if weight_on == "inputs" else h
    return alpha[..., None] * base, alpha


def launch_plan(B: int, L: int, De: int, Dd: int, A: int, *, projected: bool,
                sms: int = _H100_SMS) -> dict:
    """How a call runs: the GEMM's tile width (bn columns of 128 rows),
    where h goes and the attend block's shared memory.

    The GEMM's tiles are the ceil(B·L / 128) row tiles of enc and the
    ceil(B / 128) of dec, each by ceil(A / bn) column tiles, at one block an
    SM on ``sms`` SMs.  bn is the one that least costs the SM with the most
    tiles, ceil(tiles / sms) x (bn + a tile's fixed cost), the wider on a
    tie.  h goes to out itself ("projected"), to out's rows when they are
    wide enough ("inputs", A <= De: launch 2 overwrites them), else to a
    scratch [B, L, A] (``h_in_out`` false); s = dec·Wd always to a scratch
    [B, A]."""
    rows = -(-(B * L) // _BM) + -(-B // _BM)
    bn = min(_BNS, key=lambda n: math.ceil(rows * -(-A // n) / sms) * (n + _TILE_OVERHEAD))
    h_in_out = projected or A <= De
    return {"bn": bn, "h_in_out": h_in_out,
            "ldh": A if projected or not h_in_out else De,
            "smem_attend": 4 * (2 * A + L + _ATTEND_WARPS)}


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
    smem = launch_plan(B, L, De, Dd, A, projected=weight_on == "projected")["smem_attend"]
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"L={L}, A={A} needs {smem} bytes of shared memory per block, more "
                         f"than the {_MAX_SMEM_BYTES} a block may use")


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load_library()
    fn = lib.v2t_additive_attention_f32
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
    plan = launch_plan(B, L, De, Dd, A, projected=projected,
                       sms=torch.cuda.get_device_properties(enc.device).multi_processor_count)
    result = _launch(named, projected, plan)
    fused_additive_attention.launches += 1
    return result


def buffers(enc, A: int, projected: bool, plan: dict):
    """The call's outputs and scratch by ``plan``: out [B, L, Dw], α [B, L],
    s = dec·Wd [B, A], and h (out itself, or [B, L, A])."""
    B, L, De = enc.shape
    out = enc.new_empty(B, L, A if projected else De)
    h = out if plan["h_in_out"] else enc.new_empty(B, L, A)
    return out, enc.new_empty(B, L), enc.new_empty(B, A), h


def _launch(named, projected: bool, plan: dict):
    """Run the kernel on validated CUDA inputs by ``plan``."""
    enc, wd = named["enc"], named["wd"]
    B, L, De = enc.shape
    Dd, A = wd.shape
    lib, fn = _kernel()
    out, alpha, s, h = buffers(enc, A, projected, plan)
    with torch.cuda.device(enc.device):
        stream = torch.cuda.current_stream(enc.device).cuda_stream
        code = fn(*(t.data_ptr() for t in (*named.values(), out, alpha, s, h)),
                  B, L, De, Dd, A, plan["ldh"], int(projected), plan["bn"],
                  plan["smem_attend"], stream)
    _build.check(lib, code, "fused_additive_attention")
    return out, alpha


fused_additive_attention.launches = 0
