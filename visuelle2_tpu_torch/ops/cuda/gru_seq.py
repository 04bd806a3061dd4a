"""GRU recurrence over a sequence: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``visuelle2_tpu/ops/pallas/gru_seq.py::fused_gru_sequence``:
x [B, T, I], W_i [I, 3H], W_h [H, 3H], b_i, b_h [3H], h0 [B, H] (zeros when
None) -> (outs [B, T, H], h_T [B, H]), gate order (r, z, n), float32 only.
As in the JAX wrapper, the input projection ``gi = x @ W_i + b_i`` is one
``torch.matmul`` before the kernel, which runs only the recurrence.

The kernel is ``csrc/gru_seq.cu`` (its note gives the bound and the design):
one persistent, cooperative launch of ceil(H / 16) unit slices x row groups.
Up to ``RESIDENT_MAX_HIDDEN`` (724) each block keeps its W_h slice and h tile
in shared memory for all T steps (every GRU of the port, H <= 512, takes
this layout); past it, where they no longer fit a block's 227 KB, each step
streams them from L2 in 64-deep k-chunks.  It takes any B >= 1, T >= 1 and
I, and H up to ``max_hidden`` of the card's SMs (``MAX_HIDDEN``, 2,112 on an
H100 SXM): 16 units a block on each SM, all resident at once as the step
barrier needs.
``fused_gru_sequence`` checks its inputs the same way on every device and
takes the plain version (the step loop of ``ops/gru.py``, any H) only for
tensors on the CPU; off the CPU it also holds H to the kernel's limit, and
for CUDA tensors it launches the kernel or raises — there is no fallback.
``fused_gru_sequence.launches`` counts the calls that launched the kernel
(one launch each, after the input GEMM).

Under autograd (grad enabled and an input that needs a gradient) the call
goes through ``_GRUSequence``: the same forward, and as its backward autograd
of the step loop recomputed from the saved inputs (x, the weights, h0), as
the JAX package differentiates its ``lax.scan`` (its Pallas kernel has no
VJP).  No per-step activation is kept between forward and backward; the
backward reruns the T steps in torch ops and launches no kernel of this
module.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from visuelle2_tpu_torch.ops.cuda import _build
from visuelle2_tpu_torch.ops.cuda.recompute import recompute_backward
from visuelle2_tpu_torch.ops.gru import gru_sequence

_MAX_SMEM_BYTES = 232448  # 227 KB: what one Hopper block may use
_UNITS, _ROWS = 16, 32  # csrc/gru_seq.cu: a block's hidden units, a row tile's rows
_CHUNK = 64             # csrc/gru_seq.cu: kChunk, k of one streamed chunk
_H100_SMS = 132


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


def _resident_bytes(H: int) -> int:
    h4 = 4 * -(-H // 4)
    return 4 * (3 * _UNITS * h4 + _ROWS * (h4 + 4))


# The widest H whose W_h slice and h tile stay in a block's shared memory.
RESIDENT_MAX_HIDDEN = max(h for h in range(1, 1024) if _resident_bytes(h) <= _MAX_SMEM_BYTES)


def max_hidden(sms: int = _H100_SMS) -> int:
    """The widest H whose unit slices a card of ``sms`` SMs holds at once,
    one block an SM: what the step barrier needs."""
    return _UNITS * sms


MAX_HIDDEN = max_hidden()  # an H100 SXM's


def smem_bytes(H: int) -> int:
    """Dynamic shared memory of one block; layouts in csrc/gru_seq.cu.  Up
    to ``RESIDENT_MAX_HIDDEN``: the W_h slice (3 gates x 16 units x H, k
    padded to 4) and the h tile (32 rows of H padded to 4, plus 4).  Past
    it: two stages of a 64-deep k-chunk of each (3 x 16 x 64 and 32 x 68
    floats), whatever H."""
    if H <= RESIDENT_MAX_HIDDEN:
        return _resident_bytes(H)
    return 4 * 2 * (3 * _UNITS * _CHUNK + _ROWS * (_CHUNK + 4))


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


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load_library()
    fn = lib.v2t_fused_gru_sequence_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


_GRUSequence = recompute_backward("_GRUSequence", lambda *t: _forward(*t),
                                  lambda *t: gru_sequence(*t))


def fused_gru_sequence(x, w_i, w_h, b_i, b_h, h0=None):
    """GRU over x [B, T, I] -> (outs [B, T, H], h_T [B, H]); arguments as in
    the JAX package's ``fused_gru_sequence``.  Under autograd where an input
    needs a gradient (see the module docstring)."""
    named = dict(x=x, w_i=w_i, w_h=w_h, b_i=b_i, b_h=b_h)
    if h0 is not None:
        named["h0"] = h0
    _validate(named)
    return _GRUSequence.run(*named.values())


def _forward(x, w_i, w_h, b_i, b_h, h0=None):
    """The validated call: the step loop for CPU tensors, else the kernel."""
    if x.device.type == "cpu":
        return gru_sequence(x, w_i, w_h, b_i, b_h, h0)
    B, T, I = x.shape
    H = w_h.shape[0]
    sms = (torch.cuda.get_device_properties(x.device).multi_processor_count
           if x.device.type == "cuda" else _H100_SMS)
    if H > max_hidden(sms):
        raise ValueError(f"H={H}: the kernel takes H <= {max_hidden(sms)}, {_UNITS} hidden "
                         f"units a block with every block resident at once, one on each of "
                         f"the card's {sms} SMs")
    smem = smem_bytes(H)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gru_sequence runs on cuda or cpu, not {x.device}")
    lib, fn = _kernel()
    gi = torch.addmm(b_i, x.reshape(B * T, I), w_i).reshape(B, T, 3 * H)
    h0 = x.new_zeros(B, H) if h0 is None else h0
    outs = x.new_empty(B, T, H)
    h_last = x.new_empty(B, H)
    # The barrier's counters, one per row tile at most, zeroed on every call
    # (a memset node when the call is captured in a CUDA graph).
    counters = torch.zeros(-(-B // _ROWS), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(gi.data_ptr(), w_h.data_ptr(), b_h.data_ptr(), h0.data_ptr(),
                  outs.data_ptr(), h_last.data_ptr(), counters.data_ptr(), B, T, H, smem,
                  stream)
    _build.check(lib, code, "fused_gru_sequence")
    fused_gru_sequence.launches += 1
    return outs, h_last


fused_gru_sequence.launches = 0
