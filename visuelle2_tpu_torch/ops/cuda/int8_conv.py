"""The w8a8 backbone's convolution: the CUDA kernel's wrapper and its plain
PyTorch version.

    int8_conv(x, w, m, z, kernel=, stride=, pad=, epilogue=, addend=None,
              shortcut=None, ratio=None, pad_channels=0)

x is an int8 NHWC activation [N, H, W, Cin], w an int8 weight packed by
``pack_weight`` into [Cout, K_pad] (K = kernel² · Cin in (ky, kx, c) order,
zero-padded to a multiple of 32), m and z float32 [Cout].  With acc the
exact int32 sum of the convolution, the epilogue is per output channel:

    "requant"      int8 out = clamp(rint(acc·m + z), 0, 127)
    "requant_add"  int8 out = clamp(rint((acc·m + z) + addend), 0, 127),
                   addend float32 [N, Ho, Wo, Cout] (conv3 and its shortcut)
    "float"        float32 out = acc·m + z (the downsample conv's shortcut)
    "requant_add_identity"
                   int8 out = clamp(rint((acc·m + z) + shortcut·ratio), 0, 127),
                   shortcut int8 [N, Ho, Wo, Cout] (the block input's codes),
                   ratio a float32 scalar tensor (conv3 and its identity
                   shortcut: ``q.float() * sc_ratio``, then the add)

in float32, acc converted to float32 first, each product and sum rounded on
its own (no fused multiply-add), rint halves to even: the JAX engine's
``_requant_relu`` op by op (``visuelle2_tpu/models/quantized_resnet.py:204``),
so the codes are the same bits.  The clamp at 0 is the ReLU.

The kernel (``csrc/int8_conv.cu``) is an implicit GEMM on ``wgmma``; it
replaces no ``pl.pallas_call``: the JAX engine's convolutions are XLA
(``quantized_resnet.py:86``), and stock PyTorch has no CUDA int8
convolution.  On CUDA it takes Cin a multiple of 4 (the w8a8 engine pads the
stem's 3 channels to 4 with a zero channel) and Cout a multiple of 64;
``launch_plan`` picks its column tile.  The plain version takes any shape.
A wrapper takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises — there is no fallback.
``int8_conv.launches`` counts kernel launches and ``int8_conv.kernel_ops``
their operations (2 a multiply-add) on the input's channels but its last
``pad_channels``, zeros the caller added for the kernel (the stem's fourth):
``FlopCounterMode`` sees the plain version's convolution but not a
``ctypes`` launch (``eval/profiler.py``).

The plain version computes the convolution in float64, which is exact
(|acc| <= 127² · 4,608 < 2^53), casts it to int32, then runs the epilogue as
float32 torch ops (multiply, then add, then round).
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.nn import functional as F

from visuelle2_tpu_torch.ops.cuda import _build

K_ALIGN = 32  # the packed K: a multiple of one wgmma k-step (32 int8)
EPILOGUES = {"requant": 0, "requant_add": 1, "float": 2, "requant_add_identity": 3}
COUT_ALIGN = 64  # the kernel's narrowest column tile
CIN_ALIGN = 4    # the kernel's narrowest gather: 4 bytes, whole channels
GATHER4_MAX_KPAD = 1024  # that gather's table of taps: 8 chunks of 128 bytes
TILE_N = (256, 128, 64)  # its column tiles, widest first
# The kernel's instantiations, (BN, coop), by the producer's mode
# (``producer_mode``): the plans ``launch_plan`` can return, and no others.
TILE_PLANS = {"tma": ((128, True), (64, True)),
              "gather": ((256, True), (128, True), (64, True), (64, False))}


def pack_weight(qw: torch.Tensor) -> torch.Tensor:
    """int8 OIHW [Cout, Cin, kh, kw] -> [Cout, K_pad], K in (ky, kx, c)
    order, zeros past K = kh·kw·Cin up to a multiple of 32."""
    cout, cin, kh, kw = qw.shape
    k = kh * kw * cin
    packed = torch.zeros(cout, -(-k // K_ALIGN) * K_ALIGN, dtype=torch.int8,
                         device=qw.device)
    packed[:, :k] = qw.permute(0, 2, 3, 1).reshape(cout, k)
    return packed


def unpack_weight(w: torch.Tensor, cin: int, kernel: int) -> torch.Tensor:
    """``pack_weight``'s inverse: [Cout, K_pad] -> OIHW [Cout, Cin, k, k]."""
    k = kernel * kernel * cin
    return w[:, :k].reshape(w.shape[0], kernel, kernel, cin).permute(0, 3, 1, 2)


def out_size(h: int, kernel: int, stride: int, pad: int) -> int:
    return (h + 2 * pad - kernel) // stride + 1


def producer_mode(cin: int, kernel: int, stride: int, pad: int) -> str:
    """How the kernel's producer fills its ring: "tma" for the 1x1 stride-1
    convs (A the plain [N·H·W, Cin] matrix), else "gather" (``cp.async``)."""
    return "tma" if kernel == 1 and stride == 1 and pad == 0 and cin % 16 == 0 else "gather"


def launch_plan(cout: int, kernel: int, stride: int, epilogue: str):
    """The kernel's tiling for a launch: ``(BN, coop)``, as measured fastest
    on the card (``perf/int8_split.py``).  BN, the column tile, is the widest
    of ``TILE_N`` that divides ``cout``, at most 128 for the 1x1 stride-1
    convs and the epilogues that read a shortcut (their epilogue's
    registers), 256 for the gathers' 3x3 and strided convs.  ``coop``: both
    consumer warpgroups share each 128-row tile and its weight chunks; the
    3x3 convs and the stem at Cout = 64 instead take 256 x 64 tiles in turns
    (ping-pong), which exists at BN = 64 only (``TILE_PLANS``)."""
    widest = 256 if (kernel > 1 or stride > 1) and epilogue in ("requant", "float") else 128
    fits = [bn for bn in TILE_N if bn <= widest and cout % bn == 0]
    if not fits:
        raise ValueError(f"int8_conv on CUDA takes Cout a multiple of {COUT_ALIGN}, not {cout}")
    return fits[0], not (fits[0] == 64 and kernel > 1)


def requantize(acc: torch.Tensor, m, z, epilogue: str, addend=None) -> torch.Tensor:
    """The epilogue on an int32 sum, as float32 torch ops."""
    f = acc.float() * m
    f = f + z
    if epilogue == "float":
        return f
    if epilogue == "requant_add":
        f = f + addend
    return torch.clamp(torch.round(f), 0, 127).to(torch.int8)


def int8_conv_plain(x, w, m, z, *, kernel: int, stride: int, pad: int, epilogue: str,
                    addend=None, shortcut=None, ratio=None):
    """The kernel's reference, on the CPU and on CUDA (see the module
    docstring).  On CUDA the float64 convolution runs without cuDNN, as an
    im2col and a float64 GEMM, which sums exactly."""
    if epilogue == "requant_add_identity":
        epilogue, addend = "requant_add", shortcut.float() * ratio
    wt = unpack_weight(w, x.shape[3], kernel).double()
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(x.permute(0, 3, 1, 2).double(), wt, stride=stride, padding=pad)
    acc = acc.permute(0, 2, 3, 1).round().to(torch.int32)
    return requantize(acc, m, z, epilogue, addend)


def _validate(x, w, m, z, kernel, stride, pad, epilogue, addend, shortcut, ratio):
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue is one of {sorted(EPILOGUES)}, not {epilogue!r}")
    if x.dtype != torch.int8 or w.dtype != torch.int8 or x.dim() != 4 or w.dim() != 2:
        raise ValueError(f"int8_conv takes int8 x [N, H, W, Cin] and w [Cout, K_pad]; got "
                         f"{x.dtype} {tuple(x.shape)} and {w.dtype} {tuple(w.shape)}")
    n, h, wd, cin = x.shape
    cout, kpad = w.shape
    k = kernel * kernel * cin
    if kpad % K_ALIGN or not k <= kpad < k + K_ALIGN:
        raise ValueError(f"int8_conv: w has K_pad={kpad}; K={k} padded to {K_ALIGN} expected")
    for name, t in (("m", m), ("z", z)):
        if t.dtype != torch.float32 or tuple(t.shape) != (cout,):
            raise ValueError(f"int8_conv: {name} must be float32 [{cout}]")
    ho, wo = out_size(h, kernel, stride, pad), out_size(wd, kernel, stride, pad)
    if min(n, ho, wo) < 1:
        raise ValueError(f"int8_conv: empty output for x {tuple(x.shape)}, kernel {kernel}")
    if (epilogue == "requant_add") != (addend is not None):
        raise ValueError("int8_conv: an addend goes with epilogue 'requant_add' only")
    if addend is not None and (addend.dtype != torch.float32
                               or tuple(addend.shape) != (n, ho, wo, cout)):
        raise ValueError(f"int8_conv: addend must be float32 {(n, ho, wo, cout)}")
    identity = epilogue == "requant_add_identity"
    if identity != (shortcut is not None) or identity != (ratio is not None):
        raise ValueError("int8_conv: a shortcut and a ratio go with epilogue "
                         "'requant_add_identity' only, and it needs both")
    if shortcut is not None and (shortcut.dtype != torch.int8
                                 or tuple(shortcut.shape) != (n, ho, wo, cout)):
        raise ValueError(f"int8_conv: shortcut must be int8 {(n, ho, wo, cout)}")
    if ratio is not None and (not isinstance(ratio, torch.Tensor)
                              or ratio.dtype != torch.float32 or ratio.dim() != 0):
        raise ValueError("int8_conv: ratio must be a float32 scalar tensor (0-dim)")
    devices = {t.device for t in (x, w, m, z, addend, shortcut, ratio) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"int8_conv: inputs on one device, got {devices}")
    return ho, wo


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load_library()
    fn = lib.v2t_int8_conv
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 16 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def launch_args(x, w, m, z, kernel, stride, pad, epilogue, addend, shortcut, ratio, out):
    """The C entry point's arguments for checked CUDA tensors (the wrapper's
    call, and ``perf/int8_split.py``'s of the kernel's variants), on the
    current stream of x's device."""
    n, h, wd, cin = x.shape
    cout, kpad = w.shape
    _, ho, wo, _ = out.shape
    bn, coop = launch_plan(cout, kernel, stride, epilogue)
    return (x.data_ptr(), w.data_ptr(), m.data_ptr(), z.data_ptr(),
            *(t.data_ptr() if t is not None else 0 for t in (addend, shortcut, ratio)),
            out.data_ptr(), n, h, wd, cin, ho, wo, cout, kernel, kernel, stride, pad,
            kernel * kernel * cin, kpad, EPILOGUES[epilogue], bn, int(coop),
            torch.cuda.current_stream(x.device).cuda_stream)


def int8_conv(x, w, m, z, *, kernel: int, stride: int, pad: int, epilogue: str,
              addend=None, shortcut=None, ratio=None, pad_channels: int = 0):
    """See the module docstring: int8 [N, Ho, Wo, Cout], or float32 for
    epilogue "float"."""
    ho, wo = _validate(x, w, m, z, kernel, stride, pad, epilogue, addend, shortcut, ratio)
    if not 0 <= pad_channels < x.shape[3]:
        raise ValueError(f"int8_conv: pad_channels is 0 to Cin - 1, not {pad_channels}")
    if x.device.type == "cpu":
        return int8_conv_plain(x, w, m, z, kernel=kernel, stride=stride, pad=pad,
                               epilogue=epilogue, addend=addend, shortcut=shortcut,
                               ratio=ratio)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv runs on cuda or cpu, not {x.device}")
    n, h, wd, cin = x.shape
    cout, kpad = w.shape
    if cout % COUT_ALIGN:
        raise ValueError(f"int8_conv on CUDA takes Cout a multiple of {COUT_ALIGN}, not {cout}")
    if cin % CIN_ALIGN:
        raise ValueError(f"int8_conv on CUDA takes Cin a multiple of {CIN_ALIGN} (pad the "
                         f"channels with zeros), not {cin}")
    if x.numel() >= 2 ** 31:
        raise ValueError("int8_conv on CUDA takes an activation under 2^31 bytes")
    if cin % 16 and (kpad > GATHER4_MAX_KPAD or max(h, wd) >= 2 ** 14):
        raise ValueError(f"int8_conv on CUDA takes Cin = {cin} (not a multiple of 16) up to "
                         f"K_pad = {GATHER4_MAX_KPAD} and maps under 16384 pixels a side")
    for t in (x, w, m, z, addend, shortcut):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("int8_conv needs contiguous, 16-byte aligned tensors")
    out = torch.empty(n, ho, wo, cout, device=x.device,
                      dtype=torch.float32 if epilogue == "float" else torch.int8)
    lib, fn = _kernel()
    with torch.cuda.device(x.device):
        code = fn(*launch_args(x, w, m, z, kernel, stride, pad, epilogue, addend, shortcut,
                               ratio, out))
    _build.check(lib, code, "int8_conv")
    int8_conv.launches += 1
    int8_conv.kernel_ops += 2 * n * ho * wo * cout * kernel * kernel * (cin - pad_channels)
    return out


int8_conv.launches = 0
int8_conv.kernel_ops = 0
