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
design): one thread-block cluster per batch row, one CTA per group of heads,
the CTAs' partial outputs summed over the cluster in rank order.
``launch_plan`` computes the cluster, the threads and the shared-memory
layout.  ``fused_gated_mha`` checks its inputs the same way on every device,
takes the plain version only for tensors on the CPU, and for CUDA tensors
launches the kernel or raises — there is no fallback.
``fused_gated_mha.launches`` counts the kernel launches.

Where an input needs a gradient the call runs under a
``torch.autograd.Function``: its forward is the kernel on the card (the plain
version on the CPU), its backward autograd of the plain version recomputed
from the saved inputs.  The Pallas original has no VJP either: the JAX
package trains on the XLA formula.  The backward launches no kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from visuelle2_tpu_torch.ops.cuda import _build
from visuelle2_tpu_torch.ops.cuda.recompute import recompute_backward
from visuelle2_tpu_torch.ops.dropout import dropout
from visuelle2_tpu_torch.ops.heads import merge_heads, split_heads

_MAX_SMEM_BYTES = 232448  # 227 KB: what one Hopper block may use
_MAX_CLUSTER = 8          # CTAs: the portable cluster size
_MIN_THREADS, _MAX_THREADS = 64, 160  # csrc/gated_mha.cu: kMaxThreads
VARIANTS = ("pure", "head")
# csrc/gated_mha.cu's struct Plan, field by field.
PLAN_FIELDS = ("ncta", "hpc", "width", "d", "qb", "kd", "kk", "kw", "kx",
               "q", "ldq", "qhs", "kt", "ldkt", "khs", "v", "ldv", "vhs", "p", "ldp", "phs",
               "ri", "bias", "m", "ldm", "y", "ldy", "zero_begin", "zero_end",
               "xq", "xk", "xv", "ldx", "wq", "wk", "wv", "ldw", "wg", "ldg", "wo", "ldo",
               "stage_k", "stage_v")


def fused_gated_mha_plain(query, key, value, mask, wq, bq, wk, bk, wv, bv,
                          wg, bg, wo, bo, *, num_heads: int, variant: str = "pure",
                          dropout_rate: float = 0.0):
    """The XLA formula of ``_GatedMHABase`` in torch: the CPU path, the
    kernel's reference and its backward; ``dropout_rate`` drops the
    probabilities as the JAX train path does (``ops/dropout.py``)."""
    d = query.shape[-1] // num_heads
    qh = split_heads(query @ wq + bq, num_heads)
    kh = split_heads(key @ wk + bk, num_heads)
    vh = split_heads(value @ wv + bv, num_heads)
    scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * (d ** -0.5) + mask
    probs = dropout(torch.softmax(scores, dim=-1), dropout_rate, dropout_rate > 0.0)
    ctx = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
    if variant == "head":
        merged = merge_heads(ctx * torch.sigmoid(qh @ wg + bg))
    else:
        merged = merge_heads(ctx) * torch.sigmoid(query @ wg + bg)
    return merged @ wo + bo


def cluster_split(num_heads: int):
    """(CTAs per cluster, heads per CTA): the fewest heads a CTA that keep a
    batch row's cluster within the portable 8 CTAs."""
    hpc = next(h for h in range(1, num_heads + 1)
               if num_heads % h == 0 and num_heads // h <= _MAX_CLUSTER)
    return num_heads // hpc, hpc


def _r4(n: int) -> int:
    return -(-n // 4) * 4


def _spread(ld: int) -> int:
    """A row stride that puts rows 4 apart in distinct banks (float4 reads)."""
    return ld + 4 if ld % 8 == 0 else ld


def _layout(Lq, Lk, D, num_heads, pure, staged, qb, stage_k, stage_v):
    """The Plan's fields and the dynamic shared memory in bytes.

    In floats, each array 16-byte aligned: the staged biases | merged | q |
    kᵀ | v (zeroed first when staged: the padding) | the staged head gate |
    the staged inputs and weight slices, or, once the projections are done
    with them, a query block's mask and then scores and probabilities, and
    the staged rows of Wo.  The cluster's partial outputs of this CTA's
    columns, y [ncta][Lq][W], lie over q onwards, short of Wo's rows: the
    cluster is done with its attention when they are written."""
    ncta, hpc = cluster_split(num_heads)
    d = D // num_heads
    W = hpc * d
    pad = _r4 if staged else (lambda n: n)
    kd, kk, kw, kx = pad(d), pad(Lk), pad(W), pad(D)
    ldq = _spread(kd) if staged else d
    ldp = _spread(kk) if staged else Lk
    ldm = _spread(kw) if staged else W
    ldkt = kk
    f = dict.fromkeys(PLAN_FIELDS, 0)
    f.update(ncta=ncta, hpc=hpc, width=W, d=d, qb=qb, kd=kd, kk=kk, kw=kw, kx=kx,
             ldq=ldq, qhs=Lq * ldq, ldkt=ldkt, khs=kd * ldkt, ldv=ldq, vhs=kk * ldq,
             ldp=ldp, phs=qb * ldp, ldm=ldm, ldy=W, stage_k=int(stage_k),
             stage_v=int(stage_v))
    end = 0

    def take(n):
        nonlocal end
        start, end = end, end + _r4(n)
        return start

    if staged:
        f["bias"] = take(4 * kw + (kw if pure else kd))
        f["zero_begin"] = end
    f["m"] = take(Lq * ldm)
    f["q"] = take(hpc * Lq * ldq)
    f["kt"] = take(hpc * kd * ldkt)
    f["v"] = take(hpc * kk * ldq)
    if staged:
        f["zero_end"] = end
        if not pure:
            f["wg"], f["ldg"] = take(kd * kd), kd
    f["p"] = end
    f["ri"] = end + _r4(hpc * qb * ldp)
    p_end = f["ri"] + _r4(hpc * qb)
    if staged:
        f["ldx"] = ldx = _spread(kx)
        f["xq"] = take(Lq * ldx)
        f["xk"] = take(Lk * ldx) if stage_k else f["xq"]
        f["xv"] = take(Lk * ldx) if stage_v else f["xk"]
        f["ldw"] = kw
        f["wq"], f["wk"], f["wv"] = (take(kx * f["ldw"]) for _ in range(3))
        if pure:
            f["wg"], f["ldg"] = take(kx * f["ldw"]), f["ldw"]
    f["y"] = f["q"]
    y_end = f["y"] + _r4(Lq * D)
    end = max(end, p_end, y_end)
    if staged:  # Wo's rows arrive once the projections are done, past P and y
        f["wo"], f["ldo"] = max(p_end, y_end), kx
        end = max(end, f["wo"] + _r4(kw * f["ldo"]))
    return f, 4 * end


@functools.lru_cache(maxsize=1024)
def launch_plan(B: int, Lq: int, Lk: int, D: int, num_heads: int, variant: str, *,
                stage_k: bool = True, stage_v: bool = True) -> dict:
    """How a call runs: one cluster of ``cluster`` CTAs per batch row (a grid
    of ``grid`` CTAs of ``threads`` threads), ``heads_per_cta`` heads each;
    the layout (``staged``: inputs and weights in shared memory, 16-byte
    loads; else read where they lie); ``qb`` query rows per attention block;
    ``smem_bytes``; and the Plan's ``fields``, in ``PLAN_FIELDS`` order.

    ``stage_k`` false: key is query (one tensor); ``stage_v`` false: value
    is key.  The staged layout where it fits in 227 KB with at least
    min(Lq, 8) query rows a block, else the unstaged one; in either the most
    query rows a block that fit.  Threads: one per micro-tile of the
    projections, in whole warps, 64 to 160.  Raises ValueError where
    neither layout fits."""
    pure = variant == "pure"
    ncta, hpc = cluster_split(num_heads)
    d = D // num_heads
    W = d * hpc
    rt_q, rt_k = -(-Lq // 4), -(-Lk // 4)  # 4-row tiles
    tiles = -(-W // 4) * ((2 if pure else 1) * rt_q + 2 * rt_k)  # the projections
    threads = min(_MAX_THREADS, max(_MIN_THREADS, -(-tiles // 32) * 32))
    args = (Lq, Lk, D, num_heads, pure)
    for staged, least in ((True, min(Lq, 8)), (False, 1)):
        def size(qb):
            return _layout(*args, staged, qb, stage_k, stage_v)[1]

        if size(least) > _MAX_SMEM_BYTES:
            continue
        lo, hi = least, Lq  # the most query rows a block that fit
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if size(mid) <= _MAX_SMEM_BYTES else (lo, mid - 1)
        fields, smem = _layout(*args, staged, lo, stage_k, stage_v)
        return {"staged": staged, "cluster": ncta, "heads_per_cta": hpc, "grid": B * ncta,
                "threads": threads, "qb": lo, "smem_bytes": smem,
                "fields": tuple(fields[n] for n in PLAN_FIELDS)}
    smem = _layout(*args, False, 1, stage_k, stage_v)[1]
    raise ValueError(f"Lq={Lq}, Lk={Lk}, D={D}, {num_heads} heads needs {smem} bytes of "
                     f"shared memory per block, more than the {_MAX_SMEM_BYTES} a block "
                     f"may use")


def _stage_flags(query, key, value):
    """(stage_k, stage_v): key is staged apart from query unless both are
    one tensor's memory, value apart from key likewise.  Tensors with equal
    data at other addresses stay two tensors."""
    stage_k = not (key.data_ptr() == query.data_ptr() and key.shape == query.shape)
    return stage_k, value.data_ptr() != key.data_ptr()


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
    stage_k, stage_v = _stage_flags(query, key, value)
    launch_plan(B, Lq, Lk, D, num_heads, variant, stage_k=stage_k, stage_v=stage_v)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load_library()
    fn = lib.v2t_fused_gated_mha_f32
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                                   ctypes.POINTER(ctypes.c_int)]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


_GatedMHA = recompute_backward(
    "_GatedMHA",
    lambda num_heads, variant, *t: _forward(*t, num_heads=num_heads, variant=variant),
    lambda num_heads, variant, *t: fused_gated_mha_plain(*t, num_heads=num_heads,
                                                         variant=variant), n_static=2)


def fused_gated_mha(query, key, value, mask, wq, bq, wk, bk, wv, bv, wg, bg, wo, bo,
                    *, num_heads: int, variant: str = "pure"):
    """Gated multi-head attention -> [B, Lq, D]; arguments as in the JAX
    package's ``fused_gated_mha``.  Under autograd where an input needs a
    gradient (see the module docstring)."""
    named = dict(query=query, key=key, value=value, mask=mask, wq=wq, bq=bq, wk=wk,
                 bk=bk, wv=wv, bv=bv, wg=wg, bg=bg, wo=wo, bo=bo)
    _validate(named, num_heads=num_heads, variant=variant)
    return _GatedMHA.run(num_heads, variant, *named.values())


def _forward(query, key, value, mask, wq, bq, wk, bk, wv, bv, wg, bg, wo, bo, *,
             num_heads: int, variant: str):
    """The validated call: the plain version for CPU tensors, else the kernel."""
    named = dict(query=query, key=key, value=value, mask=mask, wq=wq, bq=bq, wk=wk,
                 bk=bk, wv=wv, bv=bv, wg=wg, bg=bg, wo=wo, bo=bo)
    if query.device.type == "cpu":
        return fused_gated_mha_plain(*named.values(), num_heads=num_heads,
                                     variant=variant)
    if query.device.type != "cuda":
        raise ValueError(f"fused_gated_mha runs on cuda or cpu, not {query.device}")
    B, Lq, D = query.shape
    Lk = key.shape[1]
    stage_k, stage_v = _stage_flags(query, key, value)
    plan = launch_plan(B, Lq, Lk, D, num_heads, variant, stage_k=stage_k, stage_v=stage_v)
    fields = (ctypes.c_int * len(PLAN_FIELDS))(*plan["fields"])
    lib, fn = _kernel()
    out = torch.empty_like(query)
    # d^-½ as the JAX package forms it: a Python float, rounded to float32.
    scale = (D // num_heads) ** -0.5
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        code = fn(*(t.data_ptr() for t in named.values()), out.data_ptr(),
                  B, Lq, Lk, D, scale, int(variant == "head"), fields, len(PLAN_FIELDS),
                  int(plan["staged"]), plan["threads"], plan["smem_bytes"], stream)
    _build.check(lib, code, "fused_gated_mha")
    fused_gated_mha.launches += 1
    return out


fused_gated_mha.launches = 0
