"""The gated attention modules and the fused gated-MHA wrapper: port vs the
JAX package, in f32 on the CPU.

The same seeded numpy inputs go through the JAX module and its counterpart
in ``visuelle2_tpu_torch``; the weights cross over through
``convert.load_jax_variables``.  The JAX gated-MHA modules are run on their
XLA path and, for a few cases, on their Pallas path under
``pltpu.force_tpu_interpret_mode()``.  On the CPU the port's wrapper runs its
plain version.  Tolerance atol 2e-5, rtol 1e-5, as tests/test_pallas_kernels.py
holds the Pallas kernel to the XLA path: the same formula, sums in another
order.  The CUDA kernel itself is held against the plain version on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

import jax
import torch
from jax.experimental.pallas import tpu as pltpu

from visuelle2_tpu.ops import attention as jattn
from visuelle2_tpu.ops import masks as jmasks
from visuelle2_tpu.ops.pallas.gated_mha import fused_gated_mha as j_fused_gated_mha
from visuelle2_tpu_torch.convert import load_jax_variables
from visuelle2_tpu_torch.ops import attention as tattn
from visuelle2_tpu_torch.ops.cuda import gated_mha as tgm

ATOL, RTOL = 2e-5, 1e-5
D, HEADS = 16, 4

_CLASSES = {
    "pure": (jattn.PureGatedMultiHeadAttention, tattn.PureGatedMultiHeadAttention),
    "head": (jattn.HeadSpecificGatedAttention, tattn.HeadSpecificGatedAttention),
}
# case -> (Lq, Lk, gcd-masked): self-attention at the trend length, and the
# decoder's cross-attention (non-AR and AR) over the trend memory.
_CASES = {
    "self52_gcd": (52, 52, True),
    "self52": (52, 52, False),
    "cross1": (1, 52, False),
    "cross12": (12, 52, False),
}


def _inputs(rng, case, B=5):
    Lq, Lk, masked = _CASES[case]
    q = rng.standard_normal((B, Lq, D)).astype(np.float32)
    kv = q if Lq == Lk else rng.standard_normal((B, Lk, D)).astype(np.float32)
    mask = np.array(jmasks.gcd_block_mask(Lq, 12)) if masked else None
    return q, kv, mask


def _run_both(rng, variant, case, *, interpret=False, B=5):
    jcls, tcls = _CLASSES[variant]
    q, kv, mask = _inputs(rng, case, B)
    variables = jax.tree_util.tree_map(
        np.array, jcls(D, HEADS, dropout=0.1).init(jax.random.key(0), q, kv, kv, mask=mask))
    if interpret:
        with pltpu.force_tpu_interpret_mode():
            want = jcls(D, HEADS, dropout=0.1, use_pallas=True).apply(
                variables, q, kv, kv, mask=mask)
    else:
        want = jcls(D, HEADS, dropout=0.1).apply(variables, q, kv, kv, mask=mask)
    tm = load_jax_variables(tcls(D, HEADS), variables).eval()
    before = tgm.fused_gated_mha.launches
    t = torch.from_numpy
    got, probs = tm(t(q), t(kv), t(kv), mask=None if mask is None else t(mask))
    assert probs is None
    assert tgm.fused_gated_mha.launches == before  # CPU: the plain version
    return got, want


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("variant", ["pure", "head"])
def test_gated_mha_matches_jax(rng, variant, case):
    got, want = _run_both(rng, variant, case)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("variant,case", [("head", "self52_gcd"), ("pure", "cross1"),
                                          ("pure", "cross12")])
def test_gated_mha_matches_jax_pallas_interpret(rng, variant, case):
    """The JAX module on its Pallas path (the kernel in interpret mode)."""
    got, want = _run_both(rng, variant, case, interpret=True, B=3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_gate_bias_starts_open():
    """+2.0 gate bias at construction, as the JAX initializer sets it."""
    for cls in (tattn.PureGatedMultiHeadAttention, tattn.HeadSpecificGatedAttention):
        m = cls(D, HEADS)
        np.testing.assert_array_equal(m.gate_proj.bias.detach().numpy(), 2.0)
        assert tattn.GATE_BIAS_INIT == 2.0
        assert m.q_proj.bias.detach().abs().max() == 0
    assert tuple(tattn.HeadSpecificGatedAttention(D, HEADS).gate_proj.kernel.shape) == (4, 4)
    assert tuple(tattn.PureGatedMultiHeadAttention(D, HEADS).gate_proj.kernel.shape) == (D, D)


@pytest.mark.parametrize("case", ["self52_gcd", "cross1"])
def test_gated_cross_attention_v1_matches_jax(rng, case):
    q, kv, mask = _inputs(rng, case)
    jm = jattn.GatedCrossAttention(D, HEADS, dropout=0.1)
    variables = jax.tree_util.tree_map(
        np.array, jm.init(jax.random.key(0), q, kv, kv, mask=mask))
    want = jm.apply(variables, q, kv, kv, mask=mask)
    tm = load_jax_variables(tattn.GatedCrossAttention(D, HEADS), variables).eval()
    t = torch.from_numpy
    got, probs = tm(t(q), t(kv), t(kv), mask=None if mask is None else t(mask))
    assert probs is None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _wrapper_args(rng, B=4, Lq=6, Lk=9, Dm=16, heads=4, variant="pure"):
    G = Dm // heads if variant == "head" else Dm
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    args = [f(B, Lq, Dm), f(B, Lk, Dm), f(B, Lk, Dm), torch.zeros(Lq, Lk)]
    for shape in ((Dm, Dm), (Dm, Dm), (Dm, Dm), (G, G), (Dm, Dm)):
        args += [f(*shape) * 0.2, f(shape[1])]
    return args


@pytest.mark.parametrize("variant", ["pure", "head"])
def test_wrapper_matches_plain_on_cpu(rng, variant):
    args = _wrapper_args(rng, variant=variant)
    before = tgm.fused_gated_mha.launches
    got = tgm.fused_gated_mha(*args, num_heads=4, variant=variant)
    want = tgm.fused_gated_mha_plain(*args, num_heads=4, variant=variant)
    assert tgm.fused_gated_mha.launches == before
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("bad", ["f64", "non_contiguous", "mixed_device", "smem",
                                 "gate_shape", "mask_shape", "heads", "variant", "empty"])
def test_wrapper_rejects_what_the_kernel_cannot_take(rng, bad):
    kw = dict(num_heads=4, variant="pure")
    args = _wrapper_args(rng)
    if bad == "f64":
        args[4] = args[4].double()
    elif bad == "non_contiguous":
        args[0] = args[0].transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "mixed_device":
        args[6] = args[6].to("meta")
    elif bad == "smem":
        # The unstaged layout at Lq = Lk = 300, D = 256 (4 heads of 64): a
        # CTA's 300 x 64 merged context, q, kᵀ, v and probabilities, and its
        # 300 x 256 partial outputs: 384,000 bytes, over the 232,448 a Hopper
        # block may use.
        args = _wrapper_args(rng, B=1, Lq=300, Lk=300, Dm=256)
    elif bad == "gate_shape":
        kw["variant"] = "head"  # the pure [D, D] gate is not the head [d, d] one
    elif bad == "mask_shape":
        args[3] = torch.zeros(6, 8)
    elif bad == "heads":
        kw["num_heads"] = 3
    elif bad == "variant":
        kw["variant"] = "both"
    else:
        args[0], args[1], args[2] = args[0][:0], args[1][:0], args[2][:0]
    match = {"f64": "float32", "non_contiguous": "contiguous",
             "mixed_device": "one device", "smem": "shared memory",
             "gate_shape": "wg", "mask_shape": "mask", "heads": "heads",
             "variant": "variant", "empty": "non-empty"}[bad]
    with pytest.raises(ValueError, match=match):
        tgm.fused_gated_mha(*args, **kw)


def test_wrapper_never_falls_back_off_the_cpu(rng):
    """Only CPU tensors take the plain version: tensors on any other device
    go to the kernel or raise."""
    meta = [a.to("meta") for a in _wrapper_args(rng)]
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tgm.fused_gated_mha(*meta, num_heads=4)


def test_gated_mha_bound_from_shapes():
    """The main path's bounds (arithmetic on shapes, no card): the "head"
    launch of the trend encoder and the "pure" launch of the decoder."""
    from visuelle2_tpu_torch.ops.cuda import roofline

    head = roofline.gated_mha_cost(128, 52, 52, 64, 4, "head", self_attention=True)
    pure = roofline.gated_mha_cost(128, 1, 52, 64, 4, "pure", self_attention=False)
    assert head == (3_486_336, 320_339_968) and pure == (1_852_880, 113_901_568)
    ms, by = roofline.bound_ms(*head)
    assert by == "operations" and abs(ms - 320_339_968 / 67e12 * 1e3) < 1e-12
    ms, by = roofline.bound_ms(*pure)
    assert by == "operations" and abs(ms - 113_901_568 / 67e12 * 1e3) < 1e-12


# The kernel's cluster split: (CTAs a batch row, heads a CTA).
@pytest.mark.parametrize("num_heads,split", [(1, (1, 1)), (2, (2, 1)), (4, (4, 1)),
                                             (8, (8, 1)), (16, (8, 2)), (64, (8, 8)),
                                             (3, (3, 1)), (9, (3, 3)), (12, (6, 2)),
                                             (11, (1, 11))])
def test_cluster_split(num_heads, split):
    assert tgm.cluster_split(num_heads) == split
    ncta, hpc = split
    assert ncta * hpc == num_heads and ncta <= 8


def test_launch_plan_at_the_main_path_shapes():
    """gated_v2's calls: 512 CTAs in clusters of 4, staged, every query row
    in one block, and shared memory for five CTAs an SM (the kernel's
    launch bounds), so all 512 are resident at once on 132 SMs."""
    head = tgm.launch_plan(128, 52, 52, 64, 4, "head", stage_k=False, stage_v=False)
    pure = tgm.launch_plan(128, 1, 52, 64, 4, "pure", stage_k=True, stage_v=False)
    for plan, threads in ((head, 160), (pure, 128)):
        assert plan["staged"] and plan["cluster"] == 4 and plan["heads_per_cta"] == 1
        assert plan["grid"] == 512 and plan["threads"] == threads
        assert 5 * (plan["smem_bytes"] + 1024) <= 233472  # an SM's 228 KB, 1 KB a CTA reserved
    assert head["qb"] == 52 and pure["qb"] == 1
    # One tensor staged once: the trend encoder's query is its key and value.
    apart = tgm.launch_plan(128, 52, 52, 64, 4, "head")
    assert apart["smem_bytes"] - head["smem_bytes"] == 2 * 4 * 52 * 68


def _one_block_smem(Lq, Lk, D):
    """The dynamic shared memory the kernel's earlier design needed: one
    block of 512 threads a batch row, query, key, value and their
    projections staged."""
    return 4 * (3 * Lq * D + 3 * Lk * D + Lk * (D + 1) + 16 * Lk)


def _one_block_shapes():
    """(Lq, Lk, D, heads) the earlier design accepted on CUDA, at the edges
    of its range: each D with 1, 2, 4, 8 and 16 heads and one a column where
    they divide it, Lq and Lk from 1 to the largest that fitted."""
    limit = 232448
    largest = lambda f: max(n for n in range(1, 4096) if f(n) <= limit)
    for D in (1, 2, 3, 4, 12, 16, 48, 64, 96, 256, 1024, 8192):
        both = largest(lambda n: _one_block_smem(n, n, D))
        keys = largest(lambda n: _one_block_smem(1, n, D))
        queries = largest(lambda n: _one_block_smem(n, 1, D))
        lengths = {(1, 1), (both, both), (1, keys), (queries, 1), (min(12, both), min(52, both))}
        for heads in sorted({h for h in (1, 2, 4, 8, 16, D) if D % h == 0}):
            for Lq, Lk in sorted(lengths):
                assert _one_block_smem(Lq, Lk, D) <= limit
                yield Lq, Lk, D, heads


def test_launch_plan_takes_every_shape_the_one_block_kernel_took():
    """The range does not narrow: each shape the earlier design accepted gets
    a plan within 227 KB, whichever of query, key and value are one tensor,
    with whole warps, at most 8 CTAs a cluster and one per head group."""
    n = 0
    for Lq, Lk, D, heads in _one_block_shapes():
        for variant in tgm.VARIANTS:
            for stage_k, stage_v in ((True, True), (True, False), (False, False)):
                if not stage_k and Lq != Lk:
                    continue
                plan = tgm.launch_plan(3, Lq, Lk, D, heads, variant, stage_k=stage_k,
                                       stage_v=stage_v)
                assert plan["smem_bytes"] <= 232448, (Lq, Lk, D, heads, plan)
                assert plan["threads"] % 32 == 0 and 64 <= plan["threads"] <= 160
                assert plan["cluster"] * plan["heads_per_cta"] == heads
                assert plan["grid"] == 3 * plan["cluster"] and 1 <= plan["qb"] <= Lq
                n += 1
    assert n > 700


def _intervals(plan, Lq, Lk, D, variant):
    """The shared-memory arrays of a plan as name -> [start, end) in floats."""
    f = dict(zip(tgm.PLAN_FIELDS, plan["fields"]))
    hpc, W, qb = f["hpc"], f["width"], f["qb"]
    iv = {"m": (f["m"], f["m"] + Lq * f["ldm"]),
          "q": (f["q"], f["q"] + f["qhs"] * hpc), "kt": (f["kt"], f["kt"] + f["khs"] * hpc),
          "v": (f["v"], f["v"] + f["vhs"] * hpc), "p": (f["p"], f["p"] + f["phs"] * hpc),
          "ri": (f["ri"], f["ri"] + hpc * qb),
          "y": (f["y"], f["y"] + f["ncta"] * Lq * f["ldy"])}
    if plan["staged"]:
        G = f["kw"] if variant == "pure" else f["kd"]
        iv.update(bias=(f["bias"], f["bias"] + 4 * f["kw"] + G),
                  xq=(f["xq"], f["xq"] + Lq * f["ldx"]), xk=(f["xk"], f["xk"] + Lk * f["ldx"]),
                  xv=(f["xv"], f["xv"] + Lk * f["ldx"]),
                  wq=(f["wq"], f["wq"] + f["kx"] * f["ldw"]),
                  wk=(f["wk"], f["wk"] + f["kx"] * f["ldw"]),
                  wv=(f["wv"], f["wv"] + f["kx"] * f["ldw"]),
                  wg=(f["wg"], f["wg"] + (f["kx"] if variant == "pure" else f["kd"]) * f["ldg"]),
                  wo=(f["wo"], f["wo"] + f["kw"] * f["ldo"]))
    return f, iv


@pytest.mark.parametrize("shape", [
    (52, 52, 64, 4, "head", False, False), (1, 52, 64, 4, "pure", True, False),
    (12, 52, 48, 4, "pure", True, True), (30, 60, 16, 16, "head", True, True),
    (124, 124, 64, 4, "head", False, False), (9, 7, 4096, 8, "head", True, True),
    (1, 1, 4096, 1, "pure", True, True), (2421, 2421, 1, 1, "pure", True, True),
])
def test_launch_plan_keeps_live_arrays_apart(shape):
    """Arrays in use at once never share shared memory: while the inputs
    are staged and projected, while the attention runs (Wo's rows arriving
    over the staged operands), and while the partial outputs are pushed and
    summed.  Staged offsets and strides are whole float4s, the padding a
    product reads is in the zeroed range, and every array fits."""
    Lq, Lk, D, heads, variant, stage_k, stage_v = shape
    plan = tgm.launch_plan(4, Lq, Lk, D, heads, variant, stage_k=stage_k, stage_v=stage_v)
    f, iv = _intervals(plan, Lq, Lk, D, variant)
    assert max(end for _, end in iv.values()) * 4 <= plan["smem_bytes"] <= 232448
    staging = ["xq", "wq", "wk", "wv"] + (["xk"] if stage_k else []) \
        + (["xv"] if stage_v else []) + (["wg"] if variant == "pure" else [])
    phases = {"projections": ["m", "q", "kt", "v"], "attention": ["m", "q", "kt", "v", "p", "ri"],
              "output": ["m", "y"]}
    if plan["staged"]:
        phases["projections"] += ["bias"] + staging + (["wg"] if variant == "head" else [])
        phases["attention"] += ["bias", "wo"] + (["wg"] if variant == "head" else [])
        phases["output"] += ["bias", "wo"]
        assert all(f[n] % 4 == 0 for n in ("bias", "m", "q", "kt", "v", "p", "xq", "xk", "xv",
                                            "wq", "wk", "wv", "wg", "wo", "y", "zero_end"))
        assert all(f[n] % 4 == 0 for n in ("ldq", "ldkt", "ldv", "ldp", "ldm", "ldx", "ldw",
                                            "ldg", "ldo"))
        assert f["zero_begin"] <= iv["m"][0] and iv["v"][1] <= f["zero_end"]
        assert iv["bias"][1] <= f["zero_begin"]
    for phase, names in phases.items():
        spans = sorted(iv[n] for n in set(names))
        for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
            assert a1 <= b0, (phase, names, spans)


def test_plan_fields_are_the_kernels_struct():
    """PLAN_FIELDS names csrc/gated_mha.cu's struct Plan, field by field."""
    import re

    from visuelle2_tpu_torch.ops.cuda import _build

    text = (_build.SRC_DIR / "gated_mha.cu").read_text()
    body = text[text.index("struct Plan {"):text.index("};", text.index("struct Plan {"))]
    fields = [name for line in body.splitlines()[1:]
              for name in re.findall(r"\b(\w+)\s*[,;]", line.split("//")[0])]
    assert tuple(fields) == tgm.PLAN_FIELDS


def _emulate_cluster(query, key, value, mask, wq, bq, wk, bk, wv, bv, wg, bg, wo, bo, *,
                     num_heads, variant):
    """The CUDA kernel's order of sums, in torch: each CTA of the cluster
    (``cluster_split``) takes its heads' columns of the projections, their
    attention (the context from exp(s - max) times 1 / the row sum) and
    gate, and its partial output merged · Wo[its rows]; the partials are
    summed in rank order, then bo is added."""
    ncta, hpc = tgm.cluster_split(num_heads)
    d = query.shape[-1] // num_heads
    W = hpc * d
    y = None
    for rank in range(ncta):
        cols = slice(rank * W, (rank + 1) * W)
        q, k, v = (x @ w[:, cols] + b[cols] for x, w, b in ((query, wq, bq), (key, wk, bk),
                                                             (value, wv, bv)))
        merged = []
        for h in range(hpc):
            hc = slice(h * d, (h + 1) * d)
            s = q[..., hc] @ k[..., hc].transpose(1, 2) * d ** -0.5 + mask
            e = torch.exp(s - s.amax(-1, keepdim=True))
            ctx = e @ v[..., hc] * (1 / e.sum(-1, keepdim=True))
            if variant == "head":
                gate = torch.sigmoid(q[..., hc] @ wg + bg)
            else:
                gate = torch.sigmoid(query @ wg[:, cols][:, hc] + bg[cols][hc])
            merged.append(ctx * gate)
        part = torch.cat(merged, -1) @ wo[cols]
        y = part if y is None else y + part
    return y + bo


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("variant,Lq,Dm,heads", [
    ("head", 52, 16, 4),    # the trend encoder's self-attention: 4 CTAs a row
    ("pure", 1, 16, 4),     # the decoder's cross-attention
    ("pure", 12, 16, 4),
    ("head", 52, 16, 16),   # 8 CTAs of 2 heads
    ("pure", 12, 12, 3),    # 3 CTAs of d = 4
])
def test_cluster_order_of_sums_matches_jax_pallas_interpret(rng, variant, Lq, Dm, heads, masked):
    """The per-CTA partial outputs summed over the cluster in rank order
    against the JAX Pallas kernel in interpret mode, at 1e-5."""
    B, Lk = 3, 52
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    query = f(B, Lq, Dm)
    kv = query if Lq == Lk else f(B, Lk, Dm)
    mask = (np.array(jmasks.gcd_block_mask(Lq, 12)) if masked and Lq == Lk
            else np.zeros((Lq, Lk), np.float32))
    if masked and Lq != Lk:
        mask[:, ::5] = -np.inf
    G = Dm // heads if variant == "head" else Dm
    weights = []
    for n in (Dm, Dm, Dm, G, Dm):
        weights += [f(n, n, scale=n ** -0.5), f(n, scale=0.1)]
    args = [query, kv, kv, mask.astype(np.float32), *weights]
    want = j_fused_gated_mha(*args, num_heads=heads, variant=variant, interpret=True)
    got = _emulate_cluster(*map(torch.from_numpy, args), num_heads=heads, variant=variant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_gated_split_variants_apply_to_the_kernel_sources(tmp_path):
    """perf/gated_split.py's variants each edit the checkout's kernel
    sources; a source that lacks a line a variant replaces raises."""
    import shutil
    from pathlib import Path

    from visuelle2_tpu_torch.perf import gated_split

    root = Path(tgm.__file__).resolve().parents[3]
    sources = gated_split.variant_sources(root, gated_split.VARIANTS)
    whole = sources.pop("whole")
    assert set(whole) == {gated_split.MHA, gated_split.FUSION}
    for name, texts in sources.items():
        edited = {f for f in texts if texts[f] != whole[f]}
        assert edited == set(gated_split.VARIANTS[name]), name
    csrc = tmp_path / "visuelle2_tpu_torch" / "csrc"
    csrc.mkdir(parents=True)
    for f in whole:
        shutil.copy(root / "visuelle2_tpu_torch" / "csrc" / f, csrc / f)
    (csrc / gated_split.MHA).write_text(whole[gated_split.MHA].replace(
        "for (int i0 = 0; i0 < Lq; i0 += p.qb) {", "for (;;) {"))
    with pytest.raises(RuntimeError, match="no_attention"):
        gated_split.variant_sources(tmp_path, gated_split.VARIANTS)
