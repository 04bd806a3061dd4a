"""The fusion networks and the fused gated residual: port vs the JAX package.

On the CPU the wrapper runs its plain version; it is held against the JAX
Pallas kernel in interpret mode (as tests/test_pallas_kernels.py runs it)
and the TG-Fusion module against the JAX module on its Pallas path under
``pltpu.force_tpu_interpret_mode()``.  f32, atol 1e-5: the same formula, sums
in another order.  The CUDA kernel itself is held against the plain version
on the card by tests/test_torch_cuda.py and chip_smoke.py.  The other
fusion networks (plain tensor code in both packages) are held to their JAX
modules at the same tolerance, with random BatchNorm running statistics.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from visuelle2_tpu.models import fusion as jfusion
from visuelle2_tpu.models.fusion import TextGuidedFusionNetwork as JTGFusion
from visuelle2_tpu.ops.pallas.gated_fusion import fused_gated_residual as j_fused
from visuelle2_tpu_torch.convert import load_jax_variables
from visuelle2_tpu_torch.models import fusion as tfusion
from visuelle2_tpu_torch.models.fusion import TextGuidedFusionNetwork as TTGFusion
from visuelle2_tpu_torch.ops.cuda import gated_fusion as tgf

ATOL = 1e-5


def _inputs(rng, B=37, D=48, C=96):
    x = rng.standard_normal((B, D)).astype(np.float32)
    ctx = rng.standard_normal((B, C)).astype(np.float32)
    wx = (rng.standard_normal((D, D)) * 0.1).astype(np.float32)
    wc = (rng.standard_normal((C, D)) * 0.1).astype(np.float32)
    b = rng.standard_normal((D,)).astype(np.float32)
    return x, ctx, wx, wc, b


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("fn", ["plain", "wrapper"])
def test_gated_residual_matches_pallas_interpret(rng, residual, fn):
    arrays = _inputs(rng)
    want = j_fused(*map(jnp.asarray, arrays), residual=residual, block_b=16,
                   interpret=True)
    port = tgf.fused_gated_residual_plain if fn == "plain" else tgf.fused_gated_residual
    before = tgf.fused_gated_residual.launches
    got = port(*map(torch.from_numpy, arrays), residual=residual)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert tgf.fused_gated_residual.launches == before  # CPU: no kernel launch


@pytest.mark.parametrize("with_img", [True, False])
def test_tg_fusion_matches_jax_pallas_path(rng, with_img):
    B, E, H = 6, 16, 16
    img = rng.standard_normal((B, E)).astype(np.float32) if with_img else None
    text = rng.standard_normal((B, 4, E)).astype(np.float32)
    dummy = rng.standard_normal((B, E)).astype(np.float32)
    variables = jax.tree_util.tree_map(
        np.array, JTGFusion(E, H).init(jax.random.key(0), img, text, dummy))
    with pltpu.force_tpu_interpret_mode():
        want = JTGFusion(E, H, use_pallas=True).apply(variables, img, text, dummy)
    tm = load_jax_variables(TTGFusion(E, H, use_img=with_img), variables).eval()
    got = tm(None if img is None else torch.from_numpy(img),
             torch.from_numpy(text), torch.from_numpy(dummy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("bad", ["bf16_x", "f64_weights", "shape", "empty"])
def test_wrapper_rejects_bad_inputs(rng, bad):
    x, ctx, wx, wc, b = map(torch.from_numpy, _inputs(rng))
    if bad == "bf16_x":
        x = x.bfloat16()
    elif bad == "f64_weights":
        wx, wc = wx.double(), wc.double()
    elif bad == "shape":
        wc = wc[:-1]
    else:
        x, ctx = x[:0], ctx[:0]
    with pytest.raises(ValueError):
        tgf.fused_gated_residual(x, ctx, wx, wc, b)


def test_wrapper_never_falls_back_off_the_cpu(rng):
    """Only CPU tensors take the plain version: tensors on any other device
    go to the kernel or raise."""
    meta = [torch.from_numpy(a).to("meta") for a in _inputs(rng)]
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tgf.fused_gated_residual(*meta)
    mixed = [torch.from_numpy(a) for a in _inputs(rng)]
    mixed[2] = mixed[2].to("meta")
    with pytest.raises(ValueError, match="one device"):
        tgf.fused_gated_residual(*mixed)


def _with_random_batch_stats(rng, variables):
    """Replace every BatchNorm running mean/var so eval BN is not the identity."""
    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else
                (rng.standard_normal(v.shape) * 0.5 if k == "mean"
                 else rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)
                for k, v in tree.items()}
    return {**variables, "batch_stats": fill(variables["batch_stats"])}


# name -> (JAX module, port module, argument order); E = H = 16.
_FUSIONS = {
    "gtm": (lambda: jfusion.GTMFusionNetwork(16, 16),
            lambda **ab: tfusion.GTMFusionNetwork(16, 16, **ab), "itd"),
    "m4ft": (lambda: jfusion.M4FTFusionNetwork(16),
             lambda **ab: tfusion.M4FTFusionNetwork(16), "tti"),
    "gated_v1": (lambda: jfusion.ResidualGatedFusionNetwork(16, 16),
                 lambda **ab: tfusion.ResidualGatedFusionNetwork(16, 16, **ab), "itd"),
    "gated_v2": (lambda: jfusion.PureGatedFusionNetwork(16, 16),
                 lambda **ab: tfusion.PureGatedFusionNetwork(16, 16, **ab), "itd"),
    "targ_text": (lambda: jfusion.TARGFusionNetwork(16, query_modality="text"),
                  lambda **ab: tfusion.TARGFusionNetwork(16, "text", **ab), "tti"),
    "targ_image": (lambda: jfusion.TARGFusionNetwork(16, query_modality="image"),
                   lambda **ab: tfusion.TARGFusionNetwork(16, "image", **ab), "tti"),
}


# Every network with each modality ablated, except a TARG anchor (see
# test_targ_rejects_an_ablated_anchor).
@pytest.mark.parametrize("name,ablate", [
    (n, a) for n in sorted(_FUSIONS) for a in ("none", "img", "text")
    if (n, a) not in (("targ_text", "text"), ("targ_image", "img"))])
def test_fusion_networks_match_jax(rng, name, ablate):
    jmake, tmake, order = _FUSIONS[name]
    B = 6
    m4ft_style = order == "tti"
    img = rng.standard_normal((B, 16)).astype(np.float32) if ablate != "img" else None
    text = (rng.standard_normal((B, 16) if m4ft_style else (B, 4, 16)).astype(np.float32)
            if ablate != "text" else None)
    temporal = rng.standard_normal((B, 16)).astype(np.float32)
    args = (temporal, text, img) if m4ft_style else (img, text, temporal)
    variables = jax.tree_util.tree_map(np.array, jmake().init(jax.random.key(0), *args))
    if "batch_stats" in variables:
        variables = _with_random_batch_stats(rng, variables)
    want = jmake().apply(variables, *args)
    tm = load_jax_variables(tmake(use_img=ablate != "img", use_text=ablate != "text"),
                            variables).eval()
    got = tm(*(None if a is None else torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_targ_gate_names_count_ablated_contexts():
    """gate_fc{i} numbers the contexts in order, ablated ones too."""
    names = lambda m: sorted(n for n, _ in m.named_children() if n.startswith("gate_fc"))
    assert names(tfusion.TARGFusionNetwork(16, "text")) == ["gate_fc1", "gate_fc2"]
    assert names(tfusion.TARGFusionNetwork(16, "text", use_img=False)) == ["gate_fc2"]
    assert names(tfusion.TARGFusionNetwork(16, "image", use_text=False)) == ["gate_fc2"]
    assert names(tfusion.TARGFusionNetwork(16, "temporal", use_text=False)) == ["gate_fc2"]


def test_targ_rejects_an_ablated_anchor():
    with pytest.raises(ValueError, match="anchor"):
        tfusion.TARGFusionNetwork(16, "text", use_text=False)
    with pytest.raises(ValueError, match="query_modality"):
        tfusion.TARGFusionNetwork(16, "audio")


def test_pure_gated_fusion_gate_starts_open():
    """gate_fc's bias starts at +2.0 under the registry's init, as in JAX;
    every nn.Linear bias starts at 0."""
    from visuelle2_tpu_torch.models.registry import init_parameters

    m = tfusion.PureGatedFusionNetwork(16, 16)
    init_parameters(m, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(m.gate_fc.bias.detach().numpy(), 2.0)
    np.testing.assert_array_equal(m.fusion_fc.bias.detach().numpy(), 0.0)


@pytest.mark.parametrize("shape,vec,plan", [
    # gated_v4's TG-Fusion: 8 float4 units, 4 k-splits a warp, 5 warps
    ((128, 32, 128), 4, dict(cub=8, warps=5, splits=20, rows=1, grid=(128, 1))),
    ((4096, 32, 128), 4, dict(cub=8, warps=5, splits=20, rows=4, grid=(1024, 1))),
    ((1, 32, 128), 4, dict(cub=8, warps=5, splits=20, rows=1, grid=(1, 1))),
    ((200, 32, 128), 4, dict(cub=8, warps=5, splits=20, rows=1, grid=(200, 1))),
    ((300, 32, 128), 4, dict(cub=8, warps=5, splits=20, rows=2, grid=(150, 1))),
    ((8, 1024, 64), 4, dict(cub=32, warps=8, splits=8, rows=1, grid=(8, 8))),
    ((128, 32, 0), 4, dict(cub=8, warps=1, splits=4, rows=1, grid=(128, 1))),
    ((5, 33, 7), 1, dict(cub=32, warps=5, splits=5, rows=1, grid=(5, 2))),
    ((4, 256, 256), 4, dict(cub=32, warps=8, splits=8, rows=1, grid=(4, 2))),
    ((3, 2, 5), 1, dict(cub=2, warps=1, splits=16, rows=1, grid=(3, 1))),
])
def test_gated_residual_launch_plan(shape, vec, plan):
    """Units of ``vec`` columns, a power-of-two column tile of up to 32
    units, k-splits of about eight of the D + C terms, one row a CTA until
    the grid would pass two CTAs an SM of an H100."""
    got = tgf.launch_plan(*shape, vec=vec)
    assert got == dict(plan, vec=vec)
    B, D, C = shape
    assert got["grid"][1] * got["cub"] * vec >= D and got["grid"][0] * got["rows"] >= B
    assert got["splits"] == 32 // got["cub"] * got["warps"] and 32 * got["warps"] <= 256


def _staged_residual_accepts(D, C):
    """What the earlier design took on CUDA: one thread a column (D <= 1024)
    and Wx, Wc, b and a tile of rows staged within 227 KB."""
    rows = max(1, 256 // D)
    return D <= 1024 and 4 * (D * D + C * D + D + rows * (D + C)) <= 232448


def test_gated_residual_plan_over_the_old_range_and_past_it():
    """Every shape the earlier design took has a plan; so do wider ones (the
    kernel stages nothing), up to the grid's 65,535 column tiles."""
    shapes = [(B, D, C) for B in (1, 37, 128, 4096) for D in (1, 3, 32, 48, 64, 255, 256, 1024)
              for C in (0, 1, 96, 128, 512, 4096)]
    taken = [s for s in shapes if _staged_residual_accepts(*s[1:])]
    assert len(taken) > 60 and len(taken) < len(shapes)
    for B, D, C in shapes:
        plan = tgf.launch_plan(B, D, C, vec=4 if D % 4 == 0 else 1)
        assert plan["grid"][0] * plan["rows"] >= B
    with pytest.raises(ValueError, match="column tiles"):
        tgf.launch_plan(1, 4 * 32 * 65535 + 4, 0, vec=4)


def _emulate_split_sum(x, ctx, wx, wc, b, *, residual, plan):
    """The CUDA kernel's order of sums, in torch: k-split s (of S) sums the
    terms k = s, s + S, ... of [x, ctx]·[Wx; Wc] in order; the 32 / cub
    splits of a warp meet in a shuffle butterfly, then the warps' partials
    are added in order, then b; the gate follows."""
    a, w = torch.cat([x, ctx], 1), torch.cat([wx, wc], 0)
    S, ksub, warps = plan["splits"], 32 // plan["cub"], plan["warps"]
    part = []
    for s in range(S):
        acc = torch.zeros(x.shape[0], w.shape[1])
        for k in range(s, a.shape[1], S):
            acc = acc + a[:, k:k + 1] * w[k]
        part.append(acc)
    total = None
    for warp in range(warps):
        lanes = part[warp * ksub:(warp + 1) * ksub]
        off = ksub // 2
        while off:
            lanes = [lanes[i] + lanes[i ^ off] for i in range(ksub)]
            off //= 2
        total = lanes[0] if total is None else total + lanes[0]
    g = torch.sigmoid(total + b)
    return x + x * g if residual else x * g


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("shape", [(37, 32, 128), (5, 48, 96), (9, 33, 7), (4, 16, 3)])
def test_split_sum_matches_pallas_interpret(rng, residual, shape):
    """The kernel's k-split sums against the JAX Pallas kernel in interpret
    mode, at 1e-5."""
    B, D, C = shape
    arrays = _inputs(rng, B=B, D=D, C=C)
    want = j_fused(*map(jnp.asarray, arrays), residual=residual, block_b=16, interpret=True)
    plan = tgf.launch_plan(B, D, C, vec=4 if D % 4 == 0 else 1)
    got = _emulate_split_sum(*map(torch.from_numpy, arrays), residual=residual, plan=plan)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
