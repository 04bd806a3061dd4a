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
