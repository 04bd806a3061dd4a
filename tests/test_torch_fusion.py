"""The fused gated residual and TG-Fusion: port vs the JAX package.

On the CPU the wrapper runs its plain version; it is held against the JAX
Pallas kernel in interpret mode (as tests/test_pallas_kernels.py runs it)
and the TG-Fusion module against the JAX module on its Pallas path under
``pltpu.force_tpu_interpret_mode()``.  f32, atol 1e-5: the same formula, sums
in another order.  The CUDA kernel itself is held against the plain version
on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from visuelle2_tpu.models.fusion import TextGuidedFusionNetwork as JTGFusion
from visuelle2_tpu.ops.pallas.gated_fusion import fused_gated_residual as j_fused
from visuelle2_tpu_torch.convert import load_jax_variables
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
