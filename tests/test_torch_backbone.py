"""Port image path vs the JAX package on the CPU: ``normalize_images``, the
ResNet backbone (tiny arch) and ``ImagePooledEncoder``.

f32 tolerance 1e-4, as in tests/test_whole_model_golden.py: the backbone
stacks convolutions whose sums run in another order in the two frameworks.
BatchNorm statistics and affine parameters are randomized, so the fold in
the working dtype is exercised, not just an identity.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from visuelle2_tpu.data.images import normalize_images as j_normalize
from visuelle2_tpu.models import encoders as jenc
from visuelle2_tpu.models import resnet as jres
from visuelle2_tpu_torch.convert import load_jax_variables
from visuelle2_tpu_torch.data.images import normalize_images as t_normalize
from visuelle2_tpu_torch.models import encoders as tenc
from visuelle2_tpu_torch.models import resnet as tres

F32_ATOL = 1e-4
# bf16: both sides convolve in bf16 but round intermediates at other places
# (XLA may keep excess precision across fused ops; torch rounds after every
# op), so single pooled features differ by one bf16 ulp.  Measured on this
# test's inputs over seeds 0-2: max |diff| = 2**-7 = 0.0078 at features of
# magnitude 1.6-2.2, i.e. one ulp in [1, 2).  The bound allows two ulps.
BF16_ATOL, BF16_RTOL = 2 ** -6, 2 ** -7


def _images(rng, n=6, size=32):
    return rng.integers(0, 256, (n, size, size, 3)).astype(np.uint8)


def _randomize_bn(tree, rng, path=()):
    """Non-trivial BatchNorm statistics and affine parameters, in place."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _randomize_bn(v, rng, path + (k,))
        elif path and "bn" in path[-1]:
            if k in ("var", "scale"):
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:  # mean, bias
                tree[k] = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)


def _variables(module, rng, seed, *args, **kw):
    variables = jax.tree_util.tree_map(
        np.array, module.init(jax.random.key(seed), *args, **kw))
    _randomize_bn(variables, rng)
    return variables


@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32),
                                     (jnp.bfloat16, torch.bfloat16)])
def test_normalize_images_matches_jax(rng, jdt, tdt):
    imgs = _images(rng)
    want = np.asarray(j_normalize(jnp.asarray(imgs), jdt).astype(jnp.float32))
    got = t_normalize(torch.from_numpy(imgs), tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("channels_last", [False, True])
def test_resnet_backbone_f32_matches_jax(rng, channels_last):
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    jm = jres.ResNetBackbone(jres.STAGE_BLOCKS["tiny"])
    variables = _variables(jm, rng, 0, x)
    want = np.asarray(jm.apply(variables, x))
    tm = load_jax_variables(tres.ResNetBackbone(tres.STAGE_BLOCKS["tiny"]), variables).eval()
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    if channels_last:
        tm = tm.to(memory_format=torch.channels_last)
    else:
        tx = tx.contiguous()
    got = tm(tx).permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape == (2, 2, 2, 2048)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("img_idx,final_dim", [(None, None), ([2, 0, 0, 1, 2, 1, 0], None),
                                               (None, 24)])
def test_image_pooled_encoder_f32_matches_jax(rng, img_idx, final_dim):
    imgs = _images(rng, n=3)
    idx = None if img_idx is None else np.asarray(img_idx, np.int32)
    jm = jenc.ImagePooledEncoder(16, final_dim=final_dim, arch="tiny")
    variables = _variables(jm, rng, 1, imgs, img_idx=idx)
    want = np.asarray(jm.apply(variables, imgs, img_idx=idx))
    tm = load_jax_variables(tenc.ImagePooledEncoder(16, final_dim=final_dim, arch="tiny"),
                            variables).eval()
    got = tm(torch.from_numpy(imgs),
             img_idx=None if idx is None else torch.from_numpy(idx).long())
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_image_pooled_encoder_bf16_matches_jax(seed):
    rng = np.random.default_rng(seed)
    imgs = _images(rng)
    variables = _variables(jenc.ImagePooledEncoder(16, arch="tiny"), rng, seed, imgs)
    want = np.asarray(jenc.ImagePooledEncoder(16, arch="tiny", dtype=jnp.bfloat16)
                      .apply(variables, imgs))
    tm = load_jax_variables(
        tenc.ImagePooledEncoder(16, arch="tiny", dtype=torch.bfloat16), variables).eval()
    assert tm.backbone.conv1.weight.dtype == torch.bfloat16
    assert tm.backbone.bn1.running_var.dtype == torch.float32
    got = tm(torch.from_numpy(imgs))
    assert got.dtype == torch.float32  # the bf16 pooled mean is cast to f32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=BF16_ATOL, rtol=BF16_RTOL)
