"""The port's InceptionV3 backbone and the legacy blocks on the CPU: the
backbone against the JAX ``InceptionV3Backbone`` (weights carried across by
``convert``) and against ``tests/torch_ref.py::TorchInception3`` loaded from
its state dict, the legacy patch encoder against the JAX
``LegacyImageEncoder``, its freeze, and the legacy re-exports.

f32 at 75² (torchvision's smallest legal input; an 1 x 1 final map), B = 2,
weights drawn by the port's registry initializers with the BatchNorm
statistics moved off their 0 / 1 start; tolerance 1e-4, a whole forward's.
"""

import numpy as np
import pytest
import torch

import jax

from tests.torch_ref import TorchInception3
from visuelle2_tpu.models.inception import InceptionV3Backbone as JInception
from visuelle2_tpu.models.legacy import LegacyImageEncoder as JLegacyImageEncoder
from visuelle2_tpu_torch.convert import load_jax_variables, to_jax_variables
from visuelle2_tpu_torch.models import legacy
from visuelle2_tpu_torch.models.encoders import TemporalFeatureEncoder
from visuelle2_tpu_torch.models.inception import (
    BN_EPS,
    BasicConv2d,
    InceptionV3Backbone,
    inception_state_dict_from_torch,
)
from visuelle2_tpu_torch.models.registry import init_parameters
from visuelle2_tpu_torch.ops.attention import AdditiveAttention

ATOL = 1e-4
SIZE = 75


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one CPU thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _drawn(module, seed):
    """``module`` with the registry's initializers and BatchNorm statistics
    near a trained net's (mean ±0.1, variance 0.5–1.5), in eval mode."""
    init_parameters(module, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, buf in module.named_buffers():
            if name.endswith("running_mean"):
                buf.uniform_(-0.1, 0.1, generator=gen)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=gen)
    return module.eval()


def test_backbone_matches_jax():
    net = _drawn(InceptionV3Backbone(), seed=0)
    x = np.random.default_rng(0).standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    want = jax.jit(JInception().apply)(to_jax_variables(net), x)
    with torch.inference_mode():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, 2048, 1, 1) and np.abs(np.asarray(want)).max() > 0.01
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    # The bridge is strict both ways: every leaf back into a fresh module.
    again = load_jax_variables(InceptionV3Backbone(), to_jax_variables(net)).eval()
    with torch.inference_mode():
        assert torch.equal(again(torch.from_numpy(x).permute(0, 3, 1, 2)), got)


def test_backbone_loads_a_torchvision_state_dict():
    torch.manual_seed(0)
    reference = TorchInception3().eval()
    with torch.no_grad():
        for m in reference.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 1.5)
    state = dict(reference.state_dict())
    # torchvision's pretrained net ships its auxiliary classifier and head.
    state["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    state["fc.weight"] = torch.zeros(1000, 2048)
    net = InceptionV3Backbone().eval()
    net.load_state_dict(inception_state_dict_from_torch(state), strict=True)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, SIZE, SIZE)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(net(x), reference(x), rtol=0, atol=ATOL)
    assert all(m.bn.eps == BN_EPS == 1e-3 for m in net.modules() if isinstance(m, BasicConv2d))


def test_legacy_image_encoder_matches_jax_and_is_frozen():
    enc = _drawn(legacy.LegacyImageEncoder(16), seed=2)
    images = np.random.default_rng(2).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    want = jax.jit(JLegacyImageEncoder(16).apply)(to_jax_variables(enc), images)
    with torch.inference_mode():
        got = enc(torch.from_numpy(images))
    assert got.shape == (2, 1, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    # fine_tune=False: no gradient into the backbone, whose BatchNorm stays on
    # its running statistics in train mode.
    enc.train()
    assert not enc.backbone.training and enc.fc.training
    stats = {k: v.clone() for k, v in enc.backbone.state_dict().items()}
    enc(torch.from_numpy(images)).sum().backward()
    assert all(p.grad is None and not p.requires_grad for p in enc.backbone.parameters())
    assert enc.fc.weight.grad is not None
    assert all(torch.equal(v, stats[k]) for k, v in enc.backbone.state_dict().items())
    tuned = legacy.LegacyImageEncoder(16, fine_tune=True).train()
    assert tuned.backbone.training and all(p.requires_grad for p in tuned.parameters())


def test_legacy_blocks_are_the_shared_ones():
    attn = legacy.LegacyAdditiveAttention(8, 6, 8)
    assert isinstance(attn, AdditiveAttention) and attn.weight_on == "projected"
    temporal = legacy.LegacyTemporalFeatureEncoder(8)
    assert isinstance(temporal, TemporalFeatureEncoder) and temporal.week is None
    assert legacy.TSEmbedder and legacy.AttributeEncoder
