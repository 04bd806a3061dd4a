"""The port on the card: the CUDA kernels against their plain versions, no
fallback on CUDA tensors, and the models on the card against the same
models on the CPU.  Every test here needs an NVIDIA GPU and skips without one.

This file imports torch and the port only, so it also runs where JAX is not
installed: ``python -m pytest tests/test_torch_cuda.py --noconftest -q``.
"""

import numpy as np
import pytest
import torch

from visuelle2_tpu_torch.models import VocabSizes, build
from visuelle2_tpu_torch.ops.cuda import _build
from visuelle2_tpu_torch.ops.cuda import gated_fusion as tgf
from visuelle2_tpu_torch.ops.cuda import gated_mha as tgm
from visuelle2_tpu_torch.ops.masks import gcd_block_mask

pytestmark = pytest.mark.cuda

ATOL = 1e-5  # kernel vs plain: both f32, sums in another order
# Gated MHA: the tolerance tests/test_pallas_kernels.py holds the Pallas
# kernel to (softmax and five chained products, sums in another order).
MHA_ATOL, MHA_RTOL = 2e-5, 1e-5


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _inputs(B, D, C, seed=0):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, D)), rng.standard_normal((B, C)),
              rng.standard_normal((D, D)) * 0.1, rng.standard_normal((C, D)) * 0.1,
              rng.standard_normal(D))
    return [torch.from_numpy(a.astype(np.float32)).cuda() for a in arrays]


@pytest.mark.parametrize("residual", [True, False])
# (3, 64, 512) stages 157 KB of weights: dynamic shared memory above 48 KB.
@pytest.mark.parametrize("shape", [(128, 32, 128), (37, 48, 96), (3, 64, 512)])
def test_kernel_matches_plain(residual, shape):
    arrays = _inputs(*shape)
    before = tgf.fused_gated_residual.launches
    got = tgf.fused_gated_residual(*arrays, residual=residual)
    torch.cuda.synchronize()
    assert tgf.fused_gated_residual.launches == before + 1
    want = tgf.fused_gated_residual_plain(*arrays, residual=residual)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_kernel_rejects_what_it_cannot_take():
    x, ctx, wx, wc, b = _inputs(8, 32, 128)
    with pytest.raises(ValueError, match="contiguous"):
        tgf.fused_gated_residual(x.t().contiguous().t(), ctx, wx, wc, b)
    big = _inputs(4, 256, 256)  # 515 KB of shared memory: more than a block may use
    with pytest.raises(ValueError, match="shared memory"):
        tgf.fused_gated_residual(*big)


def test_no_fallback_without_the_kernel(monkeypatch):
    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(_build, "load_library", no_library)
    tgf._kernel.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="unavailable"):
            tgf.fused_gated_residual(*_inputs(8, 32, 128))
    finally:
        tgf._kernel.cache_clear()


def _mha_inputs(B, Lq, Lk, D, heads, variant, masked, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(
        (rng.standard_normal(s) * scale).astype(np.float32)).cuda()
    query = f(B, Lq, D)
    key = query if Lq == Lk else f(B, Lk, D)
    mask = (gcd_block_mask(Lq, 12) if masked else torch.zeros(Lq, Lk)).cuda()
    G = D // heads if variant == "head" else D
    weights = []
    for n in (D, D, D, G, D):
        weights += [f(n, n, scale=n ** -0.5), f(n, scale=0.1)]
    return [query, key, key, mask, *weights]


@pytest.mark.parametrize("variant,shape,masked", [
    ("head", (128, 52, 52, 64, 4), True),    # gated_v2 trend encoder
    ("head", (128, 52, 52, 64, 4), False),
    ("pure", (128, 1, 52, 64, 4), False),    # decoder cross-attention, non-AR
    ("pure", (128, 12, 52, 64, 4), False),   # decoder cross-attention, AR
    ("pure", (37, 52, 52, 48, 4), True),     # ragged batch, another width
    ("head", (37, 12, 52, 48, 4), False),
])
def test_gated_mha_kernel_matches_plain(variant, shape, masked):
    B, Lq, Lk, D, heads = shape
    args = _mha_inputs(B, Lq, Lk, D, heads, variant, masked)
    before = tgm.fused_gated_mha.launches
    got = tgm.fused_gated_mha(*args, num_heads=heads, variant=variant)
    torch.cuda.synchronize()
    assert tgm.fused_gated_mha.launches == before + 1
    want = tgm.fused_gated_mha_plain(*args, num_heads=heads, variant=variant)
    torch.testing.assert_close(got, want, atol=MHA_ATOL, rtol=MHA_RTOL)


def test_gated_mha_no_fallback_without_the_kernel(monkeypatch):
    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(_build, "load_library", no_library)
    tgm._kernel.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="unavailable"):
            tgm.fused_gated_mha(*_mha_inputs(4, 52, 52, 64, 4, "head", True),
                                num_heads=4, variant="head")
    finally:
        tgm._kernel.cache_clear()


def test_gated_v2_on_card_matches_cpu():
    """gated_v2 (tiny backbone, f32) launches the gated-MHA kernel three
    times per forward on the card and matches the CPU plain path."""
    kw = dict(image_arch="tiny", vocab=VocabSizes(5, 6, 5, 126))
    model = build("gated_v2", **kw)
    cpu = build("gated_v2", device="cpu", **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    tb = {k: torch.from_numpy(v) for k, v in _batch(6).items()}
    before = tgm.fused_gated_mha.launches
    with torch.inference_mode():
        on_card = model({k: v.cuda() for k, v in tb.items()})[0].cpu()
        on_cpu = cpu(tb)[0]
    assert tgm.fused_gated_mha.launches == before + 3
    torch.testing.assert_close(on_card, on_cpu, atol=1e-4, rtol=0)


def _batch(n):
    rng = np.random.default_rng(3)
    return {
        "ts": rng.random((n, 12)).astype(np.float32),
        "cat": rng.integers(0, 5, n), "col": rng.integers(0, 6, n),
        "fab": rng.integers(0, 5, n), "store": rng.integers(0, 126, n),
        "temporal": rng.random((n, 4)).astype(np.float32),
        "gtrends": rng.random((n, 3, 52)).astype(np.float32),
        "images": rng.integers(0, 255, (n, 64, 64, 3)).astype(np.uint8),
    }


def test_slice_on_card_matches_cpu():
    """gated_v4 (tiny backbone, f32) built without a device lands on the card,
    launches the kernel twice per forward, and matches the CPU plain path."""
    kw = dict(image_arch="tiny", vocab=VocabSizes(5, 6, 5, 126))
    model = build("gated_v4", **kw)
    assert next(model.parameters()).is_cuda
    cpu = build("gated_v4", device="cpu", **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    tb = {k: torch.from_numpy(v) for k, v in _batch(6).items()}
    before = tgf.fused_gated_residual.launches
    with torch.inference_mode():
        on_card = model({k: v.cuda() for k, v in tb.items()})[0].cpu()
        on_cpu = cpu(tb)[0]
    assert tgf.fused_gated_residual.launches == before + 2
    # f32 on both; the card's cuDNN/cuBLAS sum in another order (TF32 off).
    torch.testing.assert_close(on_card, on_cpu, atol=1e-4, rtol=0)
