"""GRU: the port's ``GRU(use_kernel=True)`` (the plain version of the CUDA
``fused_gru_sequence`` on the CPU) against the JAX ``GRU(use_pallas=True)``
in interpret mode, ``GRUCellModule`` against its JAX counterpart, the
wrapper's checks and the kernel's bound.

Tolerance atol 1e-5, the one tests/test_pallas_kernels.py holds the Pallas
kernel to.  The CUDA kernel itself is held against the plain version and
against cuDNN's ``torch.nn.GRU`` on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from visuelle2_tpu.ops import gru as jgru
from visuelle2_tpu_torch.convert import load_jax_variables
from visuelle2_tpu_torch.ops import gru as tgru
from visuelle2_tpu_torch.ops.cuda import gru_seq as tgs
from visuelle2_tpu_torch.ops.cuda import roofline
from visuelle2_tpu_torch.perf import gru_split

ATOL = 1e-5


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,T,I,H", [(5, 7, 9, 12), (3, 52, 3, 16)])
def test_gru_kernel_path_matches_jax_pallas_path(rng, B, T, I, H, with_h0):
    x = rng.standard_normal((B, T, I)).astype(np.float32)
    h0 = rng.standard_normal((B, H)).astype(np.float32) if with_h0 else None
    variables = jax.tree_util.tree_map(
        np.array, jgru.GRU(H).init(jax.random.key(1), jnp.asarray(x)))
    jh0 = None if h0 is None else jnp.asarray(h0)
    with pltpu.force_tpu_interpret_mode():
        want, want_h = jgru.GRU(H, use_pallas=True).apply(variables, jnp.asarray(x), jh0)
    xla, xla_h = jgru.GRU(H).apply(variables, jnp.asarray(x), jh0)
    for use_kernel in (True, False):
        module = load_jax_variables(tgru.GRU(I, H, use_kernel=use_kernel), variables)
        before = tgs.fused_gru_sequence.launches
        with torch.inference_mode():
            got, got_h = module(torch.from_numpy(x), None if h0 is None else torch.from_numpy(h0))
        assert tgs.fused_gru_sequence.launches == before  # CPU: the plain version
        for g, w in ((got, want), (got_h, want_h), (got, xla), (got_h, xla_h)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_gru_cell_module_matches_jax(rng):
    B, I, H = 6, 17, 20
    x = rng.standard_normal((B, I)).astype(np.float32)
    h = rng.standard_normal((B, H)).astype(np.float32)
    module = jgru.GRUCellModule(H)
    variables = jax.tree_util.tree_map(
        np.array, module.init(jax.random.key(2), jnp.asarray(x), jnp.asarray(h)))
    want = module.apply(variables, jnp.asarray(x), jnp.asarray(h))
    cell = load_jax_variables(tgru.GRUCellModule(I, H), variables)
    with torch.inference_mode():
        got = cell(torch.from_numpy(x), torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_gru_init_is_uniform_in_the_jax_bound():
    """``registry.init_parameters`` draws every GRU parameter U(±1/√H)."""
    from visuelle2_tpu_torch.models.registry import init_parameters

    for module in (tgru.GRU(3, 64), tgru.GRUCellModule(65, 64)):
        init_parameters(module, torch.Generator().manual_seed(0))
        for p in module.parameters():
            assert p.abs().max() <= 1 / 8 and p.abs().max() > 0.1


def _wrapper_args(rng, B=4, T=5, I=3, H=8):
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return [f(B, T, I), f(I, 3 * H), f(H, 3 * H), f(3 * H), f(3 * H)]


@pytest.mark.parametrize("bad", ["f64", "non_contiguous", "mixed_device", "smem", "w_i_shape",
                                 "h0_shape", "empty"])
def test_wrapper_rejects_what_the_kernel_cannot_take(rng, bad):
    args, kw = _wrapper_args(rng), {}
    if bad == "f64":
        args[3] = args[3].double()
    elif bad == "non_contiguous":
        args[0] = args[0].transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "mixed_device":
        args[2] = args[2].to("meta")
    elif bad == "smem":
        # Past the resident layout's shared memory the kernel streams W_h and
        # h; what bounds H then is co-residency: 16 units a block, one block
        # on each of an H100's 132 SMs, H <= 2,112.  The limit is the
        # kernel's, checked off the CPU (the plain CPU path takes any H), so
        # the inputs lie on the meta device.
        args = [a.to("meta") for a in _wrapper_args(rng, B=1, T=1, I=1, H=2113)]
    elif bad == "w_i_shape":
        args[1] = args[1][:, 1:].contiguous()
    elif bad == "h0_shape":
        kw["h0"] = torch.zeros(3, 8)
    else:
        args[0] = args[0][:, :0]
    match = {"f64": "float32", "non_contiguous": "contiguous", "mixed_device": "one device",
             "smem": "H <= 2112", "w_i_shape": "w_i", "h0_shape": "h0",
             "empty": "non-empty"}[bad]
    with pytest.raises(ValueError, match=match):
        tgs.fused_gru_sequence(*args, **kw)


def test_wrapper_never_falls_back_off_the_cpu(rng):
    meta = [a.to("meta") for a in _wrapper_args(rng)]
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tgs.fused_gru_sequence(*meta)


def test_gru_sequence_bound_from_shapes():
    """The CrossAttnRNN trend GRU's shape (B=128, T=52, H=512): 10.5 GFLOP,
    156.8 µs at 67 TFLOP/s, set by operations."""
    n_bytes, flops = roofline.gru_sequence_cost(128, 52, 512)
    assert (n_bytes, flops) == (58_202_112, 10_503_061_504)
    ms, by = roofline.bound_ms(n_bytes, flops)
    assert by == "operations" and round(1e3 * ms, 1) == 156.8


def test_gru_sequence_f32_accurate_bound_from_shapes():
    """The same work as three TF32 tensor-core products per multiply-add
    (3xTF32, float32-accurate): 63.7 µs at the trend GRU's shape against
    156.8 in float32 FMAs, still set by operations."""
    cost = roofline.gru_sequence_cost(128, 52, 512)
    ms, by = roofline.f32_accurate_bound_ms(*cost)
    assert by == "operations" and round(1e3 * ms, 1) == 63.7
    assert ms == min(roofline.bound_ms(*cost)[0], roofline.bound_ms(cost[0], 3 * cost[1], "tf32")[0])


def test_persistent_kernel_shared_memory_and_its_hidden_limit(rng):
    """Two layouts.  Up to H = 724 a block keeps its W_h slice and one h
    tile in shared memory for the whole sequence: 164,352 bytes at H = 512,
    and 724 is the widest that fits the 232,448 bytes of a Hopper block.
    Past it a block streams both through two stages of 64-deep k-chunks,
    41,984 bytes whatever H, and the limit is the unit slices the card holds
    at once, 16 x its SMs: 2,112 on an H100.  The wrapper says so off the
    CPU; the plain CPU path keeps taking any H."""
    assert tgs.smem_bytes(512) == 4 * (48 * 512 + 32 * 516) == 164_352
    assert tgs.RESIDENT_MAX_HIDDEN == 724
    assert tgs.smem_bytes(724) <= 232_448 < tgs._resident_bytes(725)
    assert tgs.smem_bytes(13) == tgs.smem_bytes(16)  # k padded to 4
    streamed = 4 * 2 * (48 * 64 + 32 * 68)
    assert streamed == 41_984
    for H in (725, 1024, 1664, 2112):
        assert tgs.smem_bytes(H) == streamed
    assert tgs.MAX_HIDDEN == tgs.max_hidden(132) == 2112
    assert tgs.max_hidden(114) == 1824  # the SM count of the card, read at the call
    for H in (724, 725):
        args = _wrapper_args(rng, B=2, T=1, I=2, H=H)
        outs, h_last = tgs.fused_gru_sequence(*args)
        assert outs.shape == (2, 1, H) and torch.equal(outs[:, 0], h_last)
        want, _ = tgs.fused_gru_sequence_plain(*args)
        torch.testing.assert_close(outs, want, atol=0, rtol=0)
    outs, _ = tgs.fused_gru_sequence(*_wrapper_args(rng, B=1, T=1, I=1, H=2113))
    assert outs.shape == (1, 1, 2113)  # the CPU path has no limit
    meta = lambda H: [a.to("meta") for a in _wrapper_args(rng, B=2, T=1, I=2, H=H)]
    for H in (724, 725, 1664, 2112):
        with pytest.raises(ValueError, match="runs on cuda or cpu"):
            tgs.fused_gru_sequence(*meta(H))
    with pytest.raises(ValueError, match="H <= 2112"):
        tgs.fused_gru_sequence(*meta(2113))


def test_gru_split_variants_apply_to_the_kernel_source():
    """Each variant of ``perf/gru_split.py`` removes its part from the
    current kernel source, and raises when a line it replaces is gone."""
    text = gru_split.SOURCE.read_text()
    variants = gru_split.variant_sources(text)
    assert variants["whole"] == text
    assert "while (false && load_acquire" in variants["no_barrier"]
    assert "red.release.gpu" in variants["no_barrier"]  # the blocks still arrive
    assert "false ? __ldcg(reinterpret_cast<const float4*>" in variants["no_h_loads"]
    assert "w4[(q * 3 + g)" not in variants["no_w_loads"]
    assert "q < 0; ++q" in variants["no_products"]
    with pytest.raises(RuntimeError, match="is not in gru_seq.cu"):
        gru_split.variant_sources(text.replace("for (int q = 0; q < nq; ++q) {", ""))
