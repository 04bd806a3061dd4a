"""Additive attention: the port's ``AdditiveAttention`` and the plain version
of its CUDA kernel against the JAX module, on its XLA path and on its Pallas
kernel in interpret mode; the wrapper's checks; the kernel's bounds.

The same seeded numpy inputs go through both frameworks; the JAX weights
cross over through ``convert.load_jax_variables``.  Tolerance atol 1e-5, the
one tests/test_pallas_kernels.py holds the Pallas kernel to: the same formula,
sums in another order.  On the CPU the wrapper runs its plain version; the
CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from visuelle2_tpu.ops import attention as jattn
from visuelle2_tpu.ops.pallas import fused_additive_attention as jfused
from visuelle2_tpu_torch.convert import load_jax_variables
from visuelle2_tpu_torch.ops import attention as tattn
from visuelle2_tpu_torch.ops.cuda import additive_attention as taa
from visuelle2_tpu_torch.ops.cuda import roofline
from visuelle2_tpu_torch.perf import additive_split

ATOL = 1e-5
# (B, L, De, Dd, A): De ≠ A ≠ Dd with a ragged batch; the CrossAttnRNN
# calls' lengths (image patches, trend steps, fused tokens) at small widths.
SHAPES = [(7, 13, 24, 20, 12), (5, 4, 16, 20, 16), (3, 52, 16, 20, 16), (6, 2, 8, 12, 10)]


def _inputs(rng, B, L, De, Dd):
    return (rng.standard_normal((B, L, De)).astype(np.float32),
            rng.standard_normal((B, Dd)).astype(np.float32))


def _jax_module(rng, shape, weight_on):
    B, L, De, Dd, A = shape
    enc, dec = _inputs(rng, B, L, De, Dd)
    module = jattn.AdditiveAttention(A, weight_on=weight_on)
    variables = jax.tree_util.tree_map(
        np.array, module.init(jax.random.key(0), jnp.asarray(enc), jnp.asarray(dec)))
    return module, variables, enc, dec


def _port(variables, shape, weight_on):
    _, _, De, Dd, A = shape
    return load_jax_variables(tattn.AdditiveAttention(De, Dd, A, weight_on=weight_on),
                              variables).eval()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("weight_on", ["inputs", "projected"])
def test_additive_attention_matches_jax(rng, weight_on, shape):
    module, variables, enc, dec = _jax_module(rng, shape, weight_on)
    want, want_alpha = module.apply(variables, jnp.asarray(enc), jnp.asarray(dec))
    before = taa.fused_additive_attention.launches
    with torch.inference_mode():
        got, alpha = _port(variables, shape, weight_on)(torch.from_numpy(enc),
                                                        torch.from_numpy(dec))
    assert taa.fused_additive_attention.launches == before  # CPU: the plain version
    Dw = shape[2] if weight_on == "inputs" else shape[4]
    assert tuple(got.shape) == shape[:2] + (Dw,) and tuple(alpha.shape) == shape[:2]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(want_alpha), atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[1]])
@pytest.mark.parametrize("weight_on", ["inputs", "projected"])
def test_plain_version_matches_jax_pallas_kernel(rng, weight_on, shape):
    """The plain version against the Pallas kernel itself (interpret mode,
    a batch tile that leaves a ragged edge)."""
    _, variables, enc, dec = _jax_module(rng, shape, weight_on)
    p = variables["params"]
    weights = (p["encoder_linear"]["kernel"], p["decoder_linear"]["kernel"],
               p["attn_linear"]["kernel"], p["attn_linear"]["bias"])
    want, want_alpha = jfused(jnp.asarray(enc), jnp.asarray(dec), *weights,
                              weight_on=weight_on, block_b=4, interpret=True)
    t = torch.from_numpy
    got, alpha = taa.fused_additive_attention(t(enc), t(dec), *map(t, weights),
                                              weight_on=weight_on)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(want_alpha), atol=ATOL, rtol=0)


@pytest.mark.parametrize("weight_on", ["inputs", "projected"])
def test_module_matches_jax_module_on_its_pallas_path(rng, weight_on):
    """The JAX module with use_pallas=True under force_tpu_interpret_mode."""
    shape = SHAPES[0]
    _, variables, enc, dec = _jax_module(rng, shape, weight_on)
    with pltpu.force_tpu_interpret_mode():
        want, want_alpha = jattn.AdditiveAttention(
            shape[4], weight_on=weight_on, use_pallas=True).apply(
                variables, jnp.asarray(enc), jnp.asarray(dec))
    with torch.inference_mode():
        got, alpha = _port(variables, shape, weight_on)(torch.from_numpy(enc),
                                                        torch.from_numpy(dec))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(want_alpha), atol=ATOL, rtol=0)


def _wrapper_args(rng, B=4, L=6, De=8, Dd=12, A=10):
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return [f(B, L, De), f(B, Dd), f(De, A), f(Dd, A), f(A, 1), f(1)]


@pytest.mark.parametrize("bad", ["f64", "non_contiguous", "mixed_device", "smem", "we_shape",
                                 "v_shape", "weight_on", "empty"])
def test_wrapper_rejects_what_the_kernel_cannot_take(rng, bad):
    kw = dict(weight_on="inputs")
    args = _wrapper_args(rng)
    if bad == "f64":
        args[2] = args[2].double()
    elif bad == "non_contiguous":
        args[0] = args[0].transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "mixed_device":
        args[3] = args[3].to("meta")
    elif bad == "smem":
        # L = 60,000: the softmax block's energies alone take 240,000 bytes
        # of the 232,448 a Hopper block may use.
        args = _wrapper_args(rng, B=1, L=60000, De=2, Dd=2, A=2)
    elif bad == "we_shape":
        args[2] = args[2][:-1].contiguous()
    elif bad == "v_shape":
        args[4] = args[4][:, 0].contiguous()
    elif bad == "weight_on":
        kw["weight_on"] = "both"
    else:
        args[0], args[1] = args[0][:0], args[1][:0]
    match = {"f64": "float32", "non_contiguous": "contiguous", "mixed_device": "one device",
             "smem": "shared memory", "we_shape": "we", "v_shape": "'v'",
             "weight_on": "weight_on", "empty": "non-empty"}[bad]
    with pytest.raises(ValueError, match=match):
        taa.fused_additive_attention(*args, **kw)


def test_wrapper_never_falls_back_off_the_cpu(rng):
    """Only CPU tensors take the plain version: tensors on any other device
    go to the kernel or raise."""
    meta = [a.to("meta") for a in _wrapper_args(rng)]
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        taa.fused_additive_attention(*meta)


def test_wrapper_matches_plain_on_cpu(rng):
    args = _wrapper_args(rng)
    for weight_on in ("inputs", "projected"):
        got = taa.fused_additive_attention(*args, weight_on=weight_on)
        want = taa.fused_additive_attention_plain(*args, weight_on=weight_on)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_additive_attention_bound_from_shapes():
    """The Demand calls' bounds (B=128, De=Dd=A=512): 101.5 µs over the image
    patches, 53.2 µs over the trend steps, 5.0 µs over the fused tokens; all
    set by operations."""
    for L, want_us in ((100, 101.5), (52, 53.2), (4, 5.0)):
        n_bytes, flops = roofline.additive_attention_cost(128, L, 512, 512, 512, "projected")
        ms, by = roofline.bound_ms(n_bytes, flops)
        assert by == "operations" and round(1e3 * ms, 1) == want_us
    assert roofline.additive_attention_cost(128, 100, 512, 512, 512, "inputs") == \
        (54_841_348, 6_797_656_064)


def test_f32_accurate_bound_from_shapes():
    """With three TF32 tensor-core products per multiply-add (3xTF32) the
    card can do the same float32-accurate work in less time than in float32
    FMAs: at the Demand calls 41.2 / 21.6 / 2.0 µs against 101.5 / 53.2 /
    5.0, still set by operations."""
    for L, want_us, simt_us in ((100, 41.2, 101.5), (52, 21.6, 53.2), (4, 2.0, 5.0)):
        cost = roofline.additive_attention_cost(128, L, 512, 512, 512, "projected")
        ms, by = roofline.f32_accurate_bound_ms(*cost)
        assert by == "operations" and round(1e3 * ms, 1) == want_us
        assert round(1e3 * roofline.bound_ms(*cost)[0], 1) == simt_us
    # A kernel set by its bytes keeps the bytes' bound.
    assert roofline.f32_accurate_bound_ms(4e6, 1.0) == roofline.bound_ms(4e6, 1.0)


# (B, L, De, Dd, A) -> (bn, GEMM tiles) on an H100's 132 SMs: the three
# Demand calls and the card tests' ragged shapes (tests/test_torch_cuda.py).
PLANS = {
    (128, 100, 512, 512, 512): (104, 505),  # 3.83 waves: the 4th 83% full
    (128, 52, 512, 512, 512): (128, 212),   # 1.61 waves
    (128, 4, 512, 512, 512): (32, 80),      # one wave
    (37, 13, 48, 40, 24): (32, 5),
    (5, 2, 16, 20, 16): (32, 2),
    (3, 150, 32, 16, 80): (32, 15),
    (3, 7, 13, 9, 70): (32, 6),
    (23, 100, 40, 24, 200): (64, 76),
}


@pytest.mark.parametrize("shape", list(PLANS))
def test_launch_plan_fills_the_last_wave(shape):
    """The GEMM's tiles: (ceil(B·L / 128) + ceil(B / 128)) x ceil(A / bn),
    bn in (128, 104, 64, 32) chosen so that the SM with the most tiles costs
    least, a tile costing its width plus 64 columns' worth for its 128 rows
    of enc.  At L = 100 the last wave is 83% full, where 128-wide tiles
    would leave 8 of 132 SMs busy; at L = 52 no width ends fuller in as few
    waves."""
    B, L, De, Dd, A = shape
    want_bn, want_tiles = PLANS[shape]
    rows = -(-B * L // 128) + -(-B // 128)
    tiles = lambda bn: rows * -(-A // bn)
    for projected in (False, True):
        plan = taa.launch_plan(*shape, projected=projected)
        assert (plan["bn"], tiles(plan["bn"])) == (want_bn, want_tiles)
        assert plan["smem_attend"] == 4 * (2 * A + L + 32)
        # h goes to a scratch only where out cannot hold it ("inputs", A >
        # De); out's rows then stride De, a scratch's or "projected" A.
        h_scratch = not projected and A > De
        assert plan["h_in_out"] == (not h_scratch)
        assert plan["ldh"] == (De if not projected and not h_scratch else A)
    if (B, L) == (128, 100):
        waves = tiles(plan["bn"]) / 132
        assert waves - int(waves) >= 0.8 and waves < 4
    if (B, L) == (128, 52):
        for bn in (104, 64, 32):
            assert math.ceil(tiles(bn) / 132) * (bn + 64) > 2 * (128 + 64)


def _tf32(x):
    """x rounded to TF32's 10 bits of mantissa, to nearest, ties away from
    zero (cvt.rna.tf32.f32)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _matmul_3xtf32(a, b):
    """a @ b as the kernel's tensor cores take it: each operand split into
    hi = TF32 to nearest and lo = (x - hi) to nearest, then (lo·hi + hi·lo)
    + hi·hi summed in float32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    t = torch.from_numpy
    return (t(a_lo) @ t(b_hi) + t(a_hi) @ t(b_lo)) + t(a_hi) @ t(b_hi)


@pytest.mark.parametrize("L", [100, 52, 4])
def test_3xtf32_products_keep_the_float32_tolerance(L):
    """The plain formula with enc·We and dec·Wd as 3xTF32 products, summed
    in IEEE float32, stays within the kernel's tolerance (2e-5 + 1e-5·|want|)
    of the float32 plain version at the Demand widths, where one TF32
    product does not.  This pins the split's arithmetic only: the card's
    tensor cores sum in float32 less exactly than this emulation, which is
    why the kernel keeps each of their sums to one 32-deep chunk, and
    chip_smoke.py measures what is left on the card."""
    B, De, Dd, A = 8, 512, 512, 512
    rng = np.random.default_rng(L)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    enc, dec = f(B, L, De), f(B, Dd)
    we, wd, v, vb = f(De, A, scale=De ** -0.5), f(Dd, A, scale=Dd ** -0.5), \
        f(A, 1, scale=A ** -0.5), f(1)
    t = torch.from_numpy
    for weight_on in ("inputs", "projected"):
        want = taa.fused_additive_attention_plain(t(enc), t(dec), t(we), t(wd), t(v), t(vb),
                                                  weight_on=weight_on)
        for product, close in ((_matmul_3xtf32, True),
                               (lambda a, b: t(_tf32(a)) @ t(_tf32(b)), False)):
            h = product(enc.reshape(B * L, De), we).reshape(B, L, A)
            s = product(dec, wd)
            energy = (torch.tanh(h + s[:, None, :]) @ t(v))[..., 0] + t(vb)[0]
            alpha = torch.softmax(energy, dim=1)
            got = (alpha[..., None] * (t(enc) if weight_on == "inputs" else h), alpha)
            ok = all(bool(((g - w).abs() <= 2e-5 + 1e-5 * w.abs()).all())
                     for g, w in zip(got, want))
            assert ok == close, (weight_on, close)


def test_additive_split_variants_apply_to_the_kernel_source():
    """Each variant of ``perf/additive_split.py`` removes its part from the
    current kernel source, and raises when a line it replaces is gone."""
    text = additive_split.SOURCE.read_text()
    variants = additive_split.variant_sources(text)
    assert variants["whole"] == text
    assert "wgmma_tf32<BN>(acc" not in variants["no_products"]
    assert "cp_async16(dst" not in variants["no_loads"]
    assert "cp_async4(dst" not in variants["no_loads"]
    assert "tanhf" not in variants["no_fold"]
    assert variants["one_product"].count("wgmma_tf32<BN>(acc") == 1
    assert "core_desc(b_hi + 64 * ks), ks);" in variants["one_product"]
    with pytest.raises(RuntimeError, match="is not in additive_attention.cu"):
        additive_split.variant_sources(text.replace(additive_split._PRODUCTS[0], ""))
