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
        # 6·64·256 + 64·257 + 16·64 floats: 463,104 bytes, over the 232,448
        # a Hopper block may use.
        args = _wrapper_args(rng, B=1, Lq=64, Lk=64, Dm=256)
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
