"""Port ops and small encoders vs their JAX modules, in f32 on the CPU.

The same seeded numpy inputs go through the JAX module and its counterpart
in ``visuelle2_tpu_torch``; the JAX weights cross over through
``convert.load_jax_variables``.  Tolerance atol 1e-5: both sides are f32 and
differ only in the order of their sums.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from visuelle2_tpu.models import encoders as jenc
from visuelle2_tpu.ops import attention as jattn
from visuelle2_tpu.ops import gru as jgru
from visuelle2_tpu.ops import masks as jmasks
from visuelle2_tpu.ops import positional as jpos
from visuelle2_tpu.ops import transformer as jtr
from visuelle2_tpu_torch.convert import load_jax_variables
from visuelle2_tpu_torch.models import encoders as tenc
from visuelle2_tpu_torch.ops import attention as tattn
from visuelle2_tpu_torch.ops import gru as tgru
from visuelle2_tpu_torch.ops import masks as tmasks
from visuelle2_tpu_torch.ops import positional as tpos
from visuelle2_tpu_torch.ops import transformer as ttr

ATOL = 1e-5


def _init(module, *args, **kw):
    variables = module.init(jax.random.key(0), *args, **kw)
    return jax.tree_util.tree_map(np.array, variables)


def _port(module, variables):
    return load_jax_variables(module, variables).eval()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("kind,size,horizon", [
    ("gcd", 52, 12), ("gcd", 52, 10), ("causal", 12, None), ("causal", 1, None)])
def test_masks_match_jax(kind, size, horizon):
    if kind == "gcd":
        want = jmasks.gcd_block_mask(size, horizon)
        got = tmasks.gcd_block_mask(size, horizon)
    else:
        want = jmasks.causal_mask(size)
        got = tmasks.causal_mask(size)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("max_len,d_model", [(52, 16), (12, 64), (7, 5)])
def test_positional_encoding_matches_jax(rng, max_len, d_model):
    np.testing.assert_array_equal(tpos.sinusoidal_table(max_len, d_model),
                                  jpos.sinusoidal_table(max_len, d_model))
    x = rng.standard_normal((3, max_len, d_model)).astype(np.float32)
    want = jpos.PositionalEncoding(d_model, max_len=max_len).apply({}, jnp.asarray(x))
    _close(tpos.PositionalEncoding(d_model, max_len=max_len)(_t(x)), want)


@pytest.mark.parametrize("case", ["self_gcd", "cross_one_token", "self_causal"])
def test_mha_matches_jax(rng, case):
    B, D, h = 5, 16, 4
    Lq, Lk = {"self_gcd": (52, 52), "cross_one_token": (1, 52),
              "self_causal": (12, 12)}[case]
    q = rng.standard_normal((B, Lq, D)).astype(np.float32)
    kv = q if case != "cross_one_token" else \
        rng.standard_normal((B, Lk, D)).astype(np.float32)
    jmask = {"self_gcd": jmasks.gcd_block_mask(52, 12), "cross_one_token": None,
             "self_causal": jmasks.causal_mask(12)}[case]
    tmask = None if jmask is None else _t(np.array(jmask))
    jm = jattn.MultiHeadAttention(D, h, dropout=0.1)
    variables = _init(jm, q, kv, kv, mask=jmask)
    want, want_p = jm.apply(variables, q, kv, kv, mask=jmask)
    tm = _port(tattn.MultiHeadAttention(D, h), variables)
    got, got_p = tm(_t(q), _t(kv), _t(kv), mask=tmask)
    _close(got, want)
    _close(got_p, want_p)


def test_encoder_layer_matches_jax(rng):
    x = rng.standard_normal((4, 52, 16)).astype(np.float32)
    mask = jmasks.gcd_block_mask(52, 12)
    jm = jtr.TransformerEncoderLayer(16, 4, dim_feedforward=2048)
    variables = _init(jm, x, mask=mask)
    want = jm.apply(variables, x, mask=mask)
    tm = _port(ttr.TransformerEncoderLayer(16, 4, dim_feedforward=2048), variables)
    _close(tm(_t(x), mask=_t(np.array(mask))), want)


def test_gated_encoder_matches_jax(rng):
    """gated_v2's trend encoder: HeadSpecificGatedAttention layers (the
    port's wrapper runs its plain version on the CPU)."""
    x = rng.standard_normal((3, 52, 16)).astype(np.float32)
    mask = jmasks.gcd_block_mask(52, 12)
    jm = jtr.TransformerEncoder(16, 4, 2, dim_feedforward=64, gated=True)
    variables = _init(jm, x, mask=mask)
    want = jm.apply(variables, x, mask=mask)
    tm = _port(ttr.TransformerEncoder(16, 4, 2, dim_feedforward=64, gated=True), variables)
    _close(tm(_t(x), mask=_t(np.array(mask))), want, atol=2e-5)


@pytest.mark.parametrize("variant", ["standard", "gated_v1", "gated_v2"])
@pytest.mark.parametrize("autoregressive", [False, True])
def test_decoder_matches_jax(rng, autoregressive, variant):
    L = 12 if autoregressive else 1
    tgt = rng.standard_normal((4, L, 16)).astype(np.float32)
    mem = rng.standard_normal((4, 52, 16)).astype(np.float32)
    jmask = jmasks.causal_mask(L) if autoregressive else None
    tmask = tmasks.causal_mask(L) if autoregressive else None
    jm = jtr.TransformerDecoder(16, 4, 1, dim_feedforward=64, variant=variant)
    variables = _init(jm, tgt, mem, tgt_mask=jmask)
    want = jm.apply(variables, tgt, mem, tgt_mask=jmask)
    tm = _port(ttr.TransformerDecoder(16, 4, 1, dim_feedforward=64, variant=variant),
               variables)
    # The gated-MHA tolerance of tests/test_pallas_kernels.py for gated_v2.
    _close(tm(_t(tgt), _t(mem), tgt_mask=tmask), want,
           atol=2e-5 if variant == "gated_v2" else ATOL)


def test_unported_variants_raise():
    with pytest.raises(KeyError, match="gated_v2"):
        ttr.TransformerDecoder(16, 4, 1, variant="gated_v5")


@pytest.mark.parametrize("with_h0", [False, True])
def test_gru_matches_jax(rng, with_h0):
    B, T, I, H = 6, 9, 3, 16
    x = rng.standard_normal((B, T, I)).astype(np.float32)
    h0 = rng.standard_normal((B, H)).astype(np.float32) if with_h0 else None
    jm = jgru.GRU(H)
    variables = _init(jm, x, h0)
    want, want_h = jm.apply(variables, x, h0)
    tm = _port(tgru.GRU(I, H), variables)
    got, got_h = tm(_t(x), None if h0 is None else _t(h0))
    _close(got, want)
    _close(got_h, want_h)


@pytest.mark.parametrize("gated", [False, True])
def test_gtrend_embedder_matches_jax(rng, gated):
    g = rng.random((4, 3, 52)).astype(np.float32)
    jm = jenc.GTrendEmbedder(12, 16, nhead=4, gated=gated)
    variables = _init(jm, g)
    want = jm.apply(variables, g)
    tm = _port(tenc.GTrendEmbedder(12, 16, nhead=4, gated=gated), variables)
    _close(tm(_t(g)), want, atol=2e-5 if gated else ATOL)


@pytest.mark.parametrize("combine", ["sum", "stack", "concat_proj"])
def test_attribute_encoder_matches_jax(rng, combine):
    idx = [rng.integers(0, n, 7).astype(np.int32) for n in (5, 6, 5, 126)]
    jm = jenc.AttributeEncoder(5, 6, 5, 126, 16, combine=combine, hidden_dim=24)
    variables = _init(jm, *idx)
    want = jm.apply(variables, *idx)
    tm = _port(tenc.AttributeEncoder(5, 6, 5, 126, 16, combine=combine,
                                     hidden_dim=24), variables)
    _close(tm(*(_t(i).long() for i in idx)), want)


def test_dummy_and_sales_encoders_match_jax(rng):
    temporal = rng.random((7, 4)).astype(np.float32)
    jm = jenc.DummyEmbedder(16)
    variables = _init(jm, temporal)
    _close(_port(tenc.DummyEmbedder(16), variables)(_t(temporal)),
           jm.apply(variables, temporal))
    jm = jenc.TemporalEmbedder(16, 24)
    variables = _init(jm, temporal)
    _close(_port(tenc.TemporalEmbedder(16, 24), variables)(_t(temporal)),
           jm.apply(variables, temporal))

    sales = rng.random((7, 2, 1)).astype(np.float32)
    jm = jenc.SalesEncoder(16)
    variables = _init(jm, sales)
    _close(_port(tenc.SalesEncoder(16), variables)(_t(sales)),
           jm.apply(variables, sales))
