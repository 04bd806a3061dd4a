"""Training the CrossAttnRNN family with the port on the CPU, against the JAX
package: three train steps of ``Trainer`` against the JAX ``Trainer``
(unclipped Adafactor, the train_dl family's) for Demand, 2-1 and 2-10 with
teacher forcing at ratio 1 and 0 (deterministic in both frameworks) and
dropout off; the two kernels' autograd functions against ``jax.grad`` of the
JAX plain formulas and ``gradcheck``; the teacher-forcing coins; the dropout
rate at every dropout site; ``--remat`` reaching the backbone; the weight
bridge on a trained model; ``train_dl``'s ``hparams.json`` against the JAX
trainer's; and ``train_dl`` -> ``forecast_dl --ckpt_path`` with pandas and
PIL hidden.

Small widths: tiny backbone at 64² (32² in the CLI runs), E = A = H = 16,
B ≤ 8; 2-10 decodes 4 steps.  A trajectory's batches hold two images each
and pass a ReLU screen on the JAX side before any comparison: every ReLU
input of the trainable backbone blocks more than ``KINK_ATOL`` from zero
at every step.  Nearer zero the port's rounding may give it the other
sign; the two frameworks then take the loss's two one-sided derivatives,
and Adafactor's early, sign-like updates carry the difference into every
later step.  (At 8 images a batch the blocks hold 442,368 ReLU inputs and
nearly every step has one within 1e-5 of zero.)  The JAX side runs its plain XLA path
(``use_pallas=False``): its Pallas kernels have no VJP.  Tolerances: the
trajectories as ``tests/test_torch_train.py`` holds them (losses 1e-5
relative, BatchNorm statistics 1e-5, each parameter's movement cosine ≥
0.9999 and norms within 1e-3, float-noise elements to the noise step's
size); a forward 1e-4, as ``tests/test_torch_cross_attn.py``; the autograd
functions' gradients 1e-5 (atol + rtol) against ``jax.grad``.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _synthetic_batch, _synthetic_stfore_batch
from tests.test_torch_train import (
    _assert_same_trajectory,
    _dropout_off,
    _noise_mask,
    _torch_batch,
)
from visuelle2_tpu.cli import train_dl as jtrain_dl
from visuelle2_tpu.data.images import normalize_images
from visuelle2_tpu.models import VocabSizes as JVocab
from visuelle2_tpu.models import build as jbuild
from visuelle2_tpu.models import resnet as jresnet
from visuelle2_tpu.ops import attention as jattention
from visuelle2_tpu.ops import gru as jgru
from visuelle2_tpu.parallel.mesh import make_mesh
from visuelle2_tpu.train import hparams as jhparams
from visuelle2_tpu.train import loop as jloop
from visuelle2_tpu.train import optim as joptim
from visuelle2_tpu_torch.cli import forecast_dl, train_dl
from visuelle2_tpu_torch.convert import load_jax_variables, to_jax_variables
from visuelle2_tpu_torch.data.synthetic import make_synthetic_dataset
from visuelle2_tpu_torch.models import VocabSizes, build
from visuelle2_tpu_torch.models import cross_attn_rnn
from visuelle2_tpu_torch.ops import attention, dropout
from visuelle2_tpu_torch.ops.cuda import additive_attention as taa
from visuelle2_tpu_torch.ops.cuda import gru_seq
from visuelle2_tpu_torch.train import loop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
ATOL = 1e-4           # a whole forward, f32
GRAD_TOL = 1e-5       # an autograd function's gradients against jax.grad
DIMS = dict(attention_dim=16, embedding_dim=16, hidden_dim=16)
OUT_LEN = {"cross_attn_rnn_demand": 12, "cross_attn_rnn_210": 4, "cross_attn_rnn_21": 1}
SMALL = ["--device", "cpu", "--image_arch", "tiny", "--image_size", "32",
         "--embedding_dim", "16", "--attention_dim", "16", "--hidden_dim", "16",
         "--batch_size", "8"]
# A ReLU input this near zero may take the other sign in the other framework:
# there the loss has two one-sided derivatives, one in each.
KINK_ATOL = 1e-5
# The first batch seed of each trajectory (model, teacher-forcing ratio): the
# first from 100 up whose three steps pass the ReLU screen (``_relu_margin``),
# chosen before any comparison; ``PYTHONPATH=. python
# tests/test_torch_train_dl.py`` prints the screen's readings.
TRAJECTORY_SEEDS = {("cross_attn_rnn_demand", 1.0): 127, ("cross_attn_rnn_demand", 0.0): 102,
                    ("cross_attn_rnn_210", 1.0): 121, ("cross_attn_rnn_210", 0.0): 112,
                    ("cross_attn_rnn_21", None): 101}
SCREEN_CANDIDATES = 60
# (name, train_dl flags) of each model.
CLI_MODELS = {"cross_attn_rnn_demand": ["--demand", "1"],
              "cross_attn_rnn_21": ["--task_mode", "0", "--output_len", "1"],
              "cross_attn_rnn_210": ["--task_mode", "1", "--output_len", "4",
                                     "--use_teacher_forcing"]}


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one CPU thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_dropout(monkeypatch):
    with _dropout_off(monkeypatch):
        yield


def _kw(name, **extra):
    return dict(image_arch="tiny", out_len=OUT_LEN[name], **DIMS, **extra)


def _batch(name, n, seed):
    if name == "cross_attn_rnn_demand":
        return _synthetic_batch(n, 64, seed=seed)
    return _synthetic_stfore_batch(n // 2, 64, seed=seed, windows=2, horizon=OUT_LEN[name])


@functools.lru_cache(maxsize=None)
def _jax_variables(name):
    """One JAX init per model (the parameters do not depend on the teacher
    forcing options): an init runs a whole eager forward."""
    model = jbuild(name, vocab=JVocab(5, 6, 5, 126), **_kw(name))
    variables = model.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                           _batch(name, 4, 5), train=False)
    return jax.tree_util.tree_map(np.array, variables)


def _tf(name, ratio):
    """The teacher-forcing options of ``name`` at ``ratio`` (2-1 takes none)."""
    if ratio is None:
        return {}
    return dict(use_teacher_forcing=True, teacher_forcing_ratio=ratio)


def _port(name, variables, **extra):
    model = build(name, device="cpu", vocab=VocabSizes(5, 6, 5, 126), **_kw(name, **extra))
    return load_jax_variables(model, jax.tree_util.tree_map(np.array, variables))


# ------------------------------------------------------------- train steps
def _subtree(tree, key):
    """The first subtree under ``key`` in a nested dict (depth first)."""
    if key in tree:
        return tree[key]
    for v in tree.values():
        if isinstance(v, dict) and (found := _subtree(v, key)) is not None:
            return found
    return None


@functools.lru_cache(maxsize=None)
def _backbone_relu_inputs():
    """A jitted train-mode forward of the tiny JAX backbone alone that
    returns its blocks' BatchNorm and block outputs (the ReLU inputs depend
    on nothing else: train-mode BatchNorm reads no running statistics)."""
    backbone = jresnet.ResNetBackbone(jresnet.STAGE_BLOCKS["tiny"])

    @jax.jit
    def run(params, stats, images):
        _, state = backbone.apply(
            {"params": params, "batch_stats": stats}, normalize_images(images), train=True,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda m, _: isinstance(m, (jresnet.BatchNorm,
                                                              jresnet.Bottleneck)))
        return state["intermediates"]
    return run


def _relu_margin(params, stats, images):
    """The least |x| over the ReLU inputs of the trainable backbone blocks
    (bn1's and bn2's outputs, and bn3's plus the shortcut) in the JAX
    model's train forward of ``images`` at ``params``."""
    found = _backbone_relu_inputs()(_subtree(params, "backbone"),
                                    _subtree(stats, "backbone"), images)
    least, prev = np.inf, None
    order = sorted((k for k in found if k.startswith("layer")),
                   key=lambda k: tuple(int(n) for n in k[5:].split("_")))
    for name in order:
        block = {k: v["__call__"][0] for k, v in found[name].items() if k != "__call__"}
        if not name.startswith(joptim.FROZEN_BACKBONE_PREFIXES):
            sc = block["ds_bn"] if "ds_bn" in block else prev
            for x in (block["bn1"], block["bn2"], block["bn3"] + sc):
                least = min(least, float(jnp.min(jnp.abs(x))))
        prev = found[name]["__call__"][0]
    return least


def _trajectory_batch(name, seed):
    """A trajectory step's batch: two images (Demand rows, or 2-1/2-10
    products of two windows each)."""
    return _batch(name, 2 if name == "cross_attn_rnn_demand" else 4, seed)


def _jax_trajectory(name, ratio, seed):
    """Three unclipped steps of the JAX ``Trainer``'s step function (its
    loss, rng split and update), jitted here once to return the step's
    gradient too, on the batches from ``seed``: the initial variables, the
    final state, the losses, the gradients and, before each step, the ReLU
    screen's reading (``_relu_margin``)."""
    variables = _jax_variables(name)
    jm = jbuild(name, vocab=JVocab(5, 6, 5, 126), **_kw(name, **_tf(name, ratio)))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables.get("batch_stats", {}))
    tx = joptim.make_optimizer(params, None, LR)
    jstate = jloop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=stats, opt_state=tx.init(params), tx=tx)
    jtrainer = jloop.Trainer(jm, jloop.TrainConfig(learning_rate=LR),
                             mesh=make_mesh(data=1, model=1, devices=jax.devices()[:1]))

    @jax.jit
    def jax_step(state, batch, rng):  # jloop.Trainer._build_train_step's step_fn
        drop_rng, samp_rng = jax.random.split(jax.random.fold_in(rng, state.step))
        (loss, new_stats), grads = jax.value_and_grad(jtrainer._train_loss, has_aux=True)(
            state.params, state.batch_stats, batch, drop_rng, samp_rng)
        return state.apply_gradients(grads, new_stats), loss, grads

    losses, grads, margins = [], [], []
    for i in range(3):
        b = _trajectory_batch(name, seed + i)
        margins.append(_relu_margin(jstate.params, jstate.batch_stats, b["images"]))
        jstate, loss, g = jax_step(jstate, b, jax.random.key(1000))
        losses.append(float(loss))
        grads.append(g)
    return variables, jstate, losses, grads, margins


@pytest.mark.usefixtures("no_dropout")
@pytest.mark.parametrize("name,ratio", [
    ("cross_attn_rnn_demand", 1.0), ("cross_attn_rnn_demand", 0.0),
    ("cross_attn_rnn_210", 1.0), ("cross_attn_rnn_210", 0.0), ("cross_attn_rnn_21", None)])
def test_train_steps_match_jax_trainer(name, ratio):
    """Three unclipped steps from the same weights on the same batches: the
    JAX ``Trainer``'s step function against the port's
    ``Trainer.train_step``.  The batches pass the ReLU screen on the JAX
    side first (see ``TRAJECTORY_SEEDS``)."""
    seed = TRAJECTORY_SEEDS[name, ratio]
    variables, jstate, j_losses, j_grads, margins = _jax_trajectory(name, ratio, seed)
    assert min(margins) > KINK_ATOL, (
        f"the batches from seed {seed} put a ReLU input within {KINK_ATOL} of zero "
        f"({margins}); pick TRAJECTORY_SEEDS again: PYTHONPATH=. python {__file__}")
    trainer = loop.Trainer(_port(name, variables, **_tf(name, ratio)),
                           loop.TrainConfig(learning_rate=LR))
    state = trainer.init_state()
    p_losses = []
    for i in range(3):
        state, m = trainer.train_step(state, _torch_batch(_trajectory_batch(name, seed + i)))
        p_losses.append(float(m["loss"]))
    assert state.step == 3
    _assert_same_trajectory(variables, jstate, trainer.model, j_losses, p_losses,
                            _noise_mask(j_grads))


def test_weight_bridge_round_trips_a_trained_model():
    """Parameters and BatchNorm statistics moved by a train step come back
    through ``to_jax_variables`` -> ``load_jax_variables`` unchanged."""
    for name in OUT_LEN:
        model = build(name, device="cpu", vocab=VocabSizes(5, 6, 5, 126), **_kw(name),
                      generator=torch.Generator().manual_seed(3))
        trainer = loop.Trainer(model, loop.TrainConfig(learning_rate=LR))
        state = trainer.init_state()
        before = {k: v.clone() for k, v in model.state_dict().items()}
        trainer.train_step(state, _torch_batch(_batch(name, 4, 9)))
        after = model.state_dict()
        moved = [k for k in after if not torch.equal(before[k], after[k])]
        assert any("running_mean" in k for k in moved) and len(moved) > 20, name
        again = build(name, device="cpu", vocab=VocabSizes(5, 6, 5, 126), **_kw(name))
        load_jax_variables(again, to_jax_variables(model))
        for k, v in again.state_dict().items():
            assert torch.equal(v, after[k]), (name, k)


# ---------------------------------------------------------- the kernels
def _additive_inputs(seed, B=3, L=5, De=6, Dd=4, A=6, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(dtype) * 0.7
            for s in ((B, L, De), (B, Dd), (De, A), (Dd, A), (A, 1), (1,))]


@pytest.mark.parametrize("weight_on", ["inputs", "projected"])
def test_additive_attention_autograd_matches_jax_grad(weight_on):
    arrays = _additive_inputs(1)
    enc, dec, we, wd, v, vb = arrays
    cot_out, cot_alpha = (np.random.default_rng(2).normal(size=s).astype(np.float32)
                          for s in ((3, 5, 6), (3, 5)))
    module = jattention.AdditiveAttention(6, weight_on=weight_on)

    def loss(enc, dec, we, wd, v, vb):
        out, alpha = module.apply({"params": {
            "encoder_linear": {"kernel": we}, "decoder_linear": {"kernel": wd},
            "attn_linear": {"kernel": v, "bias": vb}}}, enc, dec)
        return jnp.sum(out * cot_out) + jnp.sum(alpha * cot_alpha), (out, alpha)

    (_, want_out), want = jax.value_and_grad(loss, argnums=tuple(range(6)), has_aux=True)(
        *(jnp.asarray(a) for a in arrays))
    t = [torch.from_numpy(a).requires_grad_() for a in arrays]
    before = taa.fused_additive_attention.launches
    out, alpha = taa.fused_additive_attention(*t, weight_on=weight_on)
    assert type(out.grad_fn).__name__ == "_AdditiveAttentionBackward"
    ((out * torch.from_numpy(cot_out)).sum()
     + (alpha * torch.from_numpy(cot_alpha)).sum()).backward()
    assert taa.fused_additive_attention.launches == before  # the CPU runs plain
    for got, w in zip((out, alpha), want_out):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w), atol=GRAD_TOL)
    for name, a, g in zip(("enc", "dec", "we", "wd", "v", "vb"), t, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("weight_on", ["inputs", "projected"])
def test_additive_attention_backward_gradcheck(weight_on):
    args = [torch.from_numpy(a).requires_grad_() for a in
            _additive_inputs(3, B=2, L=3, De=4, Dd=3, A=4, dtype=np.float64)]
    assert torch.autograd.gradcheck(
        lambda *a: taa._AdditiveAttention.apply(weight_on, *a), args)
    args[0].requires_grad_(False)  # a gradient asked of some inputs only
    assert torch.autograd.gradcheck(
        lambda *a: taa._AdditiveAttention.apply(weight_on, *a), args)


def _gru_inputs(seed, B=3, T=4, I=2, H=5, dtype=np.float32, h0=True):
    rng = np.random.default_rng(seed)
    shapes = [(B, T, I), (I, 3 * H), (H, 3 * H), (3 * H,), (3 * H,)] + ([(B, H)] if h0 else [])
    return [rng.normal(size=s).astype(dtype) * 0.5 for s in shapes]


def test_gru_sequence_autograd_matches_jax_grad():
    arrays = _gru_inputs(4)
    cot_outs, cot_h = (np.random.default_rng(5).normal(size=s).astype(np.float32)
                       for s in ((3, 4, 5), (3, 5)))
    module = jgru.GRU(5)

    def loss(x, w_i, w_h, b_i, b_h, h0):
        outs, h = module.apply({"params": dict(w_i=w_i, w_h=w_h, b_i=b_i, b_h=b_h)}, x, h0)
        return jnp.sum(outs * cot_outs) + jnp.sum(h * cot_h), (outs, h)

    (_, want_out), want = jax.value_and_grad(loss, argnums=tuple(range(6)), has_aux=True)(
        *(jnp.asarray(a) for a in arrays))
    t = [torch.from_numpy(a).requires_grad_() for a in arrays]
    before = gru_seq.fused_gru_sequence.launches
    outs, h = gru_seq.fused_gru_sequence(*t)
    assert type(outs.grad_fn).__name__ == "_GRUSequenceBackward"
    ((outs * torch.from_numpy(cot_outs)).sum() + (h * torch.from_numpy(cot_h)).sum()).backward()
    assert gru_seq.fused_gru_sequence.launches == before
    for got, w in zip((outs, h), want_out):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w), atol=GRAD_TOL)
    for name, a, g in zip(("x", "w_i", "w_h", "b_i", "b_h", "h0"), t, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("h0", [True, False])
def test_gru_sequence_backward_gradcheck(h0):
    args = [torch.from_numpy(a).requires_grad_() for a in
            _gru_inputs(6, B=2, T=3, I=2, H=3, dtype=np.float64, h0=h0)]
    args[0].requires_grad_(False)  # the trend series needs no gradient
    assert torch.autograd.gradcheck(lambda *a: gru_seq._GRUSequence.apply(*a), args)


def test_the_kernel_gru_path_trains_as_the_step_loop():
    """``GRU.use_kernel`` (the JAX ``use_pallas``) gives a Demand train
    step the step loop's loss and gradients."""
    batch = _torch_batch(_batch("cross_attn_rnn_demand", 4, 8))
    grads = []
    for use_kernel in (False, True):
        model = build("cross_attn_rnn_demand", device="cpu", vocab=VocabSizes(5, 6, 5, 126),
                      generator=torch.Generator().manual_seed(2),
                      **_kw("cross_attn_rnn_demand"))
        model.static.trend_encoder.gru.use_kernel = use_kernel
        trainer = loop.Trainer(model, loop.TrainConfig(learning_rate=LR))
        trainer.init_state()
        trainer._train_loss(batch, loop.step_generator(0, 0, "cpu")).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-6, atol=1e-7, msg=n)


# ------------------------------------------------ coins, dropout, remat
@pytest.mark.usefixtures("no_dropout")
def test_coins_are_drawn_once_a_step_shared_by_the_batch(monkeypatch):
    """At ratio 0.5: one draw of ``out_len`` coins a train forward, from the
    step's generator (the same coins for the same (seed, step)), and a
    forward that feeds the batch's whole series where a coin is true, as the
    JAX model does with the same coins."""
    name = "cross_attn_rnn_demand"
    variables = _jax_variables(name)
    model = _port(name, variables, **_tf(name, 0.5)).train()
    drawn = []
    original = cross_attn_rnn.teacher_coins

    def record(*args, **kwargs):
        drawn.append(original(*args, **kwargs))
        return drawn[-1]

    monkeypatch.setattr(cross_attn_rnn, "teacher_coins", record)
    batch = _batch(name, 6, 21)
    steps = {}
    for step in range(4):
        out, _ = model(_torch_batch(batch), generator=loop.step_generator(21, step, "cpu"))
        steps[step] = (out, drawn[-1])
    assert len(drawn) == 4 and all(c.shape == (12,) and c.dtype == torch.bool for c in drawn)
    again, _ = model(_torch_batch(batch), generator=loop.step_generator(21, 2, "cpu"))
    assert torch.equal(drawn[-1], steps[2][1]) and torch.equal(again, steps[2][0])
    assert len({tuple(c.tolist()) for _, c in steps.values()}) > 1
    coins = steps[2][1]
    assert 0 < int(coins.sum()) < 12  # both branches of the step
    jm = jbuild(name, vocab=JVocab(5, 6, 5, 126), **_kw(name, **_tf(name, 0.5)))
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(coins.numpy()))
    (want, _), _ = jm.apply(variables, batch, train=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.key(0),
                                  "sampling": jax.random.key(0)})
    np.testing.assert_allclose(steps[2][0].detach().numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("name", sorted(OUT_LEN))
def test_dropout_rate_at_every_site_matches_jax(name, monkeypatch):
    """Each dropout a train forward applies, as (rate, elements), in both
    frameworks: flax's ``Dropout`` and the JAX attention's probability
    dropout against the port's ``ops.dropout.dropout``."""
    import flax.linen as fnn

    variables = _jax_variables(name)  # its init's forward would record too
    jax_sites, port_sites = [], []

    def flax_dropout(self, inputs, deterministic=None, rng=None):
        jax_sites.append((self.rate, int(np.prod(inputs.shape))))
        return inputs

    dot = jattention._dot_attention

    def dot_attention(q, k, v, *, scale, mask=None, dropout_rate=0.0, deterministic=True,
                      dropout_rng=None):
        jax_sites.append((dropout_rate, q.shape[0] * q.shape[1] * q.shape[2] * k.shape[2]))
        return dot(q, k, v, scale=scale, mask=mask)

    monkeypatch.setattr(fnn.Dropout, "__call__", flax_dropout)
    monkeypatch.setattr(jattention, "_dot_attention", dot_attention)
    batch = _batch(name, 4, 3)
    jm = jbuild(name, vocab=JVocab(5, 6, 5, 126), **_kw(name))
    jm.apply(variables, batch, train=True, mutable=["batch_stats"],
             rngs={"dropout": jax.random.key(0), "sampling": jax.random.key(1)})

    def recording(x, rate, training):
        port_sites.append((rate, x.numel()))
        return x

    monkeypatch.setattr(dropout, "dropout", recording)
    monkeypatch.setattr(attention, "dropout", recording)
    model = _port(name, variables).train()
    model(_torch_batch(batch), generator=torch.Generator().manual_seed(0))
    assert sorted(port_sites) == sorted(jax_sites) and len(jax_sites) >= 5


def test_remat_reaches_the_backbone_with_the_same_gradients():
    """``train_dl --remat`` rebuilds every backbone block on backward
    (``torch.utils.checkpoint``) and changes no gradient or statistic."""
    args = train_dl.build_parser().parse_args(["--demand", "1", *SMALL])
    batch = _torch_batch(_batch("cross_attn_rnn_demand", 4, 7))
    grads, stats = [], []
    for remat in (False, True):
        args.remat = remat
        model = forecast_dl.make_model(args, VocabSizes(5, 6, 5, 126), 12, demand=True,
                                       device="cpu", generator=torch.Generator().manual_seed(4),
                                       training=True)
        assert model.static.image_encoder.backbone.remat is remat
        trainer = loop.Trainer(model, loop.TrainConfig())
        trainer.init_state()
        with dropout.disabled():
            trainer._train_loss(batch, None).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        stats.append({n: b.clone() for n, b in model.named_buffers()})
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) > 50
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-6, atol=1e-7, msg=n)
    for n in stats[0]:
        torch.testing.assert_close(stats[1][n], stats[0][n], rtol=0, atol=0, msg=n)


# ---------------------------------------------------------------- the CLIs
@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("vis2")), num_train=32,
                                  num_test=16, image_size=32, rows_per_image=2)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("name", sorted(CLI_MODELS))
def test_train_dl_writes_the_jax_manifest(name, dataset, tmp_path, monkeypatch):
    """One epoch of the port's ``train_dl``; its ``hparams.json`` equals
    what the JAX ``train_dl`` writes for the same flags (the JAX run is
    stopped once it has written it)."""
    argv = ["--dataset_path", dataset, *SMALL, *CLI_MODELS[name], "--epochs", "1",
            "--teacher_forcing_ratio", "0.25"]
    best = train_dl.main(argv + ["--ckpt_dir", str(tmp_path / "port")])
    assert best == str(tmp_path / "port" / "0")
    with open(tmp_path / "port" / "hparams.json") as f:
        port = json.load(f)
    written = []

    def save_hparams(ckpt_dir, hp):
        written.append(hp)
        raise _Stop

    monkeypatch.setattr(jhparams, "save_hparams", save_hparams)
    with pytest.raises(_Stop):
        jtrain_dl.run(jtrain_dl.build_parser().parse_args(
            [a for a in argv if a not in ("--device", "cpu")]
            + ["--ckpt_dir", str(tmp_path / "jax")]))
    assert port == json.loads(json.dumps(written[0])) and port["model"] == name


@pytest.mark.parametrize("flags,error,match", [
    # Ported: a backbone file that is not there is the error now.
    (["--pretrained_backbone", "x.npz"], FileNotFoundError, "x.npz"),
    # Ported: the grouped sampler trains an epoch on unique-image batches
    # (the id as when it raised).
    pytest.param(["--dedup_images", "1"], None, None,
                 id="flags1-NotImplementedError-item 11")])
def test_train_dl_flags_not_ported_yet_raise(dataset, tmp_path, flags, error, match):
    argv = ["--dataset_path", dataset, *SMALL, "--demand", "1", "--epochs", "1",
            "--ckpt_dir", str(tmp_path / "ck"), *flags]
    if error is None:
        best = train_dl.main(argv)
        assert best and os.path.isdir(best)
        lines = [json.loads(x) for x in (tmp_path / "ck" / "metrics.jsonl").read_text()
                 .splitlines()]
        losses = [x["train_loss"] for x in lines if "train_loss" in x]
        assert len(losses) == 1 and np.isfinite(losses[0])
        return
    with pytest.raises(error, match=match):
        train_dl.main(argv)


def test_forecast_dl_ckpt_path_fills_the_flags_and_checks_them(dataset, tmp_path, capsys):
    """A 2-10 checkpoint scored with no dim flags: the manifest gives the
    task, widths and horizon; a conflicting flag stops."""
    ck = str(tmp_path / "ck")
    train_dl.main(["--dataset_path", dataset, *SMALL, *CLI_MODELS["cross_attn_rnn_210"],
                   "--epochs", "1", "--ckpt_dir", ck])
    small = ["--dataset_path", dataset, "--device", "cpu", "--image_size", "32",
             "--batch_size", "8"]
    capsys.readouterr()
    r = forecast_dl.main(small + ["--ckpt_path", ck])
    filled = capsys.readouterr().out
    for flag in ("task_mode=1", "output_len=4", "attention_dim=16", "image_arch=tiny"):
        assert flag in filled
    with open(os.path.join(ck, "metrics.jsonl")) as f:
        (epoch0,) = [json.loads(line) for line in f]
    assert abs(r.wape - epoch0["val_wWAPE"]) <= 1e-5 * abs(epoch0["val_wWAPE"])
    with pytest.raises(SystemExit, match="hidden_dim=32 vs checkpoint hidden_dim=16"):
        forecast_dl.main(small + ["--ckpt_path", ck, "--hidden_dim", "32"])


def test_train_then_forecast_with_pandas_and_pil_hidden(tmp_path):
    """In a process where pandas and PIL cannot be imported: one epoch of
    ``train_dl --demand 1 --device cpu``, then ``forecast_dl --ckpt_path``
    with no dim flags reproduces the logged val_wWAPE."""
    code = (
        "import importlib.machinery as mach, json, sys\n"
        "class Hidden(mach.PathFinder):\n"
        "    @classmethod\n"
        "    def find_spec(cls, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('pandas', 'PIL'):\n"
        "            return None\n"
        "        return mach.PathFinder.find_spec(name, path, target)\n"
        "sys.meta_path = [Hidden if f is mach.PathFinder else f for f in sys.meta_path]\n"
        "for m in [m for m in sys.modules if m.split('.')[0] in ('pandas', 'PIL')]:\n"
        "    del sys.modules[m]\n"
        "import numpy as np\n"
        "from visuelle2_tpu_torch.cli import forecast_dl, train_dl\n"
        "from visuelle2_tpu_torch.data.images import ImageStore\n"
        "from visuelle2_tpu_torch.data.pipeline import load_visuelle2\n"
        "from visuelle2_tpu_torch.data.synthetic import make_synthetic_dataset\n"
        "d, ck = sys.argv[1], sys.argv[2]\n"
        "make_synthetic_dataset(d, num_train=32, num_test=12, image_size=32,\n"
        "                       write_images=False, rows_per_image=2)\n"
        "for split in ('train', 'test'):\n"
        "    paths = load_visuelle2(d, split, demand=True, output_len=12).image_paths\n"
        "    unique, row_to_img = ImageStore.unique_paths(paths)\n"
        "    px = np.random.default_rng(0).integers(0, 256, (len(unique), 32, 32, 3), np.uint8)\n"
        "    ImageStore(px, row_to_img).write_cache(ImageStore.cache_path(d, split, 32), paths)\n"
        "small = ['--dataset_path', d, '--device', 'cpu', '--image_size', '32',\n"
        "         '--batch_size', '8']\n"
        "dims = ['--demand', '1', '--image_arch', 'tiny', '--embedding_dim', '16',\n"
        "        '--attention_dim', '16', '--hidden_dim', '16', '--use_teacher_forcing']\n"
        "best = train_dl.main(small + dims + ['--epochs', '1', '--ckpt_dir', ck,\n"
        "                                     '--learning_rate', '1e-2'])\n"
        "r = forecast_dl.main(small + ['--ckpt_path', best])\n"
        "logged = [json.loads(l) for l in open(ck + '/metrics.jsonl')]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('pandas', 'PIL', 'jax'))\n"
        "print(json.dumps({'best': best, 'wape': r.wape, 'logged': logged, 'bad': bad}))\n")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    ck = str(tmp_path / "ck")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "d"), ck], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == [] and result["best"] == os.path.join(ck, "0")
    (epoch0,) = result["logged"]
    assert np.isfinite(epoch0["train_loss"]) and epoch0["lr"] == 1e-2
    assert abs(result["wape"] - epoch0["val_wWAPE"]) <= 1e-5 * abs(epoch0["val_wWAPE"])
    assert sorted(os.listdir(ck)) == ["0", "hparams.json", "last", "metrics.jsonl"]
    with open(os.path.join(ck, "hparams.json")) as f:
        manifest = json.load(f)
    assert manifest["model"] == "cross_attn_rnn_demand" and manifest["attention_dim"] == 16
    assert manifest["use_teacher_forcing"] == 1 and jhparams.load_hparams(ck) == manifest


def _screen_report():
    """Each trajectory's ReLU screen over candidate seeds from 100: the
    least |ReLU input| before each step, and the first seed that passes."""
    for (name, ratio) in TRAJECTORY_SEEDS:
        for seed in range(100, 100 + SCREEN_CANDIDATES):
            margins = _jax_trajectory(name, ratio, seed)[4]
            passed = min(margins) > KINK_ATOL
            print(name, ratio, seed, ["%.3g" % m for m in margins],
                  "passes" if passed else "", flush=True)
            if passed:
                break


if __name__ == "__main__":  # PYTHONPATH=. python tests/test_torch_train_dl.py
    with pytest.MonkeyPatch.context() as mp:
        with _dropout_off(mp):
            _screen_report()
