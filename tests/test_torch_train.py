"""Train mode and the train step of the port on the CPU, against the JAX
package: train-mode BatchNorm and BatchNorm1d, the gated residual's autograd
function (kernel forward, formula backward) against ``jax.grad`` of the JAX
XLA formula, the gated MHA's, and three train steps of ``Trainer`` against
the JAX ``Trainer`` from converted weights, dropout off on both sides.

Small widths (tiny backbone, E=H=16, 64² images, B=8).  Tolerances: a module
1e-5 (f32) or one bf16 ulp; the trajectories hold each step's loss within
1e-5 relative, the BatchNorm running statistics within 1e-5 (atol + rtol),
and each parameter's movement over the three steps to cosine ≥ 0.9999 and
norms within 1e-3, as ``tests/test_train_trajectory.py`` compares them
(per leaf).  Adafactor's first update is close to sign(g), so an element
whose true gradient is zero moves by a full step in a direction set by
rounding: a key bias (softmax ignores a shift of every score), a bias
feeding gtm's train-mode BatchNorm1d (which removes a shift), a channel of
the last bottleneck whose shift that BatchNorm1d cancels.  Such elements are
found by a rule on the JAX gradient, not by name: at some step their
gradient is at most 1e-8 of that step's global gradient norm.  They are held
to the noise step's size, and the cosine and norm cover every other element
of every leaf.  ``PYTHONPATH=. python tests/test_torch_train.py`` prints what
the rule rests on for three seeds of each model.
"""

import contextlib
import copy
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _synthetic_batch
from visuelle2_tpu.models import VocabSizes as JVocab
from visuelle2_tpu.models import build as jbuild
from visuelle2_tpu.models import fusion as jfusion
from visuelle2_tpu.models import norms as jnorms
from visuelle2_tpu.models import resnet as jresnet
from visuelle2_tpu.parallel.mesh import make_mesh
from visuelle2_tpu.train import loop as jloop
from visuelle2_tpu.train import optim as joptim
from visuelle2_tpu_torch.convert import load_jax_variables, to_jax_variables
from visuelle2_tpu_torch.models import VocabSizes, build
from visuelle2_tpu_torch.models import fusion, norms, resnet
from visuelle2_tpu_torch.ops import dropout
from visuelle2_tpu_torch.ops.cuda import gated_fusion, gated_mha
from visuelle2_tpu_torch.train import loop

ATOL = 1e-5
BF16_RTOL = 2.0 ** -7   # one bf16 ulp
LOSS_RTOL = 1e-5
STATS_TOL = 1e-5
COS_FLOOR, NORM_RTOL = 0.9999, 1e-3
NOISE_SHARE = 1e-8  # of a step's global gradient norm: float noise
LR = 1e-3
KW = dict(output_len=12, image_arch="tiny", embedding_dim=16, hidden_dim=16)


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one CPU thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def _dropout_off(monkeypatch):
    """Dropout off on both sides: the port's by ``ops.dropout.disabled()``,
    flax's and the JAX MHA's probability dropout as
    ``tests/test_train_trajectory.py`` turns them off."""
    import flax.linen as fnn

    from visuelle2_tpu.ops import attention as attention_mod

    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, deterministic=True, rng=None: inputs)
    orig_dot = attention_mod._dot_attention
    monkeypatch.setattr(
        attention_mod, "_dot_attention",
        lambda q, k, v, *, scale, mask=None, dropout_rate=0.0, deterministic=True,
        dropout_rng=None: orig_dot(q, k, v, scale=scale, mask=mask, dropout_rate=0.0,
                                   deterministic=True))
    with dropout.disabled():
        yield


@pytest.fixture
def no_dropout(monkeypatch):
    with _dropout_off(monkeypatch):
        yield


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------------ modules
def _bn_variables(rng, features):
    return {"params": {"scale": rng.normal(1.0, 0.2, features).astype(np.float32),
                       "bias": rng.normal(0.0, 0.2, features).astype(np.float32)},
            "batch_stats": {"mean": rng.normal(0.0, 0.5, features).astype(np.float32),
                            "var": rng.uniform(0.5, 2.0, features).astype(np.float32)}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_mode_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 5, 6, 8)) * 3 + 1).astype(np.float32)
    variables = _bn_variables(rng, 8)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    want, mutated = jresnet.BatchNorm(8, jdt).apply(
        variables, jnp.asarray(x).astype(jdt), use_running_average=False,
        mutable=["batch_stats"])
    bn = load_jax_variables(resnet.BatchNorm(8, tdt), variables).train()
    got = bn(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == tdt
    tol = dict(atol=ATOL, rtol=0) if dtype == "float32" else dict(atol=ATOL, rtol=BF16_RTOL)
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(mutated["batch_stats"][key]),
                                   atol=STATS_TOL, rtol=STATS_TOL)
    # Eval mode reads the moved statistics and moves nothing.
    before = bn.running_var.clone()
    bn.eval()(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2))
    assert torch.equal(bn.running_var, before)


def test_batchnorm1d_train_mode_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(6, 20)) * 2 - 1).astype(np.float32)
    variables = _bn_variables(rng, 20)
    want, mutated = jnorms.BatchNorm1d(20).apply(variables, jnp.asarray(x),
                                                 use_running_average=False,
                                                 mutable=["batch_stats"])
    bn = load_jax_variables(norms.BatchNorm1d(20), variables).train()
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mutated["batch_stats"]["mean"]), atol=STATS_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mutated["batch_stats"]["var"]), atol=STATS_TOL)


def test_float32_masters_give_the_eval_bits_of_bf16_weights():
    """The bf16 backbone's float32 masters, cast on each call, give the same
    forecast bits as weights stored in bf16 (the port before its masters)."""
    model = build("gated_v4", device="cpu", vocab=VocabSizes(5, 6, 5, 126),
                  image_dtype=torch.bfloat16, **KW)
    batch = _torch_batch(_synthetic_batch(4, 64, seed=3))
    with torch.inference_mode():
        masters = model(batch)[0]
        for mod in model.modules():
            if isinstance(mod, resnet.Conv2d):
                assert mod.weight.dtype == torch.float32
                mod.weight.data = mod.weight.data.to(torch.bfloat16)
                if mod.bias is not None:
                    mod.bias.data = mod.bias.data.to(torch.bfloat16)
        stored = model(batch)[0]
    assert torch.equal(masters, stored)


@pytest.mark.parametrize("residual", [True, False])
def test_gated_residual_autograd_matches_jax_grad(residual):
    rng = np.random.default_rng(2)
    B, D, C = 6, 8, 20
    x, ctx = (rng.normal(size=s).astype(np.float32) for s in ((B, D), (B, C)))
    kernel = (rng.normal(size=(C + D, D)) * 0.3).astype(np.float32)
    bias = rng.normal(size=D).astype(np.float32)
    cot = rng.normal(size=(B, D)).astype(np.float32)

    def loss(x, ctx, kernel, bias):
        out = jfusion._gated_residual(x, ctx, kernel, bias, residual=residual)
        return jnp.sum(out * cot), out

    (_, want_out), want = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (x, ctx, kernel, bias)))
    t = [torch.from_numpy(a).requires_grad_() for a in (x, ctx, kernel, bias)]
    before = gated_fusion.fused_gated_residual.launches
    out = fusion._gated_residual(*t, residual=residual)
    assert type(out.grad_fn).__name__ == "_GatedResidualBackward"
    (out * torch.from_numpy(cot)).sum().backward()
    # The CPU runs the plain version: no launch, forward or backward.
    assert gated_fusion.fused_gated_residual.launches == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=ATOL)
    for name, a, g in zip(("x", "ctx", "kernel", "bias"), t, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), atol=ATOL, rtol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("residual", [True, False])
def test_gated_residual_backward_gradcheck(residual):
    gen = torch.Generator().manual_seed(0)
    args = [torch.randn(s, dtype=torch.float64, generator=gen, requires_grad=True)
            for s in ((3, 4), (3, 5), (4, 4), (5, 4), (4,))]
    assert torch.autograd.gradcheck(
        lambda *a: gated_fusion._GatedResidual.apply(*a, residual), args)


@pytest.mark.parametrize("variant", ["head", "pure"])
def test_gated_mha_autograd_is_autograd_of_plain(variant):
    gen = torch.Generator().manual_seed(1)
    B, Lq, Lk, D, heads = 2, 3, 5, 8, 2
    G = D // heads if variant == "head" else D
    shapes = [(B, Lq, D), (B, Lk, D), (B, Lk, D), (Lq, Lk)] + [
        s for w in ((D, D),) * 3 + ((G, G), (D, D)) for s in (w, (w[1],))]
    args = [torch.randn(s, generator=gen) * 0.5 for s in shapes]
    for i, a in enumerate(args):
        a.requires_grad_(i != 3)  # the mask needs no gradient
    out = gated_mha.fused_gated_mha(*args, num_heads=heads, variant=variant)
    assert type(out.grad_fn).__name__ == "_GatedMHABackward"
    got = torch.autograd.grad(out.square().sum(), [a for a in args if a.requires_grad])
    plain = gated_mha.fused_gated_mha_plain(*args, num_heads=heads, variant=variant)
    want = torch.autograd.grad(plain.square().sum(), [a for a in args if a.requires_grad])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    f64 = [a.detach().double().requires_grad_(a.requires_grad) for a in args]
    assert torch.autograd.gradcheck(
        lambda *a: gated_mha._GatedMHA.apply(heads, variant, *a), f64)


# ------------------------------------------------------------- train steps
def _jax_state(model, variables, accum=False):
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    # A plain dict, as flax's init returns it (the accumulating step's scan
    # carries the statistics and wants the type the model gives back).
    stats = jax.tree_util.tree_map(jnp.asarray, variables.get("batch_stats", {}))
    tx = joptim.make_optimizer(params, 0.5, LR)
    state = jloop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             batch_stats=stats, opt_state=tx.init(params), tx=tx)
    trainer = jloop.Trainer(model, jloop.TrainConfig(grad_clip=0.5, learning_rate=LR),
                            mesh=make_mesh(data=1, model=1, devices=jax.devices()[:1]))
    return trainer, state


def _models(name, batch):
    jm = jbuild(name, vocab=JVocab(5, 6, 5, 126), **KW)
    variables = jax.tree_util.tree_map(np.array, jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, batch, train=False))
    pm = load_jax_variables(build(name, device="cpu", vocab=VocabSizes(5, 6, 5, 126), **KW),
                            variables)
    trainer = loop.Trainer(pm, loop.TrainConfig(grad_clip=0.5, learning_rate=LR))
    return jm, variables, trainer


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_grad_fn(jtrainer):
    """The JAX gradient of the train loss, as the JAX step computes it."""
    key = jax.random.key(0)
    return jax.jit(jax.grad(lambda params, stats, batch: jtrainer._train_loss(
        params, stats, batch, key, key)[0]))


def _noise_mask(jax_grads):
    """Per leaf, the elements whose JAX gradient at some step is float noise:
    below NOISE_SHARE of that step's global gradient norm."""
    flat = [_flat(g) for g in jax_grads]
    mask = {k: np.zeros(v.size, bool) for k, v in flat[0].items()}
    for g in flat:
        total = np.sqrt(sum(float(np.sum(np.square(v, dtype=np.float64))) for v in g.values()))
        for k, v in g.items():
            mask[k] |= np.abs(v).ravel() <= NOISE_SHARE * total
    return mask


def _assert_same_trajectory(init, j_state, port_model, j_losses, p_losses, noise):
    np.testing.assert_allclose(p_losses, j_losses, rtol=LOSS_RTOL,
                               err_msg="per-step losses diverged")
    port = to_jax_variables(port_model)
    js, ps = _flat(j_state.batch_stats), _flat(port.get("batch_stats", {}))
    assert set(js) == set(ps)
    for k in js:
        np.testing.assert_allclose(ps[k], js[k], atol=STATS_TOL, rtol=STATS_TOL, err_msg=k)
    f0, fj, fp = _flat(init["params"]), _flat(j_state.params), _flat(port["params"])
    assert set(f0) == set(fj) == set(fp) == set(noise)
    moved = 0
    for k in sorted(f0):
        dj, dp = (fj[k] - f0[k]).ravel(), (fp[k] - f0[k]).ravel()
        stage = re.search(r"\['backbone'\]\['([^']+)'\]", k)
        if stage and stage.group(1).startswith(joptim.FROZEN_BACKBONE_PREFIXES):
            assert not dj.any() and not dp.any(), f"frozen leaf moved: {k}"
            continue
        quiet = noise[k]
        if quiet.any():
            # Noise steps only: alpha = lr · max(rms(p), 1e-3) each, and an
            # update of RMS at most 1 over the leaf.
            bound = 3 * LR * max(1e-3, float(np.sqrt(np.mean(f0[k] ** 2)))) * np.sqrt(dj.size)
            nj, np_ = np.linalg.norm(dj[quiet]), np.linalg.norm(dp[quiet])
            assert nj <= 1.01 * bound and np_ <= 1.01 * bound, (k, nj, np_, bound)
            dj, dp = dj[~quiet], dp[~quiet]
        nj, np_ = np.linalg.norm(dj), np.linalg.norm(dp)
        if nj == 0.0 and np_ == 0.0:
            continue  # all noise, or e.g. a one-key attention's q/k: exactly zero
        cos = float(np.dot(dj, dp) / (nj * np_))
        assert cos >= COS_FLOOR, f"{k}: movement direction diverged (cos={cos:.6f})"
        assert abs(nj - np_) <= NORM_RTOL * nj, \
            f"{k}: movement norm diverged ({nj:.4e} vs {np_:.4e})"
        moved += 1
    assert moved > 20


def _three_steps(name, seed):
    """Three train steps of both Trainers on the batches of seeds
    ``seed .. seed + 2``; the JAX gradient of each step rides along."""
    batches = [_synthetic_batch(8, 64, seed=seed + i) for i in range(3)]
    jm, variables, trainer = _models(name, batches[0])
    jtrainer, jstate = _jax_state(jm, variables)
    state = trainer.init_state()
    j_losses, p_losses, j_grads, p_grads = [], [], [], []
    grad_fn = _jax_grad_fn(jtrainer)
    for b in batches:
        j_grads.append(grad_fn(jstate.params, jstate.batch_stats, b))
        jstate, m = jtrainer.train_step(jstate, b, jax.random.key(1000))
        j_losses.append(float(m["loss"]))
        state, m = trainer.train_step(state, _torch_batch(b))
        p_losses.append(float(m["loss"]))
        p_grads.append({n: p.grad.clone() for n, p in trainer.model.named_parameters()
                        if p.grad is not None})
    assert state.step == 3 and state.optimizer.param_groups[0]["count"] == 3
    return variables, jstate, trainer.model, j_losses, p_losses, j_grads, p_grads


@pytest.mark.usefixtures("no_dropout")
@pytest.mark.parametrize("name", ["gated_v4", "gtm", "gated_v2"])
def test_train_steps_match_jax_trainer(name):
    variables, jstate, model, j_losses, p_losses, j_grads, _ = _three_steps(name, 100)
    _assert_same_trajectory(variables, jstate, model, j_losses, p_losses,
                            _noise_mask(j_grads))


@pytest.mark.usefixtures("no_dropout")
def test_accumulated_step_matches_jax():
    batches = [_synthetic_batch(8, 64, seed=200 + i) for i in range(2)]
    jm, variables, trainer = _models("gated_v4", batches[0])
    jtrainer, jstate = _jax_state(jm, variables)
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    grad_fn = _jax_grad_fn(jtrainer)  # train-mode BatchNorm reads no running stats
    mean_grad = jax.tree_util.tree_map(
        lambda a, b: (a + b) / 2, *(grad_fn(jstate.params, jstate.batch_stats, b)
                                    for b in batches))
    jstate, m = jtrainer.accum_train_step(jstate, stacked, jax.random.key(1000))
    trainer.config.accum_steps = 2
    state, pm = trainer.accum_train_step(trainer.init_state(),
                                         [_torch_batch(b) for b in batches])
    assert state.step == 1
    _assert_same_trajectory(variables, jstate, trainer.model, [float(m["loss"])],
                            [float(pm["loss"])], _noise_mask([mean_grad]))


@pytest.mark.usefixtures("no_dropout")
def test_remat_gives_the_same_gradients_and_statistics():
    batch = _torch_batch(_synthetic_batch(8, 64, seed=7))
    grads, stats = [], []
    for remat in (False, True):
        model = build("gated_v4", device="cpu", vocab=VocabSizes(5, 6, 5, 126),
                      generator=torch.Generator().manual_seed(4), image_remat=remat, **KW)
        assert model.image_encoder.backbone.remat is remat
        trainer = loop.Trainer(model, loop.TrainConfig(grad_clip=0.5))
        trainer.init_state()
        trainer._train_loss(batch, None).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        stats.append({n: b.clone() for n, b in model.named_buffers()})
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) > 50
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-6, atol=1e-7, msg=n)
    for n in stats[0]:  # each BatchNorm moved its statistics once
        torch.testing.assert_close(stats[1][n], stats[0][n], rtol=0, atol=0, msg=n)


def test_masked_mse_matches_jax():
    rng = np.random.default_rng(5)
    target, pred = (rng.normal(size=(6, 12)).astype(np.float32) for _ in range(2))
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32)  # two padded rows
    want = jloop.mse_loss(jnp.asarray(target), jnp.asarray(pred), jnp.asarray(mask))
    got = loop.mse_loss(torch.from_numpy(target), torch.from_numpy(pred), torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(got), float(((target - pred) ** 2)[:4].mean()), rtol=1e-6)
    empty = loop.mse_loss(torch.from_numpy(target), torch.from_numpy(pred), torch.zeros(6))
    assert float(empty) == 0.0


def _noise_report(seeds=(100, 300, 500)):
    """Print, per model and seed, what the noise rule rests on: per step, the
    largest JAX gradient whose sign the port's differs from (a share of the
    step's global norm; at step 1 the parameters are the same on both
    sides), how many elements the rule sets aside, the worst cosine and norm
    difference over the elements kept, and each leaf whose movement cosine
    over all its elements is under COS_FLOOR."""
    def cos(a, b):
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        return float(a @ b / (na * nb)) if na and nb else float("nan")

    for name in ("gated_v4", "gtm", "gated_v2"):
        for seed in seeds:
            variables, jstate, model, *_, j_grads, p_grads = _three_steps(name, seed)
            flips = []
            for jg, pg in zip(j_grads, p_grads):
                jf = _flat(jg)
                grad_model = copy.deepcopy(model)
                for n, p in grad_model.named_parameters():
                    p.data = pg[n] if n in pg else torch.zeros_like(p)
                pf = _flat(to_jax_variables(grad_model)["params"])
                total = np.sqrt(sum(float(np.sum(np.square(v, dtype=np.float64)))
                                    for v in jf.values()))
                flips.append(max(float(np.abs(v)[np.sign(v) != np.sign(pf[k])].max(initial=0))
                                 for k, v in jf.items()) / total)
            mask = _noise_mask(j_grads)
            f0, fj = _flat(variables["params"]), _flat(jstate.params)
            fp = _flat(to_jax_variables(model)["params"])
            trainable = [k for k in f0 if (fj[k] - f0[k]).any() or (fp[k] - f0[k]).any()]
            low, kept_cos, kept_norm = [], 1.0, 0.0
            for k in sorted(trainable):
                dj, dp, keep = (fj[k] - f0[k]).ravel(), (fp[k] - f0[k]).ravel(), ~mask[k]
                nj, np_ = np.linalg.norm(dj[keep]), np.linalg.norm(dp[keep])
                if nj or np_:
                    kept_cos = min(kept_cos, cos(dj[keep], dp[keep]))
                    kept_norm = max(kept_norm, abs(nj - np_) / nj)
                if cos(dj, dp) < COS_FLOOR:
                    low.append(f"  {k}: {int(mask[k].sum())}/{mask[k].size} set aside; "
                               f"cos all {cos(dj, dp):.7f}, kept {cos(dj[keep], dp[keep]):.7f}")
            print(f"{name} seed {seed}: largest sign-differing |g| per step "
                  + ", ".join(f"{f:.2e}" for f in flips)
                  + " of the global norm; set aside "
                  f"{sum(int(mask[k].sum()) for k in trainable)} of "
                  f"{sum(mask[k].size for k in trainable)} elements; kept: min cos "
                  f"{kept_cos:.7f}, max norm diff {kept_norm:.2e}")
            print("\n".join(low))


if __name__ == "__main__":  # PYTHONPATH=. python tests/test_torch_train.py
    with pytest.MonkeyPatch.context() as mp:
        with _dropout_off(mp):
            _noise_report()
