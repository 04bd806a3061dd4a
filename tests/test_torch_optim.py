"""The port's optimizer (``visuelle2_tpu_torch/train/optim.py``) against the
JAX package's (``visuelle2_tpu/train/optim.py``: optax's Adafactor behind
``clip_by_global_norm`` and the freeze split of ``multi_transform``).

Each test gives both the same parameters and gradients, each in its own
framework's layout (torch Linear ``[out, in]`` against flax ``[in, out]``,
OIHW against HWIO), and holds the port's updates within 1e-6 relative of
optax's: the same float32 arithmetic, summed in another order.
"""

import io

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
import optax
from visuelle2_tpu.models import VocabSizes as JVocab
from visuelle2_tpu.models import build as jbuild
from visuelle2_tpu.train import optim as joptim
from visuelle2_tpu_torch.convert import load_jax_variables
from visuelle2_tpu_torch.models import VocabSizes, build
from visuelle2_tpu_torch.train import optim

RTOL = 1e-6
STEPS = 5
# The gradients' joint norm at each step: above and below the 0.5 clip.
NORMS = (3.0, 0.2, 1.0, 0.05, 0.45)


def _jax_tree(rng):
    """flax-layout parameters: a factored [256, 192] kernel, a [192] vector, a
    [64, 64] kernel under the factoring limit, a factored HWIO conv kernel and
    a frozen backbone leaf."""
    return {
        "dense": {"kernel": rng.normal(size=(256, 192)).astype(np.float32) * 0.05},
        "vec": {"bias": rng.normal(size=(192,)).astype(np.float32) * 0.02},
        "small": {"kernel": rng.normal(size=(64, 64)).astype(np.float32) * 0.1},
        "conv": {"kernel": rng.normal(size=(3, 3, 128, 256)).astype(np.float32) * 0.03},
        "image_encoder": {"backbone": {"layer1_0": {"conv1": {
            "kernel": rng.normal(size=(1, 1, 8, 8)).astype(np.float32)}}}},
    }


def _to_port(name, leaf, a):
    """flax leaf -> the port's layout and parameter name."""
    if a.ndim == 4:
        return "weight", np.transpose(a, (3, 2, 0, 1))
    if name == "dense":
        return "weight", a.T
    return leaf, a


def _port_module(tree, prefix=""):
    mod = nn.Module()
    for key, value in tree.items():
        if isinstance(value, dict):
            mod.add_module(key, _port_module(value, f"{prefix}{key}."))
        else:
            name, a = _to_port(prefix.rstrip(".").split(".")[-1], key, value)
            mod.register_parameter(name, nn.Parameter(torch.from_numpy(np.array(a))))
    return mod


def _port_view_tensors(module, jtree, by_name, prefix=()):
    """``by_name`` (port parameter name -> array) in the flax tree's layout."""
    out = {}
    for key, value in jtree.items():
        if isinstance(value, dict):
            out[key] = _port_view_tensors(getattr(module, key), value, by_name,
                                          prefix + (key,))
        else:
            name, _ = _to_port(prefix[-1], key, value)
            a = by_name.get(".".join(prefix + (name,)))
            if a is not None:
                out[key] = (np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4
                            else a.T if prefix[-1] == "dense" else a)
    return out


def _grads(rng, jtree, norm):
    g = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), jtree)
    total = np.sqrt(sum(float((x ** 2).sum()) for x in jax.tree_util.tree_leaves(g)))
    return jax.tree_util.tree_map(lambda x: (x * (norm / total)).astype(np.float32), g)


@pytest.mark.parametrize("learning_rate", [None, 1e-2])
def test_adafactor_matches_optax(learning_rate):
    rng = np.random.default_rng(0)
    jtree = _jax_tree(rng)
    module = _port_module(jtree)
    assert optim.freeze_backbone(module) == ["image_encoder.backbone.layer1_0.conv1.weight"]
    opt = optim.Adafactor(module.parameters(), lr=learning_rate, grad_clip=0.5)
    tx = joptim.make_optimizer(jtree, grad_clip=0.5, learning_rate=learning_rate)
    jparams = jax.tree_util.tree_map(jnp.asarray, jtree)
    jstate = tx.init(jparams)
    frozen0 = module.image_encoder.backbone.layer1_0.conv1.weight.detach().clone()
    # The updates themselves: p ± u would round them to the parameters' ulp.
    captured = []
    compute = opt.compute_updates
    opt.compute_updates = lambda group, params: captured.append(
        dict(zip((id(p) for p in params), compute(group, params)))) or list(
        captured[-1].values())
    names = {id(p): n for n, p in module.named_parameters()}
    for step, norm in enumerate(NORMS):
        g = _grads(rng, jtree, norm)
        updates, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        gport = _port_view_grads(module, g)
        for name, p in module.named_parameters():
            p.grad = gport[name]
        opt.step()
        got = _port_view_tensors(module, jtree, {names[i]: -u.numpy() for i, u in
                                                 captured[-1].items()})
        for path, want in jax.tree_util.tree_leaves_with_path(updates):
            key = jax.tree_util.keystr(path)
            if "image_encoder" in key:  # frozen: set_to_zero, and the port skips it
                assert not np.asarray(want).any()
                continue
            np.testing.assert_allclose(_get(got, path), np.asarray(want), rtol=RTOL,
                                       atol=RTOL * float(np.abs(want).max()),
                                       err_msg=f"step {step} {key}")
    del opt.compute_updates
    assert torch.equal(module.image_encoder.backbone.layer1_0.conv1.weight, frozen0)
    assert opt.param_groups[0]["count"] == STEPS
    # The state dict round-trips (through torch.save, as a checkpoint holds
    # it): a fresh optimizer loaded from it takes the same next step.
    buffer = io.BytesIO()
    torch.save(opt.state_dict(), buffer)
    buffer.seek(0)
    state = torch.load(buffer, weights_only=True)
    clone = _port_module(jtree)
    clone.load_state_dict(module.state_dict())
    optim.freeze_backbone(clone)
    opt2 = optim.Adafactor(clone.parameters(), lr=learning_rate, grad_clip=0.5)
    opt2.load_state_dict(state)
    g = _port_view_grads(module, _grads(rng, jtree, 0.7))
    for m, o in ((module, opt), (clone, opt2)):
        for name, p in m.named_parameters():
            p.grad = g[name].clone()
        o.step()
    for (name, a), (_, b) in zip(module.named_parameters(), clone.named_parameters()):
        assert torch.equal(a, b), name


def _get(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _port_view_grads(module, g, prefix=()):
    """flax-layout gradients -> {port parameter name: tensor}."""
    out = {}
    for key, value in g.items():
        if isinstance(value, dict):
            out.update({f"{key}.{n}": t for n, t in
                        _port_view_grads(getattr(module, key), value, prefix + (key,)).items()})
        else:
            name, a = _to_port(prefix[-1], key, value)
            out[name] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def test_factored_dims_follow_optax():
    from optax._src.factorized import _factored_dims

    for shape in [(256, 192), (192, 256), (256, 256), (64, 64), (192,), (3, 3, 128, 256),
                  (256, 128, 3, 3), (1, 1, 2048, 32), (128, 128, 3, 3), (7, 7, 3, 64)]:
        assert optim.factored_dims(shape) == _factored_dims(shape, True, 128), shape


@pytest.mark.parametrize("step", [1, 10, 10_000])
def test_schedule_and_current_lr(step):
    want = float(joptim.fairseq_relative_step_schedule(jnp.asarray(step, jnp.int32)))
    assert float(optim.fairseq_relative_step_schedule(step)) == pytest.approx(want, rel=1e-7)
    for lr in (None, 1e-3):
        assert optim.current_lr(step, lr) == joptim.current_lr(step, lr)


@pytest.mark.parametrize("norm", [0.2, 3.0])
def test_global_norm_clip_matches_optax(norm):
    rng = np.random.default_rng(1)
    shapes = [(33, 7), (5,), (2, 3, 4)]
    g = [rng.normal(size=s).astype(np.float32) for s in shapes]
    total = np.sqrt(sum(float((x ** 2).sum()) for x in g))
    g = [(x * (norm / total)).astype(np.float32) for x in g]
    want, _ = optax.clip_by_global_norm(0.5).update([jnp.asarray(x) for x in g], None)
    got = optim.clip_by_global_norm([torch.from_numpy(x) for x in g], 0.5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=0)
    if norm < 0.5:  # below the clip the gradients pass unchanged
        assert all(np.array_equal(a.numpy(), x) for a, x in zip(got, g))


def test_freeze_split_matches_partition_trainable():
    kw = dict(output_len=12, image_arch="tiny", embedding_dim=16, hidden_dim=16)
    jm = jbuild("gated_v4", vocab=JVocab(5, 6, 5, 126), **kw)
    rng = np.random.default_rng(0)
    batch = {"ts": rng.random((2, 12)).astype(np.float32),
             "cat": np.zeros(2, np.int32), "col": np.zeros(2, np.int32),
             "fab": np.zeros(2, np.int32), "store": np.zeros(2, np.int32),
             "temporal": rng.random((2, 4)).astype(np.float32),
             "gtrends": rng.random((2, 3, 52)).astype(np.float32),
             "images": np.zeros((2, 32, 32, 3), np.uint8), "mask": np.ones(2, np.float32)}
    variables = jax.tree_util.tree_map(np.array, jm.init(jax.random.key(0), batch))
    labels = joptim.partition_trainable(variables["params"])
    frozen_modules = sorted({"/".join(str(k.key) for k in path[:-1]) for path, label in
                             jax.tree_util.tree_leaves_with_path(labels) if label == "freeze"})
    n_frozen = sum(label == "freeze" for label in jax.tree_util.tree_leaves(labels))
    model = load_jax_variables(build("gated_v4", device="cpu", vocab=VocabSizes(5, 6, 5, 126),
                                     **kw), variables)
    names = optim.freeze_backbone(model)
    assert len(names) == n_frozen > 0
    assert sorted({n.rsplit(".", 1)[0].replace(".", "/") for n in names}) == frozen_modules
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert not trainable & set(names) and len(trainable) + len(names) == len(
        list(model.parameters()))
