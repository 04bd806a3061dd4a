"""The reference against the port in float32 on the CPU at a tiny size: the
same forward in eval mode, and the same training steps (the dropout masks
and teacher-forcing coins drawn alike, Adafactor's update), so the
reference computes the configuration's mathematics and the bf16 backbone is
what the cells' limits see."""

import numpy as np
import pytest
import torch

from benchmark import core, data, program
from benchmark import weights as W
from benchmark.reference import model as ref
from benchmark.reference import train as ref_train

CONFIGS = ["gated_v4", "cross_attn_rnn_demand"]
TINY = {"image_arch": "tiny", "image_dtype": torch.float32}
SEED = 2 ** 31 + 101


def _setup(name, train=False):
    cfg = core.load_json(core.HERE / "configs" / f"{name}.json")
    model = program.build_model(cfg, "cpu", train=train, overrides=TINY)
    layout = W.layout_of(model)
    weights = W.draw(layout, SEED, cfg["init"], "cpu")
    W.load_into(model, weights)
    out_len = cfg["model"].get("output_len", cfg["model"].get("out_len"))
    products = data.make_products(24, 64, cfg["vocab"], SEED, "cpu", out_len)
    return cfg, model, weights, products


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_the_port_in_float32(name):
    cfg, model, weights, products = _setup(name)
    batch = data.rows(products, np.arange(16))
    with torch.no_grad():
        got, _ = model({k: torch.from_numpy(v) for k, v in batch.items()})
        want = ref.forward(weights, data.to_torch(batch, "cpu"),
                           program.reference_model(cfg, overrides=TINY), ref.Runtime())
    got = got.reshape(want.shape)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5 * want.abs().max()), \
        (got - want).abs().max()


def _train_both(name, count0, steps):
    """The port's ``Trainer`` and the reference over ``steps`` batches of 8
    from Adafactor's empty moments at update count ``count0``."""
    from benchmark.drivers import train as driver
    from visuelle2_tpu_torch.train.loop import TrainConfig, Trainer

    cfg, model, weights, products = _setup(name, train=True)
    seed = 12345
    trainer = Trainer(model, TrainConfig(seed=seed, grad_clip=cfg["train"]["grad_clip"]))
    state = trainer.init_state()
    for group in state.optimizer.param_groups:
        group["count"] = count0
    names = {p: n for n, p in model.named_parameters() if p.requires_grad}
    batches = [data.rows(products, np.arange(8 * i, 8 * i + 8)) for i in range(steps)]
    losses, grad_norms = [], None
    for b in batches:
        state, m = trainer.train_step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        if grad_norms is None:
            grad_norms = driver.grad_norms_from_state(state.optimizer, names, count0)
    want = ref_train.train_steps(weights, [data.to_torch(b, "cpu") for b in batches],
                                 program.reference_model(cfg, train=True, overrides=TINY),
                                 cfg["train"]["grad_clip"], seed, "f32", count0)
    after = {n: p.detach().clone() for p, n in names.items()}
    return want, weights, losses, grad_norms, after


@pytest.mark.parametrize("name", CONFIGS)
def test_train_steps_match_the_port_in_float32(name):
    want, weights, losses, _, after = _train_both(name, 0, 2)
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    # Leaves whose gradient is round-off (a key's bias under softmax) move
    # by Adafactor's normalised noise: left out, by the cells' rule.
    g_med = np.median(list(want["grad_norms"].values()))
    for k, v in want["params"].items():
        if want["grad_norms"][k] < 1e-3 * g_med:
            continue
        # At update 0 the rate is 1e-6: a leaf moves by a few ulps of
        # float32, whose rounding puts the two changes up to some
        # thousandths apart (3.5e-3 measured), not float32's epsilon.
        moved = (v - weights[k]).norm()
        assert (after[k] - v).norm() <= 5e-2 * moved + 1e-7, k


@pytest.mark.parametrize("name", CONFIGS)
def test_resumed_steps_match_the_port_in_float32(name):
    """Past warm-up (the training cells' ``resume_count``) every number the
    cells compare reads near nought in float32, and almost no element's
    change takes the other sign: what the cells read beyond this is the
    program's bfloat16."""
    from benchmark.drivers import train as driver

    r = driver.gaps(*_train_both(name, 10000, 3))
    assert r["loss_gap"] <= 1e-5, r
    assert r["grad_gap"] <= 5e-3, r
    assert r["update_median_gap"] <= 1e-3 and r["update_diff_gap"] <= 1e-3, r
    assert r["update_worst_gap"] <= 2e-3 and r["update_worst_leaf_sign_flips"] <= 0.01, r
