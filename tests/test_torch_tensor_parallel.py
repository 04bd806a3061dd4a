"""Tensor parallelism of the port (``visuelle2_tpu_torch/parallel/sharding.py``
and the code that reads it) on the CPU: gloo ranks of a ``(data=2,
model=2)`` mesh against one process, against the JAX rule and against the
JAX ``Trainer`` over ``make_mesh(data=2, model=2)``.

* The sharded set: for every neural registry model at a tiny width (and
  the JAX dry run's gated_v4 and 2-10), at ``model`` 2 and 4 and
  ``min_shard_dim`` 8, 16 and 64, the port's ``infer_param_sharding``
  names the leaves the JAX ``infer_param_sharding`` shards on the JAX init
  variables (``jax.eval_shape``, over a JAX mesh of the conftest's virtual
  CPU devices), each port parameter mapped to its flax leaf through
  ``convert.py``'s bridge rules.
* Four ranks (``tests/torch_tensor_parallel_cases.py``) against one
  process: sharded Adafactor on the shapes that flip or lose factoring
  when halved, the clip active (updates and state within ``OPT_RTOL``);
  3-step trajectories of m4ft, cross_attn_rnn_210 (teacher forcing at 1)
  and gated_v4 at ``tp_min_dim`` 8, dropout off: losses within 1e-5, each
  step's whole gradient within ``GRAD_SHARE`` of its largest element plus
  ``GRAD_RTOL`` (``tests/test_torch_parallel.py``'s bounds), the trained
  parameters by the movement rule below and the BatchNorm statistics
  within 1e-5, the replicated parameters the same bits on the two
  model ranks of each data index, the one-pass ``score_split``; ``--remat``
  and ``accum_steps=2``; ``score_split`` over a dedup loader.
* The same trajectories of m4ft and 2-10 against the JAX ``Trainer`` on a
  ``(data=2, model=2)`` mesh from the port's initial weights: losses
  within 1e-5 relative, each parameter's movement by the cosine and norm
  rule of ``tests/test_torch_train.py`` (noise elements from the one
  process's gradients), BatchNorm statistics within 1e-5.
* Checkpoints: the ranks' checkpoint restored into a plain ``Trainer``
  (the gathered parameters and optimizer state bit for bit; the artifact
  the ranks exported through the gather the same bytes as the plain
  model's), and a plain
  checkpoint restored into a sharded one (bit for bit, and the next step's
  loss).
* The demo at its default ``--model_axis 2`` as four ranks against one
  process (``--model_axis 1``), and its JSON line against the JAX demo's
  (``scripts/demo_multihost.py``): the keys, the mesh, the eval sums' keys.
* The forecast CLIs' ``--export``, ``--dump_attention`` and ``--quantize
  w8a8`` under a two-rank launcher against one process: the artifacts and
  dumps the same bytes, WAPE and MAE within 1e-4.

Every process set is started once, together, by the ``spawned`` fixture;
each spawn has its own time limit, so a hang fails its test.
"""

import functools
import json
import os
import re
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from visuelle2_tpu.models import VocabSizes as JVocab
from visuelle2_tpu.models import build as jbuild
from visuelle2_tpu.ops.metrics import eval_metrics as jeval
from visuelle2_tpu.parallel.distributed import make_hybrid_mesh as jhybrid
from visuelle2_tpu.parallel.mesh import make_mesh as jmake_mesh
from visuelle2_tpu.parallel.sharding import infer_param_sharding as jinfer
from visuelle2_tpu.train import loop as jloop
from visuelle2_tpu.train import optim as joptim
from visuelle2_tpu_torch import convert
from visuelle2_tpu_torch.cli import export as export_cli
from visuelle2_tpu_torch.convert import to_jax_variables
from visuelle2_tpu_torch.data.synthetic import make_synthetic_dataset
from visuelle2_tpu_torch.eval import export
from visuelle2_tpu_torch.models import VocabSizes, build
from visuelle2_tpu_torch.parallel import sharding
from visuelle2_tpu_torch.train import loop
from visuelle2_tpu_torch.train.checkpoint import CheckpointManager
from visuelle2_tpu_torch.train.optim import is_frozen
from tests import torch_tensor_parallel_cases as cases_mod
from tests.test_torch_export import EVERY_MODEL
from tests.test_torch_parallel import REPO, _collect, _env, _free_port, _last_json, _start
from tests.test_torch_train import _dropout_off, _flat

CASES = os.path.join(REPO, "tests", "torch_tensor_parallel_cases.py")
VOCAB = (5, 6, 5, 126)
LOSS_ATOL, SUMS_RTOL = 1e-5, 2e-5
GRAD_SHARE, GRAD_RTOL = 1e-5, 1e-4
OPT_RTOL = 1e-6
JAX_LOSS_RTOL, COS_FLOOR, NORM_RTOL, NOISE_SHARE, STATS_TOL = 1e-5, 0.9999, 1e-3, 1e-8, 1e-5
METRIC_RTOL = 1e-4
# The JAX dry run's configurations (__graft_entry__.py): gated_v4 at E=32,
# H=64 at the default width, 2-10 at 16.
DRY_RUN = {
    "gated_v4@dry_run": ("gated_v4", dict(output_len=12, embedding_dim=32, hidden_dim=64,
                                          image_arch="tiny"), dict(demand=True, output_len=12),
                         64),
    "cross_attn_rnn_210@dry_run": ("cross_attn_rnn_210", dict(
        out_len=10, attention_dim=32, embedding_dim=32, hidden_dim=32, image_arch="tiny",
        use_teacher_forcing=True, teacher_forcing_ratio=0.5),
        dict(demand=False, output_len=10), 16),
}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -------------------------------------------------------------- the processes
@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    """Every process set, started together when the module's first test
    starts (the in-process tests run while they compute): the cases as four
    ranks and as one process, the demo as four ranks and one process, the
    forecast CLIs under a two-rank launcher and alone.  Returns the root and
    a function that collects a set (once) by name."""
    root = tmp_path_factory.mktemp("tensor_parallel")
    cases_ds = make_synthetic_dataset(str(root / "cases_ds"), num_train=0, num_test=24,
                                      image_size=32, rows_per_image=2)
    cli_ds = make_synthetic_dataset(str(root / "cli_ds"), num_train=0, num_test=24,
                                    image_size=32)
    sets = {"cases": _cases_cmds(root, cases_ds), "demo": _demo_cmds(),
            "cli": _cli_cmds(root, cli_ds)}
    procs = {k: _start(v) for k, v in sets.items()}
    done = {}

    def collect(name):
        if name not in done:
            done[name] = _collect(procs[name])
        return done[name]

    yield root, collect
    for name in procs:
        if name not in done:
            collect(name)


# ------------------------------------------------------------ the sharded set
def _model_mesh(model_axis):
    return types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(8 // model_axis, model_axis))


@functools.lru_cache(maxsize=None)
def _rule_models(key):
    """(port model, JAX init variables' shapes) of a registry model."""
    if key in DRY_RUN:
        name, kw, task, _ = DRY_RUN[key]
        kw = dict(kw, vocab=VocabSizes(*VOCAB))
    else:
        name, (kw, task) = key, EVERY_MODEL[key]
    port = build(name, device="cpu", **kw)
    jkw = {k: (JVocab(*VOCAB) if k == "vocab" else v) for k, v in kw.items()}
    jm = jbuild(name, **jkw)
    batch = export_cli.synth_batch(8, 32, VocabSizes(*VOCAB), seed=0, **task)
    key0 = jax.random.key(0)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": key0, "dropout": key0, "sampling": key0}, batch, train=False))
    return port, shapes


def _flax_path(model, name):
    """The flax leaf (``a/b/kernel``) that the bridge maps the port
    parameter ``name`` to."""
    mod_name, _, attr = name.rpartition(".")
    mod = model.get_submodule(mod_name)
    leaf = next(leaf for col, leaf, a, _ in convert._rules_for(mod) if a == attr)
    return "/".join(mod_name.split(".") + [leaf])


RULE_CASES = [(k, m, d) for k in sorted(EVERY_MODEL) for m in (2, 4) for d in (8, 16, 64)] + \
    [(k, m, DRY_RUN[k][3]) for k in DRY_RUN for m in (2, 4)]


@pytest.mark.parametrize("key,model_axis,min_dim", RULE_CASES,
                         ids=[f"{k}-m{m}-d{d}" for k, m, d in RULE_CASES])
def test_the_sharded_set_is_the_jax_rules(key, model_axis, min_dim):
    port, shapes = _rule_models(key)
    jmesh = jmake_mesh(data=8 // model_axis, model=model_axis)
    specs = jinfer(shapes["params"], jmesh, min_dim)
    want = {"/".join(str(k.key) for k in path)
            for path, s in jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda x: isinstance(x, NamedSharding))
            if "model" in tuple(s.spec)}
    dims = sharding.infer_param_sharding(port, _model_mesh(model_axis), min_dim)
    got = {_flax_path(port, n) for n, d in dims.items() if d is not None}
    assert got == want
    assert set(dims) == {n for n, _ in port.named_parameters()}
    if key == "cross_attn_rnn_210@dry_run":
        assert any("decoder" in n for n in got) and not any(
            n.endswith(("w_i", "w_h")) for n in got)


def test_the_sharded_dim_is_the_flax_trailing_one():
    """Linear and Conv2d weights split along torch dim 0, tables and the
    ``[in, out]`` kernels along their last dim."""
    port, _ = _rule_models("cross_attn_rnn_demand")
    dims = sharding.infer_param_sharding(port, _model_mesh(2), 8)
    kinds = {}
    for name, dim in dims.items():
        if dim is None:
            continue
        mod = port.get_submodule(name.rpartition(".")[0])
        kinds.setdefault(type(mod).__name__, set()).add(dim)
    assert kinds["Linear"] == {0} and kinds["Conv2d"] == {0}
    assert kinds["Embedding"] == {1} and kinds["_Weights"] == {1}


def _cases_cmds(root, dataset):
    port = _free_port()
    cmds = {}
    for r in range(4):
        os.makedirs(root / "four", exist_ok=True)
        cmds[f"rank{r}"] = ([sys.executable, CASES, "--out", str(root / "four"), "--dataset",
                             dataset, "--coordinator", f"127.0.0.1:{port}", "--world", "4",
                             "--rank", str(r)], _env())
    os.makedirs(root / "one", exist_ok=True)
    cmds["one"] = ([sys.executable, CASES, "--out", str(root / "one"), "--dataset", dataset],
                   _env())
    return cmds


def _demo_cmds():
    port = _free_port()
    base = [sys.executable, "-m", "visuelle2_tpu_torch.parallel.demo_multihost",
            "--device", "cpu"]
    cmds = {f"rank{r}": (base + ["--coordinator", f"127.0.0.1:{port}", "--num_processes",
                                 "4", "--process_id", str(r), "--backend", "gloo"], _env())
            for r in range(4)}
    cmds["one"] = (base + ["--model_axis", "1"], _env())
    return cmds


CLI_RUNS = {  # name: (module, flags)
    "dl": ("visuelle2_tpu_torch.cli.forecast_dl",
           ["--new_product", "1", "--attention_dim", "16"]),
    "w8a8": ("visuelle2_tpu_torch.cli.forecast_transformer",
             ["--model", "gated_v4", "--quantize", "w8a8", "--calib_batches", "2"]),
}


def _cli_cmds(root, dataset):
    cmds = {}
    for name, (module, flags) in CLI_RUNS.items():
        port = str(_free_port())
        launcher = dict(WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                        LOCAL_WORLD_SIZE="2")
        for who in ("rank0", "rank1", "one"):
            out = root / f"cli_{name}_{who}"
            os.makedirs(out, exist_ok=True)
            argv = [sys.executable, "-m", module, "--dataset_path", dataset, "--device", "cpu",
                    "--image_arch", "tiny", "--image_size", "32", "--embedding_dim", "16",
                    "--hidden_dim", "16", "--batch_size", "8", "--metrics_out",
                    str(out / "metrics.json"), "--export", str(out / "a.v2torch"),
                    "--dump_attention", str(out / "attention.npz")] + flags
            env = _env() if who == "one" else _env(RANK=who[-1], LOCAL_RANK=who[-1],
                                                   **launcher)
            cmds[f"{name}_{who}"] = (argv, env)
    return cmds


def _assert_same_movement(init, want, got, noise, frozen, steps=cases_mod.STEPS):
    """Each parameter's movement from ``init`` to ``got`` against ``want``
    (flat dicts of arrays): frozen ones unmoved, noise elements within the
    noise steps' size, the rest by cosine and norm
    (``tests/test_torch_train.py``'s rule)."""
    assert set(init) == set(want) == set(got)
    moved = 0
    for k in sorted(init):
        dw, dg = (want[k] - init[k]).ravel(), (got[k] - init[k]).ravel()
        if frozen(k):
            assert not dw.any() and not dg.any(), f"frozen leaf moved: {k}"
            continue
        quiet = noise[k]
        if quiet.any():
            bound = steps * cases_mod.LR * max(
                1e-3, float(np.sqrt(np.mean(init[k] ** 2)))) * np.sqrt(dw.size)
            nw, ng = np.linalg.norm(dw[quiet]), np.linalg.norm(dg[quiet])
            assert nw <= 1.01 * bound and ng <= 1.01 * bound, (k, nw, ng, bound)
            dw, dg = dw[~quiet], dg[~quiet]
        nw, ng = np.linalg.norm(dw), np.linalg.norm(dg)
        if nw == 0.0 and ng == 0.0:
            continue
        cos = float(np.dot(dw, dg) / (nw * ng))
        assert cos >= COS_FLOOR, f"{k}: movement direction diverged (cos={cos:.6f})"
        assert abs(nw - ng) <= NORM_RTOL * nw, f"{k}: movement norm ({nw:.4e} vs {ng:.4e})"
        moved += 1
    assert moved > 10


def _noise(arrays, name, to_key=lambda grads: grads):
    """Per parameter, the elements whose gradient in the one process is
    float noise at some step: below ``NOISE_SHARE`` of that step's global
    norm (``to_key`` maps a step's gradients to the compared names)."""
    noise = {}
    for i in range(cases_mod.STEPS):
        g = {k[len(f"{name}_{i}_grad/"):]: v for k, v in arrays["one"].items()
             if k.startswith(f"{name}_{i}_grad/")}
        total = np.sqrt(sum(float(np.sum(np.square(v, dtype=np.float64))) for v in g.values()))
        for k, v in to_key(g).items():
            quiet = np.abs(v).ravel() <= NOISE_SHARE * total
            noise[k] = quiet if k not in noise else noise[k] | quiet
    return noise


# ------------------------------------------------------- against the JAX Trainer
def _jax_tp_trajectory(name, init):
    """The JAX ``Trainer`` on a (data=2, model=2) mesh of the virtual CPU
    devices, from ``init`` (flax variables), dropout off: the cases'
    ``STEPS`` steps on their global batches."""
    kw, kind = cases_mod.MODELS[name]
    jm = jbuild(name, vocab=JVocab(*VOCAB), **kw)
    mesh = jmake_mesh(data=2, model=2, devices=jax.devices()[:4])
    trainer = jloop.Trainer(jm, jloop.TrainConfig(grad_clip=0.5, learning_rate=cases_mod.LR,
                                                  tp_min_dim=cases_mod.TP_MIN_DIM), mesh=mesh)
    rep = NamedSharding(mesh, P())
    params = jax.tree_util.tree_map(jnp.asarray, init["params"])
    params = jax.device_put(params, jinfer(params, mesh, cases_mod.TP_MIN_DIM))
    assert any("model" in tuple(x.sharding.spec) for x in jax.tree_util.tree_leaves(params))
    stats = jax.device_put(jax.tree_util.tree_map(jnp.asarray, init.get("batch_stats", {})),
                           rep)
    tx = joptim.make_optimizer(params, 0.5, cases_mod.LR)
    state = jloop.TrainState(step=jax.device_put(jnp.zeros((), jnp.int32), rep),
                             params=params, batch_stats=stats,
                             opt_state=jax.jit(tx.init)(params), tx=tx)
    losses = []
    for i in range(cases_mod.STEPS):
        state, m = trainer.train_step(state, cases_mod.global_batch(kind, 10 + i),
                                      jax.random.key(1000))
        losses.append(float(m["loss"]))
    return losses, jax.device_get(state)


@pytest.mark.parametrize("name", ["m4ft", "cross_attn_rnn_210"])
def test_four_ranks_match_the_jax_trainer(request, name, monkeypatch):
    kw, _ = cases_mod.MODELS[name]
    model = build(name, device="cpu", generator=torch.Generator().manual_seed(3),
                  vocab=VocabSizes(*VOCAB), **kw)
    init = jax.tree_util.tree_map(np.array, to_jax_variables(model))
    with _dropout_off(monkeypatch):
        j_losses, j_state = _jax_tp_trajectory(name, init)
    arrays, _, _ = request.getfixturevalue("cases")  # the ranks ran meanwhile
    np.testing.assert_allclose(arrays["rank0"][f"{name}_losses"], j_losses, rtol=JAX_LOSS_RTOL)
    # The ranks' trained model, in the flax layout.
    prefix = f"{name}_state/"
    model.load_state_dict({k[len(prefix):]: torch.from_numpy(v)
                           for k, v in arrays["rank0"].items() if k.startswith(prefix)})
    trained = jax.tree_util.tree_map(np.array, to_jax_variables(model))  # a copy
    js, ps = _flat(j_state.batch_stats), _flat(trained.get("batch_stats", {}))
    assert set(js) == set(ps)
    for k in js:
        np.testing.assert_allclose(ps[k], js[k], atol=STATS_TOL, rtol=STATS_TOL, err_msg=k)
    # Noise elements from the one process's gradients, in the flax layout.
    def to_flax(grads):
        model.load_state_dict({n: torch.from_numpy(grads.get(n, np.zeros(p.shape, np.float32)))
                               for n, p in model.named_parameters()}, strict=False)
        return _flat(to_jax_variables(model)["params"])

    def frozen(k):
        stage = re.search(r"\['backbone'\]\['([^']+)'\]", k)
        return bool(stage and stage.group(1).startswith(joptim.FROZEN_BACKBONE_PREFIXES))

    _assert_same_movement(_flat(init["params"]), _flat(j_state.params),
                          _flat(trained["params"]), _noise(arrays, name, to_flax), frozen)


@pytest.fixture(scope="module")
def cases(spawned):
    root, collect = spawned
    outs = collect("cases")
    arrays = {f"rank{r}": dict(np.load(root / "four" / f"rank{r}.npz")) for r in range(4)}
    arrays["one"] = dict(np.load(root / "one" / "rank0.npz"))
    return arrays, {k: _last_json(v) for k, v in outs.items()}, root


def _same_on_ranks(arrays, key):
    """``key`` as every rank holds it (the same bits on all four)."""
    for r in (1, 2, 3):
        np.testing.assert_array_equal(arrays[f"rank{r}"][key], arrays["rank0"][key],
                                      err_msg=key)
    return arrays["rank0"][key], arrays["one"][key]


def test_the_ranks_sit_on_a_data_by_model_mesh(cases):
    _, summaries, _ = cases
    assert [summaries[f"rank{r}"]["batch_rank"] for r in range(4)] == \
        [[0, 2], [0, 2], [1, 2], [1, 2]]
    assert [summaries[f"rank{r}"]["model_rank"] for r in range(4)] == \
        [[0, 2], [1, 2], [0, 2], [1, 2]]
    for name, n in summaries["rank0"]["sharded"].items():
        assert n > 0, name
    # Sharded parameters and their state halved: a rank holds well under
    # the whole model's bytes.
    assert summaries["rank0"]["resident_bytes"] < 0.6 * summaries["one"]["resident_bytes"]


def test_sharded_adafactor_matches_the_whole_one(cases):
    arrays, _, _ = cases
    assert sorted(arrays["rank0"]["adafactor_sharded"].tolist()) == [0, 0, 0, 1, 1]
    keys = [k for k in arrays["one"] if k.startswith("adafactor_")]
    assert len(keys) > 20
    for k in keys:
        got, want = _same_on_ranks(arrays, k)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=OPT_RTOL, atol=OPT_RTOL * scale,
                                   err_msg=k)
    # The clip was active: the first step's update is sign-like at the rate.
    assert any(k.startswith("adafactor_state/a.weight/v_row") for k in keys)


def _assert_same_step(arrays, prefix):
    keys = [k for k in arrays["one"] if k.startswith(f"{prefix}_grad/")]
    assert len(keys) > 10 and set(keys) == {k for k in arrays["rank0"]
                                            if k.startswith(f"{prefix}_grad/")}
    largest = max(np.abs(arrays["one"][k]).max() for k in keys)
    for k in keys:
        got, want = _same_on_ranks(arrays, k)
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_SHARE * largest,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["m4ft", "cross_attn_rnn_210", "gated_v4"])
def test_four_ranks_match_one_process(cases, name):
    arrays, _, _ = cases
    got, want = _same_on_ranks(arrays, f"{name}_losses")
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)
    for i in range(cases_mod.STEPS):
        _assert_same_step(arrays, f"{name}_{i}")
    prefix = f"{name}_state/"
    keys = [k for k in arrays["one"] if k.startswith(prefix)]
    assert keys and set(keys) == {k for k in arrays["rank0"] if k.startswith(prefix)}
    kw, _ = cases_mod.MODELS[name]
    model = build(name, device="cpu", generator=torch.Generator().manual_seed(3),
                  vocab=VocabSizes(*VOCAB), **kw)
    params = {n for n, _ in model.named_parameters()}
    got, want = {}, {}
    for k in keys:
        got[k[len(prefix):]], want[k[len(prefix):]] = _same_on_ranks(arrays, k)
    for k in set(got) - params:  # the BatchNorm statistics
        np.testing.assert_allclose(got[k], want[k], rtol=STATS_TOL, atol=STATS_TOL, err_msg=k)
    init = {n: p.detach().numpy() for n, p in model.named_parameters()}
    _assert_same_movement(init, {k: want[k] for k in params}, {k: got[k] for k in params},
                          _noise(arrays, name), is_frozen)
    got, want = _same_on_ranks(arrays, f"{name}_score")
    assert got[2] == want[2]
    np.testing.assert_allclose(got[:2], want[:2], rtol=SUMS_RTOL)


@pytest.mark.parametrize("name", ["m4ft", "cross_attn_rnn_210", "gated_v4", "accum"])
def test_replicated_parameters_are_the_same_bits_on_the_model_ranks(cases, name):
    arrays, _, _ = cases
    keys = [k for k in arrays["rank0"] if k.startswith(f"{name}_replicated/")]
    assert len(keys) > 5
    for k in keys:
        for a, b in (("rank0", "rank1"), ("rank2", "rank3"), ("rank0", "rank2")):
            np.testing.assert_array_equal(arrays[a][k], arrays[b][k], err_msg=f"{k} {a} {b}")


@pytest.mark.parametrize("rule", ["rule_on", "rule_off"])
def test_the_sync_rule_keeps_replicas_equal_against_a_nondeterministic_kernel(cases, rule):
    # Model rank 1 moves its replicated gradients and buffers an ulp before
    # each sync: with the rule the replicas keep rank 0's bits; without it
    # (the control) they come apart, so the bit check can fail.
    arrays, _, _ = cases
    keys = [k for k in arrays["rank0"] if k.startswith(f"{rule}/")]
    assert len(keys) > 5
    for a, b in (("rank0", "rank1"), ("rank2", "rank3")):
        same = [np.array_equal(arrays[a][k], arrays[b][k]) for k in keys]
        if rule == "rule_on":
            assert all(same), [k for k, ok in zip(keys, same) if not ok]
        else:
            assert not all(same)


@pytest.mark.parametrize("prefix", ["remat", "accum"])
def test_remat_and_accumulation(cases, prefix):
    arrays, _, _ = cases
    got, want = _same_on_ranks(arrays, f"{prefix}_loss")
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)
    _assert_same_step(arrays, prefix)


def test_score_split_over_the_mesh(cases):
    arrays, _, _ = cases
    (wape, mae, rows), (wape1, mae1, rows1) = _same_on_ranks(arrays, "score")
    assert rows == rows1 == 24
    np.testing.assert_allclose([wape, mae], [wape1, mae1], rtol=SUMS_RTOL)


# ---------------------------------------------------------------- checkpoints
def test_a_tensor_parallel_checkpoint_restores_into_a_plain_trainer(cases):
    arrays, _, root = cases
    kw, _ = cases_mod.MODELS["gated_v4"]
    trainer = loop.Trainer(build("gated_v4", device="cpu", vocab=VocabSizes(*VOCAB), **kw),
                           loop.TrainConfig(grad_clip=0.5, learning_rate=cases_mod.LR))
    state, epoch, skip = CheckpointManager(str(root / "four" / "ck_tp"),
                                           read_only=True).restore_latest(trainer.init_state())
    assert (epoch, skip, state.step) == (1, 0, cases_mod.STEPS)
    for k, v in trainer.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), arrays["rank0"][f"gated_v4_state/{k}"],
                                      err_msg=k)
    # The artifact exported through the gather is the plain model's.
    path = str(root / "plain_export.v2torch")
    export.export_forecaster(trainer.model, cases_mod.global_batch("demand", 50), path)
    with open(path, "rb") as a, open(root / "four" / "tp_export.v2torch", "rb") as b:
        assert a.read() == b.read(), "the artifacts differ"
    opt = state.optimizer.state_dict()["state"]
    saved = {k[len("tp_saved_opt/"):]: v for k, v in arrays["rank0"].items()
             if k.startswith("tp_saved_opt/")}
    assert saved and set(saved) == {f"{i}/{k}" for i, st in opt.items() for k in st}
    for key, v in saved.items():
        i, k = key.split("/")
        np.testing.assert_array_equal(opt[int(i)][k].numpy(), v, err_msg=key)


def test_a_plain_checkpoint_restores_into_a_tensor_parallel_trainer(cases):
    arrays, _, _ = cases
    for r in range(4):
        a = arrays[f"rank{r}"]
        assert a["plain_to_tp_same_model"] and a["plain_to_tp_same_optimizer"]
        tp_loss, plain_loss = a["plain_to_tp_losses"]
        np.testing.assert_allclose(tp_loss, plain_loss, rtol=0, atol=LOSS_ATOL)


def test_fit_autosaves_at_an_agreed_step_under_a_model_axis(cases):
    _, summaries, _ = cases
    histories = [summaries[f"rank{r}"]["fit_history"] for r in range(4)]
    assert all(h == histories[0] for h in histories)
    assert histories[0][-1]["epoch"] == 0 and "val_wWAPE" in histories[0][-1]
    np.testing.assert_allclose(histories[0][-1]["train_loss"],
                               summaries["one"]["fit_history"][-1]["train_loss"], rtol=1e-5)
    # Rank 0's deadline (due after step 1) rides in step 2's flags, read two
    # steps later: one autosave after step 4, then the epoch's save.
    assert summaries["rank0"]["fit_saves"] == [["save_preempted", 0, 4], ["save", 0]]
    assert all(summaries[f"rank{r}"]["fit_saves"] is None for r in (1, 2, 3))


# -------------------------------------------------------------------- the demo
def test_the_demo_at_its_default_model_axis(spawned):
    _, collect = spawned
    r = {k: _last_json(v) for k, v in collect("demo").items()}
    assert all(r[f"rank{i}"]["mesh"] == {"dcn": 1, "data": 2, "model": 2} for i in range(4))
    assert r["one"]["mesh"] == {"dcn": 1, "data": 1, "model": 1}
    assert all(r[f"rank{i}"]["losses"] == r["rank0"]["losses"] for i in range(4))
    assert all(r[f"rank{i}"]["eval_sums"] == r["rank0"]["eval_sums"] for i in range(4))
    np.testing.assert_allclose(r["rank0"]["losses"], r["one"]["losses"], rtol=0,
                               atol=LOSS_ATOL)
    for k, v in r["one"]["eval_sums"].items():
        np.testing.assert_allclose(r["rank0"]["eval_sums"][k], v, rtol=SUMS_RTOL, err_msg=k)
    # The JAX demo's line at its defaults (scripts/demo_multihost.py: one
    # process of four devices, --model_axis 2, --steps 2; its weights and
    # dropout are JAX's own, so its numbers are not the port's): its keys,
    # its mesh (the JAX make_hybrid_mesh over four devices), its eval sums'
    # keys (the JAX eval_metrics), as many losses.
    jmesh = dict(jhybrid(model=2, devices=jax.devices()[:4]).shape)
    jsums = jeval(np.ones((2, 12), np.float32), np.zeros((2, 12), np.float32))
    for line in r.values():
        assert set(line) == {"process", "processes", "mesh", "losses", "eval_sums"}
        assert set(line["eval_sums"]) == set(jsums)
        assert len(line["losses"]) == 2
    assert r["rank0"]["mesh"] == jmesh


def test_the_demo_refuses_a_model_axis_without_ranks():
    from visuelle2_tpu_torch.parallel import demo_multihost

    with pytest.raises(ValueError, match="one process holds one device"):
        demo_multihost.run(demo_multihost.build_parser().parse_args(["--device", "cpu"]))


# ---------------------------------------------------------------- the CLIs
@pytest.mark.parametrize("name", sorted(CLI_RUNS))
def test_forecast_options_under_a_launcher_are_one_process_s(spawned, name):
    root, collect = spawned
    outs = collect("cli")
    assert "WAPE" in outs[f"{name}_rank0"] and "WAPE" not in outs[f"{name}_rank1"]
    for f in ("metrics.json", "a.v2torch", "attention.npz"):
        assert not os.path.exists(root / f"cli_{name}_rank1" / f)
    one, two = root / f"cli_{name}_one", root / f"cli_{name}_rank0"
    with open(one / "a.v2torch", "rb") as a, open(two / "a.v2torch", "rb") as b:
        assert a.read() == b.read(), "the artifacts differ"
    if name == "dl":
        with open(one / "attention.npz", "rb") as a, open(two / "attention.npz", "rb") as b:
            assert a.read() == b.read(), "the attention dumps differ"
        assert sorted(np.load(one / "attention.npz")) == ["img", "multimodal", "trend"]
    else:
        assert "[w8a8] int8 backbone" in outs[f"{name}_rank0"]
    m1, m2 = (json.load(open(d / "metrics.json")) for d in (one, two))
    assert m1["num_forecasts"] == m2["num_forecasts"] == 24
    np.testing.assert_allclose([m2["wape"], m2["mae"]], [m1["wape"], m1["mae"]],
                               rtol=METRIC_RTOL)
