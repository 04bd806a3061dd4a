"""Data parallelism of the port (``visuelle2_tpu_torch/parallel/``) on the
CPU: real processes joined over gloo, each feeding only its row block of
the global batch, against one process on the same global batch and against
the JAX ``Trainer``.

* ``parallel.demo_multihost`` (``--model_axis 1``: data parallel) as two
  ranks and as one process (dropout on):
  the ranks' losses and eval sums equal; against one process within atol
  1e-5 (losses) and rtol 2e-5 (eval sums), half and a fifth of the JAX
  demo test's 2e-5 and 1e-4 (``tests/test_multiprocess.py``); the port's
  ranks differ from one process by float32 sums in another order only.
* The same two ranks with dropout off against the JAX ``Trainer`` on the
  global batch from the port's weights (``convert``): losses within 1e-5
  relative, each parameter's movement by the rules of
  ``tests/test_torch_train.py`` (cosine ≥ 0.9999, norms within 1e-3, float
  noise elements held to the noise steps' size).  The global batch (4 rows
  at 32²) is the first seed whose JAX steps pass the ReLU screen of
  ``tests/test_torch_train_dl.py``, chosen before any comparison.
* Each global quantity, two ranks against one process
  (``tests/torch_parallel_cases.py``): BatchNorm's output, input gradient
  and running statistics; the masked MSE with padded rows on one rank; the
  dropout masks (bit for bit); a dedup batch whose rows read slots of the
  other rank, in training and eval; Demand's teacher-forcing coins; remat
  and accumulation; ``score_split``; a SIGTERM on one rank.  Values within
  ``ATOL``, gradients within ``GRAD_SHARE`` of the step's largest gradient
  element plus ``GRAD_RTOL``: float32 sums in another order (two ranks'
  partial sums; BatchNorm's moments combined by Chan's formula in float64).
* ``train_transformer`` under a launcher's environment: rank 0 alone writes,
  the best ``val_wWAPE`` equals one process's within 1e-5 relative, over
  one epoch (four steps): the two runs' sums differ in order, and past a few
  steps Adafactor's sign-like updates carry a rounding at a ReLU input near
  zero into every later step (two epochs measured 3e-5 apart).
* The refusals: a hybrid mesh that does not divide, a world size that
  disagrees with the environment.

Each spawn has its own time limit, so a hang fails its test.
"""

import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visuelle2_tpu.models import VocabSizes as JVocab
from visuelle2_tpu.models import build as jbuild
from visuelle2_tpu.parallel.mesh import make_mesh as jmake_mesh
from visuelle2_tpu.train import loop as jloop
from visuelle2_tpu.train import optim as joptim
from visuelle2_tpu_torch.convert import to_jax_variables
from visuelle2_tpu_torch.data.loader import BatchLoader, shard_batch
from visuelle2_tpu_torch.data.synthetic import make_synthetic_dataset
from visuelle2_tpu_torch.models import VocabSizes, build
from visuelle2_tpu_torch.parallel import distributed, mesh as mesh_lib
from visuelle2_tpu_torch.parallel import demo_multihost
from visuelle2_tpu_torch.parallel.demo_multihost import synthetic_global_batch
from tests.test_torch_train import _dropout_off, _flat
from tests.test_torch_train_dl import KINK_ATOL, _relu_margin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = os.path.join(REPO, "tests", "torch_parallel_cases.py")
SPAWN_TIMEOUT_S = 240
LOSS_ATOL, SUMS_RTOL = 1e-5, 2e-5
JAX_LOSS_RTOL, COS_FLOOR, NORM_RTOL, NOISE_SHARE = 1e-5, 0.9999, 1e-3, 1e-8
ATOL = 1e-5
GRAD_SHARE, GRAD_RTOL = 1e-5, 1e-4
LR = 1e-3
WAPE_RTOL = 1e-5
# The JAX comparison's global batch: 4 rows at 32² (two a rank), the demo's
# batch of the first seed from 0 up whose two JAX steps pass the ReLU screen
# (``tests/test_torch_train_dl.py::_relu_margin``; seeds 0, 1 and 2 keep an
# input within 6e-6 of zero), chosen before any comparison.
JAX_BATCH, JAX_IMAGE, JAX_BATCH_SEED = 4, 32, 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", **extra)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _start(cmds):
    """Start ``{name: (argv, env)}`` side by side."""
    return {k: subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True, cwd=REPO, env=env)
            for k, (argv, env) in cmds.items()}


def _collect(procs):
    """Each started process's stdout, each within its time limit; fails with
    the stderr of any that failed or outlived its limit."""
    outs, failed = {}, []
    try:
        for k, p in procs.items():
            try:
                out, err = p.communicate(timeout=SPAWN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                failed.append(f"{k}: timed out after {SPAWN_TIMEOUT_S} s\n{err[-3000:]}")
                continue
            if p.returncode != 0:
                failed.append(f"{k}: exit {p.returncode}\n{err[-3000:]}")
            outs[k] = out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not failed, "\n".join(failed)
    return outs


def _run_all(cmds):
    return _collect(_start(cmds))


def _last_json(stdout: str) -> dict:
    lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
    assert lines, f"no JSON line in:\n{stdout}"
    return json.loads(lines[-1])


def _demo_cmds(extra_by_name):
    """The port's demo as two gloo ranks (and any other runs given) with
    ``extra_by_name[name]`` arguments each."""
    port = _free_port()
    base = [sys.executable, "-m", "visuelle2_tpu_torch.parallel.demo_multihost",
            "--device", "cpu", "--model_axis", "1"]
    cmds = {}
    for name, extra in extra_by_name.items():
        if name.startswith("rank"):
            extra = ["--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
                     "--process_id", name[-1], "--backend", "gloo"] + extra
        cmds[name] = (base + extra, _env())
    return cmds


def _json_by_name(outs):
    return {k: _last_json(v) for k, v in outs.items()}


# ------------------------------------------------------------------ the demo
def test_two_ranks_match_one_process_with_dropout():
    r = _json_by_name(_run_all(_demo_cmds({"rank0": [], "rank1": [], "one": []})))
    r0, r1, one = r["rank0"], r["rank1"], r["one"]
    assert r0["processes"] == 2 and r0["mesh"] == {"dcn": 1, "data": 2, "model": 1}
    assert one["processes"] == 1 and one["mesh"] == {"dcn": 1, "data": 1, "model": 1}
    assert np.all(np.isfinite(r0["losses"])) and len(r0["losses"]) == 2
    assert r0["losses"] == r1["losses"] and r0["eval_sums"] == r1["eval_sums"]
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=0, atol=LOSS_ATOL)
    for k, v in one["eval_sums"].items():
        np.testing.assert_allclose(r0["eval_sums"][k], v, rtol=SUMS_RTOL, err_msg=k)


def test_the_demo_batch_is_the_jax_demos():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import demo_multihost as jax_demo
    finally:
        sys.path.pop(0)
    want, got = jax_demo.synthetic_global_batch(16), synthetic_global_batch(16)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_trajectory(init, dims, steps, batch_seed):
    """The JAX ``Trainer``'s step function (its loss, rng split and update;
    one device, dropout off), jitted here once to return the step's
    gradient too, ``steps`` steps on the demo's global batch of
    ``batch_seed`` from the variables ``init``: the losses, the final
    parameters, the noise elements of its gradients, and before each step
    the ReLU screen's reading (``_relu_margin``)."""
    jm = jbuild("gated_v4", vocab=JVocab(5, 6, 5, 126), **dims)
    jtrainer = jloop.Trainer(jm, jloop.TrainConfig(grad_clip=0.5, learning_rate=LR),
                             mesh=jmake_mesh(data=1, model=1, devices=jax.devices()[:1]))
    params = jax.tree_util.tree_map(jnp.asarray, init["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, init.get("batch_stats", {}))
    tx = joptim.make_optimizer(params, 0.5, LR)
    state = jloop.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                             opt_state=tx.init(params), tx=tx)

    @jax.jit
    def jax_step(state, batch, rng):  # jloop.Trainer._build_train_step's step_fn
        drop_rng, samp_rng = jax.random.split(jax.random.fold_in(rng, state.step))
        (loss, new_stats), grads = jax.value_and_grad(jtrainer._train_loss, has_aux=True)(
            state.params, state.batch_stats, batch, drop_rng, samp_rng)
        return state.apply_gradients(grads, new_stats), loss, grads

    batch = synthetic_global_batch(JAX_BATCH, JAX_IMAGE, seed=batch_seed)
    losses, noise, margins = [], None, []
    for _ in range(steps):
        margins.append(_relu_margin(state.params, state.batch_stats, batch["images"]))
        state, loss, grads = jax_step(state, batch, jax.random.key(1000))
        grads = _flat(grads)
        total = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                            for g in grads.values()))
        quiet = {k: np.abs(g).ravel() <= NOISE_SHARE * total for k, g in grads.items()}
        noise = quiet if noise is None else {k: noise[k] | quiet[k] for k in quiet}
        losses.append(float(loss))
    return losses, _flat(state.params), noise, margins


def test_two_ranks_match_the_jax_trainer(tmp_path, monkeypatch):
    steps = 2
    dims = dict(output_len=12, embedding_dim=32, hidden_dim=64, image_arch="tiny")
    port = build("gated_v4", device="cpu", generator=torch.Generator().manual_seed(
        demo_multihost.WEIGHTS_SEED), vocab=VocabSizes(5, 6, 5, 126), **dims)
    init = jax.tree_util.tree_map(np.array, to_jax_variables(port))  # a copy
    params_out = str(tmp_path / "two_ranks.npz")
    flags = ["--no_dropout", "--learning_rate", str(LR), "--steps", str(steps),
             "--global_batch", str(JAX_BATCH), "--image_size", str(JAX_IMAGE),
             "--batch_seed", str(JAX_BATCH_SEED)]
    procs = _start(_demo_cmds({"rank0": flags + ["--params_out", params_out],
                               "rank1": flags}))
    try:
        with _dropout_off(monkeypatch):
            losses, trained_jax, noise, margins = _jax_trajectory(init, dims, steps,
                                                                  JAX_BATCH_SEED)
    finally:
        r = _json_by_name(_collect(procs))
    # The batch's steps keep every ReLU input of the trainable backbone
    # blocks more than KINK_ATOL from zero on the JAX side (nearer, the two
    # frameworks' rounding may take its two one-sided derivatives, which
    # Adafactor's sign-like steps carry on).
    assert min(margins) > KINK_ATOL, margins
    assert r["rank0"]["losses"] == r["rank1"]["losses"]
    np.testing.assert_allclose(r["rank0"]["losses"], losses, rtol=JAX_LOSS_RTOL)
    saved = np.load(params_out)
    with torch.no_grad():
        for name, p in port.named_parameters():
            p.copy_(torch.from_numpy(saved[f"param/{name}"]))
    trained = _flat(to_jax_variables(port)["params"])

    f0 = _flat(init["params"])
    assert set(f0) == set(trained_jax) == set(trained)
    moved = 0
    for k in sorted(f0):
        dj, dp = (trained_jax[k] - f0[k]).ravel(), (trained[k] - f0[k]).ravel()
        stage = re.search(r"\['backbone'\]\['([^']+)'\]", k)
        if stage and stage.group(1).startswith(joptim.FROZEN_BACKBONE_PREFIXES):
            assert not dj.any() and not dp.any(), f"frozen leaf moved: {k}"
            continue
        if noise[k].any():
            bound = steps * LR * max(1e-3, float(np.sqrt(np.mean(f0[k] ** 2)))) \
                * np.sqrt(dj.size)
            nj, np_ = np.linalg.norm(dj[noise[k]]), np.linalg.norm(dp[noise[k]])
            assert nj <= 1.01 * bound and np_ <= 1.01 * bound, (k, nj, np_, bound)
            dj, dp = dj[~noise[k]], dp[~noise[k]]
        nj, np_ = np.linalg.norm(dj), np.linalg.norm(dp)
        if nj == 0.0 and np_ == 0.0:
            continue
        cos = float(np.dot(dj, dp) / (nj * np_))
        assert cos >= COS_FLOOR, f"{k}: movement direction diverged (cos={cos:.6f})"
        assert abs(nj - np_) <= NORM_RTOL * nj, f"{k}: movement norm ({nj:.4e} vs {np_:.4e})"
        moved += 1
    assert moved > 20


# ---------------------------------------------------------- global quantities
@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """``tests/torch_parallel_cases.py`` as two gloo ranks and as one
    process: each rank's arrays, the one process's, and their summaries."""
    root = tmp_path_factory.mktemp("parallel_cases")
    dataset = make_synthetic_dataset(str(root / "ds"), num_train=0, num_test=24,
                                     image_size=32, rows_per_image=2)
    port = _free_port()
    cmds = {}
    for name, extra, out in (
            ("rank0", ["--coordinator", f"127.0.0.1:{port}", "--world", "2", "--rank", "0"],
             "two"),
            ("rank1", ["--coordinator", f"127.0.0.1:{port}", "--world", "2", "--rank", "1"],
             "two"),
            ("one", [], "one")):
        os.makedirs(root / out, exist_ok=True)
        cmds[name] = ([sys.executable, CASES, "--out", str(root / out), "--dataset", dataset]
                      + extra, _env())
    outs = _run_all(cmds)
    arrays = {"rank0": dict(np.load(root / "two" / "rank0.npz")),
              "rank1": dict(np.load(root / "two" / "rank1.npz")),
              "one": dict(np.load(root / "one" / "rank0.npz"))}
    return arrays, {k: _last_json(v) for k, v in outs.items()}


def _rows(arrays, key):
    """The ranks' row blocks of ``key``, concatenated; and the one process's."""
    return np.concatenate([arrays["rank0"][key], arrays["rank1"][key]]), arrays["one"][key]


def _replicated(arrays, key):
    """``key`` as every rank holds it (the same on both); and the one
    process's."""
    np.testing.assert_array_equal(arrays["rank0"][key], arrays["rank1"][key], err_msg=key)
    return arrays["rank0"][key], arrays["one"][key]


def _assert_same_step(arrays, prefix):
    """A step's global loss and gradient (summed over the ranks) against the
    one process's."""
    keys = [k for k in arrays["one"] if k.startswith(f"{prefix}_grad/")]
    assert len(keys) > 10 and set(keys) == {k for k in arrays["rank0"]
                                            if k.startswith(f"{prefix}_grad/")}
    largest = max(np.abs(arrays["one"][k]).max() for k in keys)
    for k in keys:
        got, want = _replicated(arrays, k)
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_SHARE * largest,
                                   err_msg=k)


def test_batchnorm_statistics_are_the_global_batchs(cases):
    arrays, _ = cases
    for bn in ("bn2d", "bn1d"):
        for key in ("y", "xgrad"):
            got, want = _rows(arrays, f"{bn}_{key}")
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=f"{bn} {key}")
        for key in ("running_mean", "running_var"):
            got, want = _replicated(arrays, f"{bn}_{key}")
            np.testing.assert_allclose(got, want, rtol=ATOL, atol=ATOL, err_msg=key)


def test_masked_mse_has_the_global_denominator(cases):
    arrays, _ = cases
    got, want = _replicated(arrays, "mse_loss")
    np.testing.assert_allclose(got, want, rtol=1e-6)
    got, want = _rows(arrays, "mse_pred_grad")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    # A Trainer step with padding on the last rank.
    got, want = _replicated(arrays, "padded_loss")
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)
    _assert_same_step(arrays, "padded")


def test_dropout_masks_are_the_global_batchs(cases):
    arrays, _ = cases
    for key in ("dropout_3d", "dropout_2d"):
        got, want = _rows(arrays, key)
        np.testing.assert_array_equal(got, want, err_msg=key)
        assert 0 < (got == 0).mean() < 1


@pytest.mark.parametrize("model", ["cross_attn_rnn_demand", "gated_v4"])
def test_dedup_slots_of_the_other_rank(cases, model):
    arrays, _ = cases
    got, want = _replicated(arrays, f"dedup_{model}_loss")
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)
    _assert_same_step(arrays, f"dedup_{model}")
    got, want = _replicated(arrays, f"dedup_{model}_eval_sums")
    np.testing.assert_allclose(got, want, rtol=SUMS_RTOL)
    got, want = _rows(arrays, f"dedup_{model}_forecast")
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_demand_teacher_forcing_coins_and_masks(cases):
    arrays, _ = cases
    got, want = _replicated(arrays, "tf_losses")
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)
    _assert_same_step(arrays, "tf")


@pytest.mark.parametrize("prefix", ["remat", "accum"])
def test_remat_and_accumulation(cases, prefix):
    arrays, _ = cases
    got, want = _replicated(arrays, f"{prefix}_loss")
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)
    _assert_same_step(arrays, prefix)


def test_score_split_over_a_mesh(cases):
    arrays, _ = cases
    (wape, mae, rows), (wape1, mae1, rows1) = _replicated(arrays, "score")
    assert rows == rows1 == 24
    np.testing.assert_allclose([wape, mae], [wape1, mae1], rtol=SUMS_RTOL)


def test_sigterm_on_one_rank_stops_every_rank_at_one_boundary(cases):
    _, summaries = cases
    r0, r1, one = summaries["rank0"], summaries["rank1"], summaries["one"]
    for s in (r0, r1, one):
        assert s["fit_last"]["preempted"] and s["fit_last"]["epoch"] == 0
    # One process stops at the next boundary; two ranks agree on the flag
    # through a step's all-reduce and read it two steps later.
    assert one["fit_last"]["steps_into_epoch"] == 1
    assert r0["fit_last"]["steps_into_epoch"] == r1["fit_last"]["steps_into_epoch"] == 4
    assert r0["fit_saves"] == [["save_preempted", 0, 4]] and r1["fit_saves"] == []


def test_autosave_over_ranks_happens_at_one_agreed_boundary(cases):
    _, summaries = cases
    r0, r1, one = summaries["rank0"], summaries["rank1"], summaries["one"]
    # One process saves at every boundary its clock passes; over two ranks
    # rank 0's deadline (due after step 1) rides in step 2's flags, read two
    # steps later: one autosave after step 4, then the epoch's save.
    assert one["autosave_saves"] == [["save_preempted", 0, i] for i in (1, 2, 3, 4)] + [
        ["save", 0]]
    assert r0["autosave_saves"] == [["save_preempted", 0, 4], ["save", 0]]
    assert r1["autosave_saves"] == []


# --------------------------------------------------------------------- the CLI
def test_train_cli_under_a_launcher(tmp_path):
    dataset = make_synthetic_dataset(str(tmp_path / "ds"), num_train=32, num_test=16,
                                     image_size=32)
    argv = [sys.executable, "-m", "visuelle2_tpu_torch.cli.train_transformer",
            "--dataset_path", dataset, "--model", "gated_v4", "--device", "cpu",
            "--image_arch", "tiny", "--image_size", "32", "--embedding_dim", "16",
            "--hidden_dim", "16", "--batch_size", "8", "--epochs", "1",
            "--learning_rate", "1e-3"]
    port = str(_free_port())
    launcher = dict(WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                    LOCAL_WORLD_SIZE="2")
    cmds = {f"rank{r}": (argv + ["--ckpt_dir", str(tmp_path / f"ck{r}")],
                         _env(RANK=str(r), LOCAL_RANK=str(r), **launcher)) for r in (0, 1)}
    cmds["one"] = (argv + ["--ckpt_dir", str(tmp_path / "one")], _env())
    outs = _run_all(cmds)
    # Each rank was given its own --ckpt_dir: only rank 0's holds anything.
    assert not os.path.exists(tmp_path / "ck1")
    for d in ("ck0", "one"):
        assert os.path.isfile(tmp_path / d / "hparams.json")
        assert os.path.isfile(tmp_path / d / "last" / "state.pt")
    assert "Best Model Path" in outs["rank0"] and "Best Model Path" not in outs["rank1"]

    def best(d):
        with open(tmp_path / d / "metrics.jsonl") as f:
            return min(r["val_wWAPE"] for r in map(json.loads, f) if "val_wWAPE" in r)

    np.testing.assert_allclose(best("ck0"), best("one"), rtol=WAPE_RTOL)


# ---------------------------------------------------------------- the refusals
def test_a_single_process_mesh_has_the_jax_axes_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = mesh_lib.make_mesh()
    assert isinstance(mesh, mesh_lib.LocalMesh)
    assert mesh_lib.mesh_shape(mesh) == {"data": 1, "model": 1}
    assert mesh_lib.batch_rank_world(mesh) == (0, 1)
    assert mesh_lib.batch_sharding(mesh) == (Shard(0), Replicate())
    assert mesh_lib.stacked_batch_sharding(mesh) == (Shard(1), Replicate())
    assert mesh_lib.replicated_sharding(mesh) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="no process group"):
        mesh_lib.make_mesh(data=2)


def test_hybrid_mesh_refuses_a_world_that_does_not_divide(monkeypatch):
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    distributed.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu")
    try:
        with pytest.raises(ValueError, match="not divisible"):
            distributed.make_hybrid_mesh(nodes=2)
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
        with pytest.raises(ValueError, match="not divisible"):
            distributed.make_hybrid_mesh()
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
        mesh = distributed.make_hybrid_mesh()
        assert mesh_lib.mesh_shape(mesh) == {"dcn": 1, "data": 1, "model": 1}
        assert mesh_lib.batch_sharding(mesh) == (Shard(0), Shard(0), Replicate())
    finally:
        distributed.shutdown()
    assert not dist.is_initialized()


def test_initialize_refuses_a_world_size_the_environment_contradicts(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="WORLD_SIZE=2"):
        distributed.initialize("127.0.0.1:1", num_processes=3, process_id=0, device="cpu")
    for k, v in (("RANK", "0"), ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="WORLD_SIZE=2"):
        distributed.initialize(num_processes=3, device="cpu")
    monkeypatch.delenv("RANK")
    with pytest.raises(ValueError, match="missing RANK"):
        distributed.initialize(device="cpu")


@pytest.mark.parametrize("native_prefetch,dedup", [(True, False), (False, False),
                                                   (False, True)])
def test_rank_loaders_split_every_global_batch(tmp_path, native_prefetch, dedup):
    """Four ranks' batches, put together, are the one-process loader's (the
    tail batch leaves two ranks only padding); a dedup batch's slots split
    by rank, its ``img_idx`` global."""
    from visuelle2_tpu_torch.data.images import ImageStore
    from visuelle2_tpu_torch.data.pipeline import load_visuelle2

    dataset = make_synthetic_dataset(str(tmp_path / "ds"), num_train=0, num_test=22,
                                     image_size=32, rows_per_image=2)
    arrays = load_visuelle2(dataset, "test", demand=True, output_len=12)
    store = ImageStore.build(os.path.join(dataset, "images"), arrays.image_paths, size=32)

    def batches(rank, world):
        return list(BatchLoader(arrays, store, 8, dedup_images=dedup, image_slots_multiple=4,
                                native_prefetch=native_prefetch, rank=rank, world=world))

    whole, parts = batches(0, 1), [batches(r, 4) for r in range(4)]
    assert all(len(p) == len(whole) == 3 for p in parts)
    assert parts[3][-1]["mask"].sum() == 0  # 22 rows: the tail's last ranks pad
    for i, batch in enumerate(whole):
        for k, v in batch.items():
            got = np.concatenate([p[i][k].numpy() for p in parts])
            np.testing.assert_array_equal(got, v.numpy(), err_msg=f"batch {i} {k}")


def test_rank_blocks_must_divide():
    with pytest.raises(ValueError, match="divide"):
        BatchLoader(None, None, 10, rank=0, world=4)
    assert shard_batch({"x": np.arange(6)})["x"].tolist() == list(range(6))
