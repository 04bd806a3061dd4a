"""The VISUELLE-1 GTM (``gtm_v1``) in the port on the CPU, against the JAX
package: the text featurizer bit for bit, the forward and its attention
weights (non-AR and AR, the ``use_img`` / ``use_text`` ablations, a
unique-image batch with ``img_idx``; weights carried by ``convert``), the
dropout rate at every site, three train steps of ``Trainer`` against the JAX
``Trainer`` with the frozen tower unmoved, the optimizer's update with the
tower's gradients absent or zero, ``train_transformer`` ->
``forecast_transformer --ckpt_path`` with pandas and PIL hidden, the text
fingerprint check, and each package reading the other's ``hparams.json``.

Small widths: tiny backbone at 32², E = H = 16, B ≤ 8.  Tolerances: a
forward 1e-4 (f32, as ``tests/test_torch_cross_attn.py``); the trajectories
as ``tests/test_torch_train.py`` holds them (losses 1e-5 relative, BatchNorm
statistics 1e-5, each parameter's movement cosine ≥ 0.9999 and norms within
1e-3, float-noise elements to the noise step's size).  The JAX module's AR
forward raises (it adds a causal mask [12, 12] to cross-attention scores
[.., 12, 52]); the reference's memory-only layer ignores that mask, as the
port does, so the AR comparisons run the JAX module with the mask taken out.
"""

import copy
import functools
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import jax

from __graft_entry__ import _synthetic_batch
from tests.test_torch_train import (
    LR,
    _assert_same_trajectory,
    _dropout_off,
    _jax_grad_fn,
    _jax_state,
    _noise_mask,
    _torch_batch,
)
from visuelle2_tpu.cli import forecast_transformer as jforecast_transformer
from visuelle2_tpu.models import build as jbuild
from visuelle2_tpu.models import gtm_v1 as jgtm_v1
from visuelle2_tpu.ops import attention as jattention
from visuelle2_tpu.train import hparams as jhparams
from visuelle2_tpu_torch.cli import forecast_transformer, train_transformer
from visuelle2_tpu_torch.convert import load_jax_variables, to_jax_variables
from visuelle2_tpu_torch.data.synthetic import make_synthetic_dataset
from visuelle2_tpu_torch.models import build, gtm_v1
from visuelle2_tpu_torch.ops import attention, dropout
from visuelle2_tpu_torch.train import hparams, loop, optim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
IMAGE = 32
KW = dict(output_len=12, image_arch="tiny", embedding_dim=16, hidden_dim=16)
SMALL = ["--device", "cpu", "--image_arch", "tiny", "--image_size", "32",
         "--embedding_dim", "16", "--hidden_dim", "16", "--batch_size", "8"]
CONFIGS = {"full": {}, "ar": dict(autoregressive=True), "no_img": dict(use_img=False),
           "no_text": dict(use_text=False)}


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one CPU thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _no_causal_mask():
    """The JAX module with the reference's AR decode: no mask reaches the
    memory-only layer."""
    return mock.patch.object(jgtm_v1, "causal_mask", lambda size: None)


def _batch(n, seed):
    b = _synthetic_batch(n, IMAGE, seed=seed)
    b["text_features"] = np.random.default_rng(seed + 1).standard_normal(
        (n, gtm_v1.BERT_DIM)).astype(np.float32)
    return b


@functools.lru_cache(maxsize=None)
def _jax_variables(config):
    """One set of weights per configuration (the tree depends on the
    ablations), drawn by the port's ``build`` and carried to the JAX layout
    by ``convert``; the tower's BatchNorm statistics off their 0 / 1 start.
    The JAX modules take them as their own (a JAX init here would compile a
    whole forward)."""
    variables = to_jax_variables(build("gtm_v1", device="cpu", **KW, **CONFIGS[config],
                                       generator=torch.Generator().manual_seed(3)))
    rng = np.random.default_rng(4)
    tower = variables["batch_stats"]["image_encoder"]
    variables["batch_stats"]["image_encoder"] = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var"
                         else rng.uniform(-0.1, 0.1, a.shape)).astype(np.float32), tower)
    return variables


def _port(config, variables=None):
    model = build("gtm_v1", device="cpu", **KW, **CONFIGS[config])
    return load_jax_variables(model, variables or _jax_variables(config))


def test_text_featurizer_gives_the_jax_bits(capsys):
    dicts = ({"shirt": 0, "long sleeve": 1, "culottes": 2},
             {"red": 0, "dark blue": 1}, {"wool": 0, "cotton": 1})
    codes = [np.array([0, 1, 2, 2]), np.array([0, 1, 1, 0]), np.array([1, 0, 1, 0])]
    ours = gtm_v1.TextFeaturizer(*dicts)
    assert "using deterministic hashed text features" in capsys.readouterr().out
    theirs = jgtm_v1.TextFeaturizer(*dicts, use_bert=False)
    got, want = ours(*codes), theirs(*codes)
    assert got.dtype == np.float32 and got.shape == (4, gtm_v1.BERT_DIM)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert ours.fingerprint == theirs.fingerprint == "hashed-crc32-v1"
    assert gtm_v1.GTM_V1_NORM_SCALAR == jgtm_v1.GTM_V1_NORM_SCALAR == 1065.0


@pytest.mark.parametrize("config,dedup", [("full", False), ("full", True), ("ar", False),
                                          ("no_img", False), ("no_text", False)])
def test_forward_and_attention_match_jax(config, dedup):
    batch = _batch(6, 3)
    if dedup:  # three photos, two rows each, as the loader's eval dedup ships them
        batch["images"] = batch["images"][:3]
        batch["img_idx"] = np.array([0, 0, 1, 1, 2, 2], np.int32)
    jm = jbuild("gtm_v1", **KW, **CONFIGS[config])
    with _no_causal_mask():
        want, want_attn = jm.apply(_jax_variables(config), batch)
    model = _port(config)
    with torch.inference_mode():
        got, attn = model(_torch_batch(batch))
    Lq = 12 if config == "ar" else 1
    assert got.shape == (6, 12) and attn.shape == (6, Lq, 52)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), rtol=0, atol=ATOL)
    if dedup:  # the same forecasts as the rows' own images
        full = dict(batch, images=np.repeat(batch["images"], 2, axis=0))
        del full["img_idx"]
        with torch.inference_mode():
            np.testing.assert_allclose(model(_torch_batch(full))[0].numpy(), got.numpy(),
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("config", ["full", "ar"])
def test_dropout_rate_at_every_site_matches_jax(config, monkeypatch):
    """Each dropout a train forward applies, as (rate, elements), in both
    frameworks: flax's ``Dropout`` and the JAX attention's probability
    dropout against the port's ``ops.dropout.dropout``."""
    import flax.linen as fnn

    variables = _jax_variables(config)
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
    batch = _batch(4, 5)
    with _no_causal_mask():  # the sites are recorded as the forward is traced
        jax.eval_shape(functools.partial(
            jbuild("gtm_v1", **KW, **CONFIGS[config]).apply, train=True,
            mutable=["batch_stats"]), variables, batch, rngs={"dropout": jax.random.key(0)})

    def recording(x, rate, training):
        port_sites.append((rate, x.numel()))
        return x

    monkeypatch.setattr(dropout, "dropout", recording)
    monkeypatch.setattr(attention, "dropout", recording)
    model = _port(config, variables).train()
    model(_torch_batch(batch), generator=torch.Generator().manual_seed(0))
    assert sorted(port_sites) == sorted(jax_sites) and len(jax_sites) >= 10


def _tower_state(model):
    return {k: v.clone() for k, v in model.image_encoder.state_dict().items()}


def test_train_steps_match_jax_trainer_and_leave_the_tower(monkeypatch):
    config = "full"
    batches = [_batch(8, 100 + i) for i in range(3)]
    variables = _jax_variables(config)
    jm = jbuild("gtm_v1", **KW, **CONFIGS[config])
    model = _port(config, variables)
    trainer = loop.Trainer(model, loop.TrainConfig(grad_clip=0.5, learning_rate=LR))
    tower = _tower_state(model)
    with _dropout_off(monkeypatch):
        jtrainer, jstate = _jax_state(jm, variables)
        state = trainer.init_state()
        grad_fn = _jax_grad_fn(jtrainer)
        j_losses, p_losses, j_grads = [], [], []
        for b in batches:
            j_grads.append(grad_fn(jstate.params, jstate.batch_stats, b))
            jstate, m = jtrainer.train_step(jstate, b, jax.random.key(1000))
            j_losses.append(float(m["loss"]))
            state, m = trainer.train_step(state, _torch_batch(b))
            p_losses.append(float(m["loss"]))
    assert state.step == 3 and model.training
    # The tower's parameters and BatchNorm statistics: the same bits, and the
    # fusion's BatchNorm1d did move on batch statistics.
    assert not model.image_encoder.backbone.training
    after = _tower_state(model)
    assert all(torch.equal(after[k], tower[k]) for k in tower)
    assert not torch.equal(model.static_feature_encoder.bn.running_mean,
                           torch.from_numpy(variables["batch_stats"]["static_feature_encoder"]
                                            ["bn"]["mean"]))
    _assert_same_trajectory(variables, jstate, model, j_losses, p_losses,
                            _noise_mask(j_grads))


def test_the_tower_takes_the_update_of_zero_gradients():
    """JAX labels the tower's layer3/4 leaves "train" and hands them zero
    gradients (stop_gradient); the port gives them none.  The clip's global
    norm and every update are the same bits either way, and the tower does
    not move."""
    torch.manual_seed(0)
    model = _port("full")
    batch = _torch_batch(_batch(8, 7))
    with dropout.disabled():
        model.train()
        target, pred = loop.target_and_pred(batch, model(batch)[0])
        loop.mse_loss(target, pred, loop.expand_mask(batch, target)).backward()
    zero = copy.deepcopy(model)
    for (name, p), q in zip(model.named_parameters(), zero.parameters()):
        if name.startswith("image_encoder."):
            q.requires_grad_(True)
            q.grad = torch.zeros_like(q)
        else:
            q.grad = p.grad.clone()
    assert all(p.grad is None and not p.requires_grad
               for n, p in model.named_parameters() if n.startswith("image_encoder."))
    norms = [optim.global_norm([p.grad for p in m.parameters() if p.requires_grad])
             for m in (model, zero)]
    assert torch.equal(norms[0], norms[1]) and norms[0] > 0.5  # the clip engages
    before = {n: p.clone() for n, p in model.named_parameters()}
    for m in (model, zero):
        optim.Adafactor(m.parameters(), lr=LR, grad_clip=0.5).step()
    for (name, p), q in zip(model.named_parameters(), zero.parameters()):
        assert torch.equal(p, q), name
        if name.startswith("image_encoder."):
            assert torch.equal(p, before[name]), name


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of ``train_transformer --model gtm_v1`` on the CPU."""
    root = tmp_path_factory.mktemp("gtm_v1")
    data = make_synthetic_dataset(str(root / "d"), num_train=24, num_test=12,
                                  image_size=IMAGE, rows_per_image=2)
    ck = str(root / "ck")
    best = train_transformer.main(["--dataset_path", data, "--model", "gtm_v1", *SMALL,
                                   "--epochs", "1", "--ckpt_dir", ck,
                                   "--learning_rate", "1e-2"])
    return data, ck, best


def test_train_is_demand_only_and_records_the_fingerprint(trained, tmp_path):
    data, ck, best = trained
    with open(os.path.join(ck, "hparams.json")) as f:
        manifest = json.load(f)
    assert manifest["model"] == "gtm_v1" and manifest["text_fingerprint"] == "hashed-crc32-v1"
    assert best == os.path.join(ck, "0")
    with pytest.raises(SystemExit, match="demand-only"):
        train_transformer.main(["--dataset_path", data, "--model", "gtm_v1", "--demand", "0",
                                *SMALL, "--ckpt_dir", str(tmp_path / "ck")])


def test_forecast_dumps_the_decoder_attention(trained, tmp_path):
    data, ck, _ = trained
    path = str(tmp_path / "attn.npz")
    r = forecast_transformer.main(["--dataset_path", data, "--device", "cpu",
                                   "--image_size", "32", "--batch_size", "8",
                                   "--ckpt_path", ck, "--dump_attention", path])
    assert np.isfinite([r.wape, r.mae]).all() and r.num_forecasts == 12
    with np.load(path) as z:
        assert [z[k].shape for k in z] == [(8, 1, 52)]


def test_a_fingerprint_mismatch_is_an_error(trained, tmp_path):
    data, ck, _ = trained
    other = str(tmp_path / "ck")
    subprocess.run(["cp", "-r", ck, other], check=True)
    path = os.path.join(other, "hparams.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["text_fingerprint"] = "bert-base-uncased"
    hparams.save_hparams(other, manifest)
    with pytest.raises(SystemExit, match="featurizer mismatch"):
        forecast_transformer.main(["--dataset_path", data, "--device", "cpu",
                                   "--image_size", "32", "--batch_size", "8",
                                   "--ckpt_path", other])


def test_each_package_reads_the_others_manifest(trained, tmp_path):
    _, ck, _ = trained
    ours = hparams.load_hparams(ck)
    assert jhparams.load_hparams(ck) == ours
    jparser = jforecast_transformer.build_parser()
    jargs = jparser.parse_args(["--ckpt_path", ck])
    jhparams.apply_ckpt_hparams(jargs, jparser, jhparams.TRANSFORMER_STRUCTURAL,
                                ["--ckpt_path", ck])
    assert (jargs.model, jargs.embedding_dim, jargs.image_arch) == ("gtm_v1", 16, "tiny")
    # A manifest the JAX trainer wrote, read by the port.
    theirs = dict(ours, embedding_dim=24, text_fingerprint="bert-base-uncased")
    jdir = str(tmp_path / "jax")
    jhparams.save_hparams(jdir, theirs)
    assert hparams.load_hparams(jdir) == theirs
    parser = forecast_transformer.build_parser()
    args = parser.parse_args(["--ckpt_path", jdir])
    hparams.apply_ckpt_hparams(args, parser, hparams.TRANSFORMER_STRUCTURAL,
                               ["--ckpt_path", jdir])
    assert (args.model, args.embedding_dim, args.demand) == ("gtm_v1", 24, 1)
    with pytest.raises(SystemExit, match="featurizer mismatch"):
        hparams.check_text_fingerprint(theirs, "hashed-crc32-v1")
    hparams.check_text_fingerprint(ours, "hashed-crc32-v1")


def test_train_then_forecast_with_pandas_and_pil_hidden(tmp_path):
    """In a process where pandas and PIL cannot be imported: one epoch of
    ``train_transformer --model gtm_v1 --demand 1 --device cpu``, then
    ``forecast_transformer --ckpt_path`` with no dim flags reproduces the
    logged val_wWAPE."""
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
        "from visuelle2_tpu_torch.cli import forecast_transformer, train_transformer\n"
        "from visuelle2_tpu_torch.data.images import ImageStore\n"
        "from visuelle2_tpu_torch.data.pipeline import load_visuelle2\n"
        "from visuelle2_tpu_torch.data.synthetic import make_synthetic_dataset\n"
        "d, ck = sys.argv[1], sys.argv[2]\n"
        "make_synthetic_dataset(d, num_train=24, num_test=12, image_size=32,\n"
        "                       write_images=False, rows_per_image=2)\n"
        "for split in ('train', 'test'):\n"
        "    paths = load_visuelle2(d, split, demand=True, output_len=12).image_paths\n"
        "    unique, row_to_img = ImageStore.unique_paths(paths)\n"
        "    px = np.random.default_rng(0).integers(0, 256, (len(unique), 32, 32, 3), np.uint8)\n"
        "    ImageStore(px, row_to_img).write_cache(ImageStore.cache_path(d, split, 32), paths)\n"
        "small = ['--dataset_path', d, '--device', 'cpu', '--image_size', '32',\n"
        "         '--batch_size', '8']\n"
        "dims = ['--model', 'gtm_v1', '--demand', '1', '--image_arch', 'tiny',\n"
        "        '--embedding_dim', '16', '--hidden_dim', '16']\n"
        "best = train_transformer.main(small + dims + ['--epochs', '1', '--ckpt_dir', ck,\n"
        "                                              '--learning_rate', '1e-2'])\n"
        "r = forecast_transformer.main(small + ['--ckpt_path', best])\n"
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
    assert np.isfinite(epoch0["train_loss"])
    assert abs(result["wape"] - epoch0["val_wWAPE"]) <= 1e-5 * abs(epoch0["val_wWAPE"])
    with open(os.path.join(ck, "hparams.json")) as f:
        assert json.load(f)["text_fingerprint"] == "hashed-crc32-v1"
