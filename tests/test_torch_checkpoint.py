"""The port's checkpoints, manifest and train CLI on the CPU: top-k retention
and the ``last`` slot, a save at a step boundary and its resume (the same
bits as an uninterrupted run, dropout on), read-only managers, ``hparams.json``
read by either package, ``fit``'s autosave, trace, early stop and NaN halt,
and ``train_transformer`` -> ``forecast_transformer --ckpt_path`` end to end
with pandas and PIL hidden, as on the card's machine.

Small widths (tiny backbone, E=H=16, 32² images, B=8).
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch import nn

from visuelle2_tpu.cli import forecast_transformer as jforecast_transformer
from visuelle2_tpu.train import hparams as jhparams
from visuelle2_tpu_torch.cli import forecast_transformer, train_transformer
from visuelle2_tpu_torch.data.images import ImageStore
from visuelle2_tpu_torch.data.loader import BatchLoader
from visuelle2_tpu_torch.data.pipeline import load_visuelle2
from visuelle2_tpu_torch.data.synthetic import make_synthetic_dataset
from visuelle2_tpu_torch.models import VocabSizes, build
from visuelle2_tpu_torch.train import hparams
from visuelle2_tpu_torch.train.checkpoint import CheckpointManager, resolve_ckpt_path
from visuelle2_tpu_torch.train.loop import TrainConfig, Trainer, TrainState
from visuelle2_tpu_torch.train.optim import Adafactor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--image_arch", "tiny", "--image_size", "32",
         "--embedding_dim", "16", "--hidden_dim", "16", "--batch_size", "8"]


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one CPU thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("vis2")), num_train=40,
                                  num_test=16, image_size=32, rows_per_image=2)


def _tiny_state(seed=0):
    torch.manual_seed(seed)
    model = nn.Sequential(nn.Linear(4, 3), nn.BatchNorm1d(3))
    return TrainState(model, Adafactor(model.parameters(), lr=1e-2), 0)


def _step(state):
    state.model.train()
    loss = state.model(torch.randn(5, 4)).square().mean()
    state.optimizer.zero_grad()
    loss.backward()
    state.optimizer.step()
    state.step += 1


def test_top_k_keeps_the_best_and_the_last_slot_survives(tmp_path):
    ck = CheckpointManager(str(tmp_path / "ck"), save_top_k=1)
    state = _tiny_state()
    for epoch, wape in enumerate((3.0, 1.0, 2.0, 4.0)):
        _step(state)
        ck.save(epoch, state, {"val_wWAPE": wape, "val_mae": 0.5, "epoch": epoch})
    names = sorted(os.listdir(ck.directory))
    assert names == ["1", "last"], names  # no temporary slot left behind
    assert ck.best_step() == 1 and ck.best_metric() == (1, 1.0)
    assert ck.best_model_path == os.path.join(ck.directory, "1")
    assert resolve_ckpt_path(ck.best_model_path) == (ck.directory, 1)
    assert ck.metrics(1) == {"val_wWAPE": 1.0, "val_mae": 0.5}
    # The last slot holds epoch 3's state (the newest), though top-k dropped it.
    fresh = _tiny_state(seed=1)
    restored, start_epoch, skip = ck.restore_latest(fresh)
    assert (start_epoch, skip, restored.step) == (4, 0, 4)
    for a, b in zip(restored.model.state_dict().values(), state.model.state_dict().values()):
        assert torch.equal(a, b)
    assert restored.optimizer.param_groups[0]["count"] == 4
    # restore_for_eval reads the best epoch: parameters and buffers only.
    model = ck.restore_for_eval(_tiny_state(seed=2).model)
    best = torch.load(os.path.join(ck.directory, "1", "state.pt"), weights_only=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, best["model"][k])


def test_save_preempted_then_restore_latest(tmp_path):
    ck = CheckpointManager(str(tmp_path / "ck"), save_top_k=2)
    state = _tiny_state()
    _step(state)
    ck.save(0, state, {"val_wWAPE": 5.0})
    for _ in range(3):
        _step(state)
    ck.save_preempted(1, state, steps_into_epoch=3)
    assert sorted(os.listdir(ck.directory)) == ["0", "last"]
    restored, start_epoch, skip = ck.restore_latest(_tiny_state(seed=3))
    assert (start_epoch, skip, restored.step) == (1, 3, 4)
    # Without a last slot, the newest kept epoch: resume at the next one.
    plain = CheckpointManager(str(tmp_path / "plain"), save_last=False)
    plain.save(2, state, {"val_wWAPE": 1.0})
    assert plain.restore_latest(_tiny_state(seed=4))[1:] == (3, 0)
    with pytest.raises(ValueError, match="save_last"):
        plain.save_preempted(2, state)


def test_read_only_manager_creates_nothing(tmp_path):
    missing = tmp_path / "missing"
    with pytest.raises(FileNotFoundError, match="no such checkpoint directory"):
        CheckpointManager(str(missing), read_only=True)
    assert not missing.exists()
    ck = CheckpointManager(str(tmp_path / "ck"))
    state = _tiny_state()
    ck.save(0, state, {"val_wWAPE": 1.0})
    before = sorted(os.walk(ck.directory))
    ro = CheckpointManager(ck.directory, read_only=True)
    ro.restore_for_eval(_tiny_state(seed=1).model)
    ro.restore_latest(_tiny_state(seed=1))
    with pytest.raises(ValueError, match="read_only"):
        ro.save(1, state, {"val_wWAPE": 0.5})
    with pytest.raises(ValueError, match="read_only"):
        ro.save_preempted(1, state)
    assert sorted(os.walk(ck.directory)) == before


def test_an_orbax_directory_raises_naming_the_format(tmp_path):
    step = tmp_path / "ck" / "3"
    (step / "default").mkdir(parents=True)
    (step / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax checkpoint written by the JAX package"):
        CheckpointManager(str(tmp_path / "ck"), read_only=True)


class _PreemptingLoader:
    """A real SIGTERM to this process right before batch ``after`` of epoch
    ``epoch`` (the pattern of tests/test_train_loop.py)."""

    def __init__(self, loader, epoch, after):
        self.loader, self.epoch, self.after = loader, epoch, after
        self._current = None

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self._current = epoch
        self.loader.set_epoch(epoch)

    def __iter__(self):
        for i, b in enumerate(self.loader):
            if self._current == self.epoch and i == self.after:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b


def _loaders(dataset):
    out = {}
    for split in ("train", "test"):
        arrays = load_visuelle2(dataset, split, demand=True, output_len=12)
        store = ImageStore.build(os.path.join(dataset, "images"), arrays.image_paths, size=32)
        out[split] = BatchLoader(arrays, store, 8, shuffle=split == "train", seed=21,
                                 drop_remainder=split == "train")
    return out["train"], out["test"]


def _trainer(epochs):
    model = build("gated_v4", device="cpu", vocab=VocabSizes(5, 6, 5, 126),
                  generator=torch.Generator().manual_seed(21), output_len=12,
                  image_arch="tiny", embedding_dim=16, hidden_dim=16)
    return Trainer(model, TrainConfig(epochs=epochs, grad_clip=0.5, learning_rate=1e-2))


def test_preempted_and_resumed_run_gives_the_same_bits(dataset, tmp_path):
    """SIGTERM before batch 2 of epoch 1: fit saves the ``last`` slot at that
    step boundary and returns; a new process's trainer restores it and skips
    the 2 done steps.  With dropout on, it ends with the uninterrupted run's
    bits: the loader's order is pinned by ``set_epoch`` and each step's
    dropout generator comes from the global step."""
    train, test = _loaders(dataset)
    steps = len(train)
    control = _trainer(2)
    control_state = control.fit(train, test)
    assert control_state.step == 2 * steps

    ck = CheckpointManager(str(tmp_path / "ck"), save_top_k=1)
    first = _trainer(2)
    first.fit(_PreemptingLoader(train, epoch=1, after=2), test, checkpointer=ck)
    assert first.history[-1] == {**first.history[-1], "epoch": 1, "preempted": True,
                                 "steps_into_epoch": 2}
    resumed = _trainer(2)
    state, start_epoch, skip = ck.restore_latest(resumed.init_state())
    assert (start_epoch, skip, state.step) == (1, 2, steps + 2)
    state = resumed.fit(train, test, state=state, checkpointer=ck, start_epoch=start_epoch,
                        skip_steps=skip)
    assert [h["epoch"] for h in resumed.history] == [1] and state.step == 2 * steps
    assert resumed.history[-1]["val_wWAPE"] == control.history[-1]["val_wWAPE"]
    want = control.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_hparams_json_is_read_by_both_packages(tmp_path):
    manifest = {"cli": "train_transformer", "model": "gated_v4", "demand": 1,
                "output_len": 12, "embedding_dim": 16, "hidden_dim": 24,
                "num_attn_heads": 4, "num_hidden_layers": 1, "use_img": 1, "use_text": 1,
                "use_encoder_mask": 1, "autoregressive": 0, "query_modality": "text",
                "image_arch": "tiny", "norm_scalar": 53.0,
                "vocab": {"num_cat": 5, "num_col": 6, "num_fab": 5, "num_store": 126}}
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    hparams.save_hparams(port_dir, manifest)
    jhparams.save_hparams(jax_dir, manifest)
    for d in (port_dir, jax_dir):
        os.makedirs(os.path.join(d, "3"))
        for load in (hparams.load_hparams, jhparams.load_hparams):
            assert load(d) == manifest and load(os.path.join(d, "3")) == manifest
    with open(os.path.join(port_dir, "hparams.json")) as a, \
            open(os.path.join(jax_dir, "hparams.json")) as b:
        assert a.read() == b.read()
    # Structural flags not passed are filled; a passed conflicting one stops.
    for mod, parser in ((forecast_transformer, forecast_transformer.build_parser()),
                        (jforecast_transformer, jforecast_transformer.build_parser())):
        argv = ["--ckpt_path", port_dir, "--embedding_dim", "16"]
        args = parser.parse_args(argv)
        got = hparams.apply_ckpt_hparams(args, parser, hparams.TRANSFORMER_STRUCTURAL, argv)
        assert got == manifest and args.hidden_dim == 24 and args.image_arch == "tiny"
        argv = ["--ckpt_path", port_dir, "--hidden_dim", "64"]
        with pytest.raises(SystemExit, match="hidden_dim=64 vs checkpoint hidden_dim=24"):
            hparams.apply_ckpt_hparams(parser.parse_args(argv), parser,
                                       hparams.TRANSFORMER_STRUCTURAL, argv)
    with pytest.raises(SystemExit, match="vocabulary mismatch"):
        hparams.check_dataset_compat(manifest, VocabSizes(6, 6, 5, 126), 53.0)


def test_train_then_forecast_with_pandas_and_pil_hidden(tmp_path):
    """In a process where pandas and PIL cannot be imported: one epoch of
    ``train_transformer --device cpu``, then ``forecast_transformer
    --ckpt_path`` with no dim flags reproduces the logged val_wWAPE."""
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
        "make_synthetic_dataset(d, num_train=32, num_test=12, image_size=32,\n"
        "                       write_images=False, rows_per_image=2)\n"
        "for split in ('train', 'test'):\n"
        "    paths = load_visuelle2(d, split, demand=True, output_len=12).image_paths\n"
        "    unique, row_to_img = ImageStore.unique_paths(paths)\n"
        "    px = np.random.default_rng(0).integers(0, 256, (len(unique), 32, 32, 3), np.uint8)\n"
        "    ImageStore(px, row_to_img).write_cache(ImageStore.cache_path(d, split, 32), paths)\n"
        "small = ['--dataset_path', d, '--device', 'cpu', '--image_size', '32',\n"
        "         '--batch_size', '8']\n"
        "dims = ['--model', 'gated_v4', '--image_arch', 'tiny', '--embedding_dim', '16',\n"
        "        '--hidden_dim', '16']\n"
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
    assert np.isfinite(epoch0["train_loss"]) and epoch0["lr"] == 1e-2
    assert abs(result["wape"] - epoch0["val_wWAPE"]) <= 1e-5 * abs(epoch0["val_wWAPE"])
    assert sorted(os.listdir(ck)) == ["0", "hparams.json", "last", "metrics.jsonl"]
    with open(os.path.join(ck, "hparams.json")) as f:
        manifest = json.load(f)
    assert manifest["model"] == "gated_v4" and manifest["embedding_dim"] == 16
    assert jhparams.load_hparams(ck) == manifest


def test_resume_auto_on_an_empty_directory_starts_fresh(dataset, tmp_path, capsys):
    ck = str(tmp_path / "ck")
    train_transformer.main(["--dataset_path", dataset, "--model", "gated_v4", *SMALL,
                            "--epochs", "1", "--ckpt_dir", ck, "--resume_from", "auto"])
    assert "starting fresh" in capsys.readouterr().out
    assert os.path.isdir(os.path.join(ck, "last"))
    with pytest.raises(SystemExit, match="--resume_from"):
        train_transformer.main(["--dataset_path", dataset, "--model", "gated_v4", *SMALL,
                                "--epochs", "1", "--ckpt_dir", ck, "--resume_from",
                                str(tmp_path / "nothing")])


@pytest.mark.parametrize("flags,error,match", [
    # Ported: a backbone file that is not there is the error now.
    (["--pretrained_backbone", "x.npz"], FileNotFoundError, "x.npz"),
    (["--dedup_images", "1"], NotImplementedError, "item 11")])
def test_train_flags_not_ported_yet_raise(dataset, tmp_path, flags, error, match):
    argv = ["--dataset_path", dataset, "--model", "gated_v4", *SMALL, "--epochs", "1",
            "--ckpt_dir", str(tmp_path / "ck"), *flags]
    with pytest.raises(error, match=match):
        train_transformer.main(argv)


class _RecordingCheckpointer:
    """Records the saves ``fit`` makes."""

    def __init__(self):
        self.saves, self.preempted = [], []

    def save(self, epoch, state, metrics):
        self.saves.append((epoch, state.step))

    def save_preempted(self, epoch, state, steps_into_epoch=0):
        self.preempted.append((epoch, steps_into_epoch))


def test_fit_autosave_trace_early_stop_and_nan_halt(dataset, tmp_path, monkeypatch):
    train, test = _loaders(dataset)
    steps = len(train)
    trainer = _trainer(5)
    trainer.config.autosave_minutes = 1e-9  # every step boundary ticks
    trainer.config.trace_dir = str(tmp_path / "trace")
    trainer.config.early_stop_patience = 2
    wapes = iter([5.0, 4.0, 4.5, 4.2, 1.0])
    monkeypatch.setattr(trainer, "evaluate",
                        lambda state, loader: {"val_mae": 1.0, "val_wWAPE": next(wapes)})
    rec = _RecordingCheckpointer()
    state = trainer.fit(train, test, checkpointer=rec)
    # Epoch 1 is the best; 2 and 3 do not improve on it: stop after epoch 3.
    assert [h["epoch"] for h in trainer.history] == [0, 1, 2, 3]
    assert trainer.history[-1]["early_stopped"] == 2 and state.step == 4 * steps
    assert rec.saves == [(e, (e + 1) * steps) for e in range(4)]
    assert rec.preempted == [(e, i) for e in range(4) for i in range(1, steps + 1)]
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 1 and traces[0].endswith(".json")
    assert all(h["lr"] == 1e-2 for h in trainer.history)

    # A non-finite epoch loss halts before validation and saving.
    halted = _trainer(3)
    monkeypatch.setattr(halted, "_dispatch_step",
                        lambda state, item: (state, {"loss": torch.tensor(float("nan"))}))
    rec = _RecordingCheckpointer()
    halted.fit(train, test, checkpointer=rec)
    assert halted.history == [{**halted.history[0], "epoch": 0,
                               "halted": "non-finite train loss"}]
    assert rec.saves == []
    halted.config.accum_steps = steps + 1
    with pytest.raises(ValueError, match="exceeds"):
        halted.fit(train, test)
