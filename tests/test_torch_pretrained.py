"""The port's pretrained-backbone splice on the CPU against the JAX package's:
the npz codec, ``splice_backbone`` into gated_v4, gtm_v1's frozen tower and
the legacy InceptionV3 encoder, its refusals, and the two train CLIs'
``--pretrained_backbone``.

The npz is made as ``tests/test_pretrained.py`` makes one: a random-weight
torchvision-layout net converted by the JAX package's converters and written
by ``scripts/convert_pretrained.py``.  Both packages splice it into the same
weights (the port model's, as a flax tree for the JAX model); the spliced
trees must be equal bit for bit and the forwards within 1e-4, a whole f32
forward's tolerance.  Small sizes: tiny backbone at 32², E = H = 16, B = 4;
InceptionV3 at 75² (its smallest input), B = 2.
"""

import os

import numpy as np
import pytest
import torch

import jax

from scripts.convert_pretrained import save_variables
from tests.test_whole_model_golden import _tiny_resnet
from tests.torch_ref import TorchInception3
from visuelle2_tpu.models import VocabSizes as JVocab
from visuelle2_tpu.models import build as jbuild
from visuelle2_tpu.models import pretrained as jpretrained
from visuelle2_tpu.models.gtm_v1 import GTMv1 as JGTMv1
from visuelle2_tpu.models.inception import inception_params_from_torch
from visuelle2_tpu.models.legacy import LegacyImageEncoder as JLegacyImageEncoder
from visuelle2_tpu.models.resnet import params_from_torch
from visuelle2_tpu_torch.cli import train_dl, train_transformer
from visuelle2_tpu_torch.convert import to_jax_variables
from visuelle2_tpu_torch.data.synthetic import make_synthetic_dataset
from visuelle2_tpu_torch.models import VocabSizes, build, legacy
from visuelle2_tpu_torch.models import pretrained
from visuelle2_tpu_torch.models.registry import init_parameters

ATOL = 1e-4
VOCAB = (5, 6, 5, 126)
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
def resnet_npz(tmp_path_factory):
    torch.manual_seed(0)
    path = str(tmp_path_factory.mktemp("npz") / "tiny.npz")
    save_variables(params_from_torch(_tiny_resnet().state_dict(), arch="tiny"), path)
    return path


def _batch(n=4, image=32, seed=0, text=False):
    rng = np.random.default_rng(seed)
    b = {"ts": rng.random((n, 12)).astype(np.float32),
         "cat": rng.integers(0, 5, n).astype(np.int32),
         "col": rng.integers(0, 6, n).astype(np.int32),
         "fab": rng.integers(0, 5, n).astype(np.int32),
         "store": rng.integers(0, 126, n).astype(np.int32),
         "temporal": rng.random((n, 4)).astype(np.float32),
         "gtrends": rng.random((n, 3, 52)).astype(np.float32),
         "images": rng.integers(0, 255, (n, image, image, 3)).astype(np.uint8),
         "mask": np.ones((n,), np.float32)}
    if text:
        b["text_features"] = rng.random((n, 768)).astype(np.float32)
    return b


def _flat(tree):
    return pretrained.flatten_variables(tree)


def _assert_same_trees(got, want):
    got, want = _flat(got), _flat({k: want[k] for k in ("params", "batch_stats")})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_npz_codec_matches_jax(resnet_npz, tmp_path):
    mine = pretrained.load_backbone_npz(resnet_npz)
    theirs = jpretrained.load_backbone_npz(resnet_npz)
    _assert_same_trees(mine, theirs)
    # The port's writer, read back by the JAX reader.
    again = str(tmp_path / "again.npz")
    pretrained.save_backbone_npz(mine, again)
    _assert_same_trees(mine, jpretrained.load_backbone_npz(again))
    flat = jpretrained.flatten_tree(theirs["params"], "params")
    assert pretrained.flatten_tree(mine["params"], "params").keys() == flat.keys()
    assert pretrained.unflatten_tree(flat).keys() == jpretrained.unflatten_tree(flat).keys()


def _gated_v4():
    port = build("gated_v4", device="cpu", generator=torch.Generator().manual_seed(3),
                 vocab=VocabSizes(*VOCAB), output_len=12, embedding_dim=16, hidden_dim=16,
                 image_arch="tiny")
    jm = jbuild("gated_v4", vocab=JVocab(*VOCAB), output_len=12, embedding_dim=16,
                hidden_dim=16, image_arch="tiny")
    return port, jm.apply, _batch()


def _gtm_v1():
    port = build("gtm_v1", device="cpu", generator=torch.Generator().manual_seed(4),
                 output_len=12, embedding_dim=16, hidden_dim=16, image_arch="tiny")
    jm = JGTMv1(embedding_dim=16, hidden_dim=16, output_len=12, image_arch="tiny")
    return port, jm.apply, _batch(text=True)


@pytest.mark.parametrize("make", [_gated_v4, _gtm_v1], ids=["gated_v4", "gtm_v1"])
def test_splice_matches_jax(resnet_npz, make):
    port, japply, batch = make()
    variables = to_jax_variables(port)
    with torch.inference_mode():
        before = port({k: torch.from_numpy(v) for k, v in batch.items()})[0].numpy()
    want_vars = jpretrained.splice_backbone(variables, jpretrained.load_backbone_npz(resnet_npz))
    assert pretrained.splice_backbone(port, pretrained.load_backbone_npz(resnet_npz)) is port
    _assert_same_trees(to_jax_variables(port), want_vars)
    want, _ = jax.jit(lambda v, b: japply(v, b, train=False))(want_vars, batch)
    with torch.inference_mode():
        got = port({k: torch.from_numpy(v) for k, v in batch.items()})[0].numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    assert np.isfinite(got).all() and not np.allclose(got, before)


def test_splice_into_the_legacy_inception_matches_jax(tmp_path):
    """torchvision's InceptionV3 layout, its AuxLogits dropped by the JAX
    converter, spliced into the legacy patch encoder's backbone."""
    torch.manual_seed(0)
    path = str(tmp_path / "inception.npz")
    save_variables(inception_params_from_torch(TorchInception3().state_dict()), path)
    enc = legacy.LegacyImageEncoder(8)
    init_parameters(enc, torch.Generator().manual_seed(5))
    enc.eval()
    variables = to_jax_variables(enc)
    want_vars = jpretrained.splice_backbone(variables, jpretrained.load_backbone_npz(path))
    pretrained.splice_backbone(enc, pretrained.load_backbone_npz(path))
    _assert_same_trees(to_jax_variables(enc), want_vars)
    images = np.random.default_rng(6).integers(0, 256, (2, 75, 75, 3), dtype=np.uint8)
    want = jax.jit(JLegacyImageEncoder(8).apply)(want_vars, images)
    with torch.inference_mode():
        got = enc(torch.from_numpy(images))
    assert got.shape == (2, 1, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_splice_refuses_an_ablated_or_mismatched_backbone(resnet_npz):
    bb = pretrained.load_backbone_npz(resnet_npz)
    no_img = build("gtm", device="cpu", vocab=VocabSizes(*VOCAB), output_len=12, use_img=False,
                   embedding_dim=16, hidden_dim=16, image_arch="tiny")
    with pytest.raises(ValueError, match="no 'backbone'"):
        pretrained.splice_backbone(no_img, bb)
    # Another arch: the leaves it lacks and has are named.
    wide = build("gtm", device="cpu", vocab=VocabSizes(*VOCAB), output_len=12,
                 embedding_dim=16, hidden_dim=16, image_arch="resnet50")
    with pytest.raises(ValueError, match=r"does not match.*missing/extra=\['batch_stats/"):
        pretrained.splice_backbone(wide, bb)
    # The same leaves at other shapes: named too, and nothing is loaded.
    port = build("gtm", device="cpu", vocab=VocabSizes(*VOCAB), output_len=12,
                 embedding_dim=16, hidden_dim=16, image_arch="tiny")
    before = {k: v.clone() for k, v in port.state_dict().items()}
    bad = {"params": jax.tree_util.tree_map(lambda x: x[..., :1], bb["params"]),
           "batch_stats": bb["batch_stats"]}
    with pytest.raises(ValueError,
                       match=r"missing/extra=\[\] shape-mismatched=\[.*'params/conv1/kernel'"):
        pretrained.splice_backbone(port, bad)
    assert all(torch.equal(v, before[k]) for k, v in port.state_dict().items())
    # A tree without statistics keeps the model's own, as the JAX splice does.
    pretrained.splice_backbone(port, {"params": bb["params"]})
    got = _flat(to_jax_variables(port.image_encoder.backbone))
    for k, v in _flat({"params": bb["params"]}).items():
        np.testing.assert_array_equal(got[k], v)
    assert np.array_equal(got["batch_stats/bn1/var"], before[
        "image_encoder.backbone.bn1.running_var"].numpy())


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    # Eight train rows: one step at batch 8.
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("vis2")), num_train=8,
                                  num_test=8, image_size=32)


@pytest.mark.parametrize("cli", ["train_transformer", "train_dl"])
def test_train_clis_start_from_the_npz(dataset, resnet_npz, tmp_path, capsys, cli):
    """One step from the npz's backbone: its frozen stem (the JAX freeze
    split) is the npz's own bits in the saved state."""
    ck = str(tmp_path / "ck")
    if cli == "train_transformer":
        main, family, prefix = (train_transformer.main, ["--model", "gated_v4"],
                                "image_encoder.backbone.")
    else:
        main, family, prefix = (train_dl.main, ["--demand", "1", "--attention_dim", "16"],
                                "static.image_encoder.backbone.")
    argv = ["--dataset_path", dataset, *SMALL, *family, "--epochs", "1", "--ckpt_dir", ck,
            "--pretrained_backbone"]
    main(argv + [resnet_npz])
    assert f"loaded pretrained backbone from {resnet_npz}" in capsys.readouterr().out
    state = torch.load(os.path.join(ck, "last", "state.pt"), map_location="cpu",
                       weights_only=True)
    assert state["step"] == 1
    npz = pretrained.load_backbone_npz(resnet_npz)["params"]
    want = np.transpose(npz["conv1"]["kernel"], (3, 2, 0, 1))  # HWIO -> OIHW
    np.testing.assert_array_equal(state["model"][prefix + "conv1.weight"].numpy(), want)
    np.testing.assert_array_equal(state["model"][prefix + "layer1_0.conv1.weight"].numpy(),
                                  np.transpose(npz["layer1_0"]["conv1"]["kernel"], (3, 2, 0, 1)))
    # A file that is not there is an error, before any training.
    with pytest.raises(FileNotFoundError, match="nothing.npz"):
        main(argv + [str(tmp_path / "nothing.npz")])
