"""The port's w8a8 engine (``models/quantized_resnet.py``,
``ops/cuda/int8_conv.py``) against the JAX engine on the CPU.

Blocks (2, 1, 1, 1), as ``tests/test_quantized_resnet.py``: layer1_1 has an
identity shortcut, so both residual paths (the downsample conv and the
``sc_ratio`` rescale) run.  The JAX weights are the port backbone's own
(``convert.to_jax_variables``) with randomized BatchNorm statistics and
weights, so the fold is not an identity.

Tolerances: the float forward within 1e-5 of its largest value and the
calibration within 1e-6 relative (convolutions sum in another order in the
two frameworks); ``prepare``'s int8 weights, ``m``, ``z`` and scales bit for
bit (the same float32 operations in the same order); the int8 codes after
every block bit for bit (the convolution is exact, the epilogue the same
operations); model forecasts within 1e-5 x max|forecast| (the float head
sums in another order).
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visuelle2_tpu.cli import serve as jserve
from visuelle2_tpu.models import VocabSizes as JVocab
from visuelle2_tpu.models import build as jbuild
from visuelle2_tpu.models import quantized_resnet as jqr
from visuelle2_tpu_torch.cli import common, serve
from visuelle2_tpu_torch.cli.export import synth_batch
from visuelle2_tpu_torch.convert import load_jax_variables, to_jax_variables
from visuelle2_tpu_torch.eval import export
from visuelle2_tpu_torch.models import VocabSizes, build
from visuelle2_tpu_torch.models import quantized_resnet as qr
from visuelle2_tpu_torch.models.resnet import ResNetBackbone
from visuelle2_tpu_torch.ops.cuda import int8_conv as ic

BLOCKS = (2, 1, 1, 1)
VOCAB = (5, 6, 5, 126)
FORECAST_RTOL = 1e-5
CASES = {  # build overrides, the batch's task
    "gated_v4": (dict(output_len=12, embedding_dim=16, hidden_dim=16, image_arch="tiny"),
                 dict(demand=True, output_len=12)),
    "cross_attn_rnn_21": (dict(out_len=1, attention_dim=12, embedding_dim=16, hidden_dim=20,
                               image_arch="tiny"), dict(demand=False, output_len=1)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomize(tree, rng, path=()):
    """Weights moved by noise, BatchNorm statistics and affines made
    non-trivial, in place (as ``tests/test_quantized_resnet.py``)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _randomize(v, rng, path + (k,))
        elif path and path[0] == "batch_stats":
            tree[k] = np.abs(v + rng.random(v.shape).astype(np.float32) * 0.3)
        elif path and "bn" in path[-1] and k == "scale":
            tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            tree[k] = v + (rng.standard_normal(v.shape) * 0.05).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _backbone():
    """(port backbone, JAX variables, NHWC input)."""
    torch.manual_seed(0)
    bb = ResNetBackbone(BLOCKS)
    variables = to_jax_variables(bb)
    _randomize(variables, np.random.default_rng(11))
    load_jax_variables(bb, variables)
    x = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(np.float32)
    return bb.eval(), variables, x


@functools.lru_cache(maxsize=None)
def _jax_calib():
    bb, variables, x = _backbone()
    rec = {}
    jqr.float_forward(variables, x, BLOCKS, record=rec)
    return {k: float(v) for k, v in rec.items()}


def test_float_forward_matches_jax():
    bb, variables, x = _backbone()
    want = np.asarray(jqr.float_forward(variables, x, BLOCKS))
    got = qr.float_forward(bb, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2, 2, 2048)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_calibration_record_matches_jax():
    bb, _, x = _backbone()
    rec = {}
    qr.float_forward(bb, torch.from_numpy(x), record=rec)
    want = _jax_calib()
    assert sorted(rec) == sorted(want) and len(want) == 2 + 3 * sum(BLOCKS)
    for k, v in want.items():
        assert float(rec[k]) == pytest.approx(v, rel=1e-6), k


def _jax_conv_entries(qt):
    yield "stem", qt["stem"], 3
    for name, _w, _s, ds in jqr._block_specs(BLOCKS):
        for conv in ("conv1", "conv2", "conv3") + (("ds",) if ds else ()):
            yield f"{name}.{conv}", qt[name][conv], qt[name][conv]["qw"].shape[2]


def test_prepare_matches_jax_bit_for_bit():
    bb, variables, _ = _backbone()
    calib = _jax_calib()
    want = jqr.prepare(variables, calib, BLOCKS)
    got = qr.prepare(bb, calib)
    assert got["input_scale"] == want["input_scale"]
    assert got["out_scale"] == want["out_scale"]
    convs = 0
    for path, e, cin in _jax_conv_entries(want):
        name, _, conv = path.partition(".")
        g = got[name][conv] if conv else got[name]
        qw = ic.unpack_weight(g["w"], g["cin"], g["kernel"]).permute(2, 3, 1, 0)
        # The stem's input channels padded by zero weights (qr.STEM_CIN).
        np.testing.assert_array_equal(qw[:, :, :cin].numpy(), np.asarray(e["qw"]),
                                      err_msg=path)
        assert not qw[:, :, cin:].any()
        for k in ("m", "z"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(e[k]), err_msg=f"{path} {k}")
        assert g["cin"] == (qr.STEM_CIN if path == "stem" else cin)
        assert g["w"].shape[1] % 32 == 0
        convs += 1
    assert convs == 1 + 3 * sum(BLOCKS) + 4
    assert got["layer1_1"]["sc_ratio"] == want["layer1_1"]["sc_ratio"]
    assert got["stem"]["w"].shape == (64, 224)  # K = 7 x 7 x 4 = 196, padded to 224


def _prefixes():
    """Block tuples whose specs are the prefixes of BLOCKS' specs: the
    stem alone, then after each block."""
    out, cur = [(0, 0, 0, 0)], [0, 0, 0, 0]
    for stage, n in enumerate(BLOCKS):
        for _ in range(n):
            cur[stage] += 1
            out.append(tuple(cur))
    return out


@pytest.mark.parametrize("prefix", _prefixes(), ids=str)
def test_codes_after_every_block_equal_jax(prefix):
    bb, variables, x = _backbone()
    calib = _jax_calib()
    # out_scale 1 and float32: the codes themselves, as floats.
    jqt = dict(jqr.prepare(variables, calib, BLOCKS), blocks=prefix, out_scale=1.0)
    want = np.asarray(jqr.apply_quantized(jqt, jnp.asarray(x)))  # op by op, not jitted
    qt = dict(qr.prepare(bb, calib), blocks=prefix, out_scale=1.0)
    got = qr.apply_quantized(qr.to_device(qt, "cpu"), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert 0 < np.count_nonzero(got) < got.size  # neither dead nor saturated
    assert np.count_nonzero(got == 127) < got.size // 4


def test_w8a8_backbone_keeps_the_float_output_contract():
    bb, _, x = _backbone()
    calib = _jax_calib()
    q = qr.W8A8Backbone(bb, calib)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)  # channels_last, as the encoders give it
    ref = bb(tx)
    for dtype in (torch.float32, torch.bfloat16):
        out = q(tx.to(dtype))
        assert out.dtype == dtype and out.shape == ref.shape
        assert out.permute(0, 2, 3, 1).is_contiguous()  # NCHW view of NHWC memory
    out = q(tx)
    rel = torch.linalg.norm(out - ref) / torch.linalg.norm(ref)
    assert rel < 0.1  # random weights: the quantization error, ~0.04 in JAX's test
    q.train()
    with pytest.raises(ValueError, match="eval"):
        q(tx)


# ------------------------------------------------------------- model level

def _batch(task, seed=0, n=8, image=32):
    return synth_batch(n, image, VocabSizes(*VOCAB), seed=seed, **task)


@functools.lru_cache(maxsize=None)
def _models(name):
    kw, _ = CASES[name]
    model = build(name, device="cpu", generator=torch.Generator().manual_seed(5),
                  vocab=VocabSizes(*VOCAB), **kw)
    variables = to_jax_variables(model)
    _randomize({"batch_stats": variables["batch_stats"]}, np.random.default_rng(2))
    load_jax_variables(model, variables)
    return model.eval(), jbuild(name, vocab=JVocab(*VOCAB), **kw), variables


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_w8a8_forecasts_match_jax(name):
    model, jmodel, variables = _models(name)
    task = CASES[name][1]
    batches = [_batch(task, seed=s) for s in (0, 1)]
    calib = jqr.calibrate_model(jmodel, variables, batches)
    port_calib = qr.calibrate_model(model, [_t(b) for b in batches])
    assert sorted(port_calib) == sorted(calib)
    for k, v in calib.items():
        assert port_calib[k] == pytest.approx(v, rel=1e-5), k
    qmodel = qr.quantized_model(model, calib)
    test = _batch(task, seed=7)
    with torch.inference_mode():
        got = qmodel(_t(test))[0].numpy()
        ref = model(_t(test))[0].numpy()
    want, _ = jqr.quantized_apply_fn(jmodel, calib)(variables, test)  # op by op
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= FORECAST_RTOL * np.abs(want).max()
    assert not np.array_equal(got, ref)  # the int8 path ran
    # The float model is untouched: its backbones are still ResNets.
    assert any(isinstance(m, ResNetBackbone) for m in model.modules())
    assert not any(isinstance(m, ResNetBackbone) for m in qmodel.modules())


def test_model_w8a8_is_eval_only_and_needs_a_resnet():
    model, _, _ = _models("gated_v4")
    task = CASES["gated_v4"][1]
    calib = qr.calibrate_model(model, [_t(_batch(task))])
    qmodel = qr.quantized_model(model, calib).train()
    with pytest.raises(ValueError, match="eval"):
        qmodel(_t(_batch(task)))
    no_img = build("gated_v4", device="cpu", vocab=VocabSizes(*VOCAB), use_img=False,
                   **CASES["gated_v4"][0]).eval()
    with pytest.raises(ValueError, match="ResNet"):
        qr.build_serving_path(no_img, [_t(_batch(task))])


def test_calibration_merges_batches():
    model, _, _ = _models("gated_v4")
    task = CASES["gated_v4"][1]
    b1, b2 = _t(_batch(task, seed=3)), _t(_batch(task, seed=9))
    c1, c2 = qr.calibrate_model(model, [b1]), qr.calibrate_model(model, [b2])
    merged = qr.calibrate_model(model, [b1, b2])
    assert merged == {k: max(c1[k], c2[k]) for k in merged}
    assert not model.training  # calibration leaves the mode as it was


# -------------------------------------------------------------- the rules

@pytest.mark.parametrize("duplication,has_resnet", [(1.0, True), (4.0, True), (10.0, True),
                                                    (1.0, False)])
def test_auto_policy(duplication, has_resnet):
    want = "w8a8" if has_resnet and duplication <= qr.W8A8_AUTO_MAX_DUPLICATION else ""
    assert qr.resolve_auto_mode(duplication=duplication,
                                has_resnet_backbone=has_resnet) == want


class _Loader:
    def __init__(self, batch_size, unique_image_slots, image_slots=None):
        self.batch_size = batch_size
        self.unique_image_slots = unique_image_slots
        self.image_slots = image_slots or unique_image_slots


def _args(**kw):
    return type("Args", (), {"quantize": "auto", "use_img": 1, "image_arch": "resnet101",
                             **kw})()


def test_resolve_quantize(capsys, monkeypatch):
    for mode in ("", "none"):
        assert common.resolve_quantize(_args(quantize=mode), _Loader(128, 32)) == ""
    for mode in ("int8", "w8a8"):
        assert common.resolve_quantize(_args(quantize=mode), _Loader(128, 32)) == mode
    # auto reads the true duplication (unique slots, not the padded count)
    monkeypatch.setattr(qr, "W8A8_AUTO_MAX_DUPLICATION", 4.0)
    assert common.resolve_quantize(_args(), _Loader(128, 32, image_slots=40)) == "w8a8"
    assert "[quantize auto] duplication=4.0 (batch 128 / 32 unique images)" in \
        capsys.readouterr().out
    assert common.resolve_quantize(_args(), _Loader(128, 13)) == ""
    assert common.resolve_quantize(_args(), _Loader(128, 0)) == "w8a8"  # no dedup: d = 1
    assert common.resolve_quantize(_args(image_arch="tiny"), _Loader(128, 0)) == ""
    assert common.resolve_quantize(_args(use_img=0), _Loader(128, 0)) == ""
    monkeypatch.setattr(qr, "W8A8_AUTO_MAX_DUPLICATION", 0.0)
    assert common.resolve_quantize(_args(), _Loader(128, 0)) == ""
    assert "-> float path" in capsys.readouterr().out


def test_dedup_advisory_matches_jax_rule(monkeypatch):
    header = {"quantize": "w8a8"}
    monkeypatch.setattr(qr, "W8A8_AUTO_MAX_DUPLICATION", 4.0)
    monkeypatch.setattr(jqr, "W8A8_AUTO_MAX_DUPLICATION", 4.0)
    for bs, slots in ((128, 32), (128, 13), (128, 0), (16, 4)):
        got = serve.w8a8_dedup_advisory(header, bs, slots)
        want = jserve.w8a8_dedup_advisory(header, bs, slots)
        assert (got is None) == (want is None), (bs, slots)
    assert serve.w8a8_dedup_advisory({"quantize": "int8"}, 128, 13) is None
    assert "image duplication 9.8" in serve.w8a8_dedup_advisory(header, 128, 13)


# ------------------------------------------------------------ the artifact

def test_requantizing_dequantized_int8_recovers_the_codes():
    """The JAX engine's claim (``visuelle2_tpu/eval/export.py:86-88``): a
    per-channel int8 kernel, dequantized, quantizes back to the same codes.
    The scale comes back within one float32 ulp (max|q·s| / 127 rounds
    twice), which is why a w8a8 artifact keeps the stored scales."""
    bb, _, _ = _backbone()
    convs = [m for m in bb.modules() if isinstance(m, torch.nn.Conv2d)]
    ulps = []
    for conv in convs:
        q, s = qr._qweight(conv.weight)
        deq = q.float() * s[:, None, None, None]
        q2, s2 = qr._qweight(deq)
        assert torch.equal(q2, q)
        assert torch.equal(qr._qweight(deq, s)[0], q)
        ulps.append(int((s2.view(torch.int32) - s.view(torch.int32)).abs().max()))
    assert max(ulps) <= 1


def test_w8a8_artifact_reloads_to_the_same_forecasts(tmp_path):
    model, _, _ = _models("gated_v4")
    task = CASES["gated_v4"][1]
    calib = qr.calibrate_model(model, [_t(_batch(task, seed=s)) for s in (0, 1)])
    qmodel = qr.quantized_model(model, calib)
    example = _batch(task, seed=4)
    path = str(tmp_path / "w.v2torch")
    with pytest.raises(ValueError, match="calibration"):
        export.export_forecaster(model, example, path, quantize="w8a8")
    assert not os.path.exists(path)
    export.export_forecaster(model, example, path, quantize="w8a8", calib=calib)
    fn, header = export.load_forecaster(path, device="cpu")
    assert header["quantize"] == "w8a8" and header["w8a8"]["calib"] == calib
    assert header["w8a8"]["blocks"] == {"image_encoder.backbone": [1, 1, 1, 1]}
    assert header["quantized_arrays"] == 1 + 3 * 4 + 4  # the backbone's convolutions
    with torch.inference_mode():
        want = qmodel(_t(example))[0].numpy()
    np.testing.assert_array_equal(fn(example), want)
    with open(path, "rb") as f:
        f.read(12)
        assert json.loads(f.read(int.from_bytes(f.read(8), "little")))["quantize"] == "w8a8"


# ---------------------------------------------------------- the int8 conv

def _conv_reference(x, w_oihw, stride, pad):
    """Exact int64 convolution by im2col in numpy: NHWC x, OIHW w."""
    n, h, wd, cin = x.shape
    cout, _, k, _ = w_oihw.shape
    xp = np.pad(x.astype(np.int64), ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    ho, wo = (h + 2 * pad - k) // stride + 1, (wd + 2 * pad - k) // stride + 1
    cols = np.empty((n, ho, wo, k, k, cin), np.int64)
    for ky in range(k):
        for kx in range(k):
            cols[:, :, :, ky, kx] = xp[:, ky: ky + stride * ho: stride,
                                       kx: kx + stride * wo: stride]
    wmat = w_oihw.astype(np.int64).transpose(2, 3, 1, 0).reshape(-1, cout)
    return cols.reshape(n * ho * wo, -1) @ wmat, (n, ho, wo, cout)


@pytest.mark.parametrize("epilogue", sorted(ic.EPILOGUES))
@pytest.mark.parametrize("shape", [
    (2, 17, 19, 3, 64, 7, 2, 3),     # the stem: K = 147, padded to 160
    (2, 17, 19, 4, 64, 7, 2, 3),     # the stem as launched, padded to 4 channels
    (2, 9, 9, 64, 64, 3, 1, 1), (2, 10, 10, 32, 128, 3, 2, 1),
    (1, 8, 8, 48, 96, 1, 2, 0), (3, 5, 5, 16, 8, 1, 1, 0)], ids=str)
def test_int8_conv_plain_equals_an_integer_reference(shape, epilogue):
    n, h, wd, cin, cout, k, stride, pad = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(-127, 128, (n, h, wd, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (cout, cin, k, k)).astype(np.int8)
    acc, out_shape = _conv_reference(x, w, stride, pad)
    scale = 60.0 / acc.std()
    m = (rng.uniform(0.5, 1.5, cout) * scale).astype(np.float32)
    z = rng.uniform(-20, 60, cout).astype(np.float32)
    addend = rng.uniform(-30, 30, out_shape).astype(np.float32)
    shortcut = rng.integers(0, 128, out_shape).astype(np.int8)
    ratio = np.float32(rng.uniform(0.2, 0.5))
    f = acc.reshape(out_shape).astype(np.float32) * m + z  # float32: multiply, then add
    if epilogue == "float":
        want = f
    else:
        if epilogue == "requant_add":
            f = f + addend
        elif epilogue == "requant_add_identity":
            f = f + shortcut.astype(np.float32) * ratio
        want = np.clip(np.rint(f), 0, 127).astype(np.int8)
    operands = {"requant_add": dict(addend=torch.from_numpy(addend)),
                "requant_add_identity": dict(shortcut=torch.from_numpy(shortcut),
                                             ratio=torch.tensor(ratio))}.get(epilogue, {})
    got = ic.int8_conv(torch.from_numpy(x), ic.pack_weight(torch.from_numpy(w)),
                       torch.from_numpy(m), torch.from_numpy(z), kernel=k, stride=stride,
                       pad=pad, epilogue=epilogue, **operands)
    assert got.dtype == (torch.float32 if epilogue == "float" else torch.int8)
    np.testing.assert_array_equal(got.numpy(), want)
    if epilogue != "float":
        assert 0 < np.count_nonzero(want) and np.count_nonzero(want == 127) < want.size // 2


@pytest.mark.parametrize("seed", [0, 1])
def test_identity_epilogue_equals_requant_add_of_the_rescaled_codes(seed):
    """The identity shortcut's epilogue gives the bits of the float32 addend
    it replaces, ``requantize(acc, m, z, "requant_add", q.float() * ratio)``,
    on codes that include 0 and 127 and sums that land on halves."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 128, (2, 6, 7, 32)).astype(np.int8))
    w = ic.pack_weight(torch.from_numpy(rng.integers(-127, 128, (64, 32, 1, 1))
                                        .astype(np.int8)))
    q = rng.integers(0, 128, (2, 6, 7, 64)).astype(np.int8)
    q.reshape(-1)[:2] = (0, 127)
    shortcut = torch.from_numpy(q)
    # m and z powers of two, ratio 0.5 or 1.5: acc·m + z + q·ratio is exact
    # and lands on .5 where q is odd, so rint's halves to even are exercised.
    m = torch.full((64,), 2.0 ** -9)
    z = torch.from_numpy(rng.integers(-8, 8, 64).astype(np.float32))
    for ratio in (0.5, 1.5, float(np.float32(rng.uniform(0.1, 2.0)))):
        r = torch.tensor(ratio, dtype=torch.float32)
        got = ic.int8_conv(x, w, m, z, kernel=1, stride=1, pad=0,
                           epilogue="requant_add_identity", shortcut=shortcut, ratio=r)
        acc = ic.int8_conv_plain(x, w, torch.ones(64), torch.zeros(64), kernel=1, stride=1,
                                 pad=0, epilogue="float").round().to(torch.int32)
        want = ic.requantize(acc, m, z, "requant_add", shortcut.float() * r)
        assert got.dtype == torch.int8 and torch.equal(got, want)
        f = (acc.float() * m + z + shortcut.float() * r)
        assert ((f - f.floor()) == 0.5).any() or ratio not in (0.5, 1.5)
        assert (got == 0).any() and (got == 127).any()


def test_int8_conv_refusals():
    x = torch.zeros(1, 4, 4, 16, dtype=torch.int8)
    w = ic.pack_weight(torch.zeros(64, 16, 3, 3, dtype=torch.int8))
    mz = torch.zeros(64)
    with pytest.raises(ValueError, match="epilogue"):
        ic.int8_conv(x, w, mz, mz, kernel=3, stride=1, pad=1, epilogue="relu")
    with pytest.raises(ValueError, match="K_pad"):
        ic.int8_conv(x, w, mz, mz, kernel=1, stride=1, pad=0, epilogue="requant")
    with pytest.raises(ValueError, match="addend"):
        ic.int8_conv(x, w, mz, mz, kernel=3, stride=1, pad=1, epilogue="requant_add")
    with pytest.raises(ValueError, match="int8"):
        ic.int8_conv(x.float(), w, mz, mz, kernel=3, stride=1, pad=1, epilogue="requant")
    # The identity epilogue: its shortcut and ratio, both, and only with it.
    sc, ratio = torch.zeros(1, 4, 4, 64, dtype=torch.int8), torch.tensor(0.5)
    identity = dict(kernel=3, stride=1, pad=1, epilogue="requant_add_identity")
    with pytest.raises(ValueError, match="shortcut"):
        ic.int8_conv(x, w, mz, mz, ratio=ratio, **identity)  # no shortcut
    with pytest.raises(ValueError, match="shortcut"):
        ic.int8_conv(x, w, mz, mz, shortcut=sc, **identity)  # no ratio
    with pytest.raises(ValueError, match="shortcut must be int8"):
        ic.int8_conv(x, w, mz, mz, shortcut=sc.float(), ratio=ratio, **identity)
    with pytest.raises(ValueError, match="shortcut must be int8"):
        ic.int8_conv(x, w, mz, mz, shortcut=sc[..., :32], ratio=ratio, **identity)
    for bad in (0.5, torch.tensor(0.5, dtype=torch.float64), torch.tensor([0.5])):
        with pytest.raises(ValueError, match="ratio must be a float32 scalar"):
            ic.int8_conv(x, w, mz, mz, shortcut=sc, ratio=bad, **identity)
    with pytest.raises(ValueError, match="shortcut"):
        ic.int8_conv(x, w, mz, mz, kernel=3, stride=1, pad=1, epilogue="requant",
                     shortcut=sc, ratio=ratio)
    launches = ic.int8_conv.launches
    ic.int8_conv(x, w, mz, mz, kernel=3, stride=1, pad=1, epilogue="requant")
    ic.int8_conv(x, w, mz, mz, shortcut=sc, ratio=ratio, **identity)
    ic.int8_conv(torch.zeros(1, 9, 9, 12, dtype=torch.int8),  # the CPU takes any Cin and K
                 ic.pack_weight(torch.zeros(64, 12, 11, 11, dtype=torch.int8)), mz, mz,
                 kernel=11, stride=1, pad=5, epilogue="requant")
    assert ic.int8_conv.launches == launches  # the CPU runs the plain version


@pytest.mark.parametrize("cout, kernel, stride, epilogue, want", [
    (256, 3, 1, "requant", (256, True)),       # a 3x3 conv: 128 x 256 tiles, shared
    (1024, 1, 2, "float", (256, True)),        # a strided downsample conv
    (1024, 1, 1, "requant_add_identity", (128, True)),   # a conv3
    (192, 1, 1, "requant", (64, True)),        # 192: only 64 divides it
    (64, 3, 1, "requant", (64, False)),        # layer 1's 3x3: 256 x 64 in turns
    (64, 7, 2, "requant", (64, False))])       # the stem: likewise
def test_launch_plan(cout, kernel, stride, epilogue, want):
    assert ic.launch_plan(cout, kernel, stride, epilogue) == want
    with pytest.raises(ValueError, match="multiple of 64"):
        ic.launch_plan(96, kernel, stride, epilogue)


def test_launch_plan_returns_a_tiling_the_kernel_has():
    """Every plan ``launch_plan`` gives, for ResNet-101's launches and a grid
    of other shapes, is one of the kernel's instantiations (``TILE_PLANS``):
    ping-pong only at BN = 64, TMA never at 256."""
    from visuelle2_tpu_torch.models.resnet import STAGE_BLOCKS

    shapes = {c[3:] for c in qr.conv_launches(STAGE_BLOCKS["resnet101"], 299)}
    shapes |= {(cin, cout, k, s, p, e) for cin in (4, 16, 64) for cout in (64, 192, 256, 512)
               for k, p in ((1, 0), (3, 1), (7, 3)) for s in (1, 2) for e in ic.EPILOGUES}
    assert len(shapes) > 100
    for cin, cout, k, stride, pad, epilogue in shapes:
        plan = ic.launch_plan(cout, k, stride, epilogue)
        assert plan in ic.TILE_PLANS[ic.producer_mode(cin, k, stride, pad)], (cin, cout, k)


def test_stem_work_leaves_out_its_zero_channel():
    """The stem's bound and its counted operations are a 3-channel conv's:
    ``roofline.int8_conv_cost`` at ``IMAGE_CIN``; ``int8_conv`` takes the
    zero channels' count as ``pad_channels`` and refuses one outside
    0..Cin - 1."""
    from visuelle2_tpu_torch.ops.cuda import roofline

    rows = 128 * 150 * 150
    n_bytes, ops = roofline.int8_conv_cost(128, 299, 299, qr.IMAGE_CIN, 64, 7, 2, 3, "requant")
    assert ops == 2 * rows * 64 * 147
    assert n_bytes == 128 * 299 * 299 * 3 + 64 * 147 + 8 * 64 + rows * 64
    x = torch.zeros(1, 9, 9, qr.STEM_CIN, dtype=torch.int8)
    w = ic.pack_weight(torch.zeros(64, qr.STEM_CIN, 7, 7, dtype=torch.int8))
    mz = torch.zeros(64)
    stem = dict(kernel=7, stride=2, pad=3, epilogue="requant")
    assert torch.equal(ic.int8_conv(x, w, mz, mz, pad_channels=1, **stem),
                       ic.int8_conv(x, w, mz, mz, **stem))
    for bad in (-1, qr.STEM_CIN):
        with pytest.raises(ValueError, match="pad_channels"):
            ic.int8_conv(x, w, mz, mz, pad_channels=bad, **stem)


def test_conv_launches_name_what_the_kernel_is_given():
    """ResNet-101's 104 launches: the stem on 4 channels, 29 identity conv3s
    on their int8 shortcut, 4 with the downsample's float one: 28 distinct
    shapes.  ResNet-50 makes 53."""
    from visuelle2_tpu_torch.models.resnet import STAGE_BLOCKS

    launches = qr.conv_launches(STAGE_BLOCKS["resnet101"], 299)
    epilogues = [c[-1] for c in launches]
    assert len(launches) == 104 and len({c[1:] for c in launches}) == 28
    assert launches[0][1:] == (299, 299, qr.STEM_CIN, 64, 7, 2, 3, "requant")
    assert epilogues.count("requant_add_identity") == 29
    assert epilogues.count("requant_add") == epilogues.count("float") == 4
    assert len(qr.conv_launches(STAGE_BLOCKS["resnet50"], 299)) == 53


def test_w8a8_trained_tool_runs_at_a_tiny_size(tmp_path):
    """``perf/w8a8_trained.py --smoke``: train_dl, forecast_dl float and
    w8a8 on one checkpoint, and the rel-L2 between the two paths."""
    from visuelle2_tpu_torch.perf import w8a8_trained

    out = tmp_path / "r.json"
    res = w8a8_trained.main(["--smoke", "--workdir", str(tmp_path / "w"), "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert res["card"] == "cpu" and res["w8a8"]["wape"] != res["float"]["wape"]
    assert 0 < res["forecast_rel_l2"] < 0.2
    assert any(x.startswith("[w8a8] int8 backbone") for x in res["log_tail"])


def test_int8_split_variants_apply_to_the_kernel_source():
    """perf/int8_split.py's variants each edit csrc/int8_conv.cu (every edit
    found, each variant a different source), and a source that lost a line
    a variant replaces is refused."""
    from visuelle2_tpu_torch.perf import int8_split, variants

    text = int8_split.SOURCE.read_text()
    sources = variants.variant_sources(text, int8_split.VARIANTS, int8_split.SOURCE)
    assert set(sources) == set(int8_split.VARIANTS) and sources["whole"] == text
    assert len(set(sources.values())) == len(sources)
    old, _ = int8_split.VARIANTS["no_epilogue"][0]
    with pytest.raises(RuntimeError, match="no_epilogue"):
        variants.variant_sources(text.replace(old, ""), int8_split.VARIANTS, int8_split.SOURCE)
