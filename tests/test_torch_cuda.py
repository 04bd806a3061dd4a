"""The port on the card: the CUDA kernels against their plain versions, no
fallback on CUDA tensors, and the models on the card against the same
models on the CPU.  Every test here needs an NVIDIA GPU and skips without one.

This file imports torch and the port only, so it also runs where JAX is not
installed: ``python -m pytest tests/test_torch_cuda.py --noconftest -q``.
"""

import numpy as np
import pytest
import torch

from visuelle2_tpu_torch.models import VocabSizes, build
from visuelle2_tpu_torch.ops.cuda import _build
from visuelle2_tpu_torch.ops.cuda import additive_attention as taa
from visuelle2_tpu_torch.ops.cuda import gated_fusion as tgf
from visuelle2_tpu_torch.ops.cuda import gated_mha as tgm
from visuelle2_tpu_torch.ops.cuda import gru_seq as tgs
from visuelle2_tpu_torch.ops.cuda import probe_gemm as tpg
from visuelle2_tpu_torch.ops.cuda import read_reduce as trr
from visuelle2_tpu_torch.ops.masks import gcd_block_mask

pytestmark = pytest.mark.cuda

ATOL = 1e-5  # kernel vs plain: both f32, sums in another order
# Gated MHA and additive attention: the tolerance tests/test_pallas_kernels.py
# holds the gated-MHA Pallas kernel to (softmax after chained products, sums
# in another order).
MHA_ATOL, MHA_RTOL = 2e-5, 1e-5


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _inputs(B, D, C, seed=0):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, D)), rng.standard_normal((B, C)),
              rng.standard_normal((D, D)) * 0.1, rng.standard_normal((C, D)) * 0.1,
              rng.standard_normal(D))
    return [torch.from_numpy(a.astype(np.float32)).cuda() for a in arrays]


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("shape", [
    (128, 32, 128),   # gated_v4's TG-Fusion
    (37, 48, 96),     # ragged batch, another width
    (3, 64, 512),     # a wide context: many k-splits
    (1, 32, 128),     # one row
    (4096, 32, 128),  # four rows a CTA
    (8, 1024, 64),    # D = 1024: 8 column tiles of 128
    (128, 32, 0),     # no context
    (4, 256, 256),    # 515 KB of weights: past what the earlier design could stage
    (5, 33, 7),       # D not a multiple of 4: one column a unit
])
def test_kernel_matches_plain(residual, shape):
    arrays = _inputs(*shape)
    before = tgf.fused_gated_residual.launches
    got = tgf.fused_gated_residual(*arrays, residual=residual)
    torch.cuda.synchronize()
    assert tgf.fused_gated_residual.launches == before + 1
    want = tgf.fused_gated_residual_plain(*arrays, residual=residual)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_kernel_on_unaligned_weights_and_twice():
    """Weights at an address that is not 16-byte aligned take one column a
    unit; two calls on the same inputs give the same bits (a fixed order of
    sums, no atomics)."""
    x, ctx, wx, wc, b = _inputs(64, 32, 128)
    wx_off = torch.empty(32 * 32 + 1, device="cuda")[1:].view(32, 32)
    wx_off.copy_(wx)
    assert wx_off.data_ptr() % 16 != 0
    got = tgf.fused_gated_residual(x, ctx, wx_off, wc, b)
    again = tgf.fused_gated_residual(x, ctx, wx_off, wc, b)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, tgf.fused_gated_residual_plain(x, ctx, wx, wc, b),
                               atol=ATOL, rtol=0)


def test_kernel_rejects_what_it_cannot_take():
    x, ctx, wx, wc, b = _inputs(8, 32, 128)
    with pytest.raises(ValueError, match="contiguous"):
        tgf.fused_gated_residual(x.t().contiguous().t(), ctx, wx, wc, b)


def test_no_fallback_without_the_kernel(monkeypatch):
    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(_build, "load_library", no_library)
    tgf._kernel.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="unavailable"):
            tgf.fused_gated_residual(*_inputs(8, 32, 128))
    finally:
        tgf._kernel.cache_clear()


def _mha_inputs(B, Lq, Lk, D, heads, variant, masked, seed=0, kv="same"):
    """kv: "same" passes one tensor as key and value (and as query where
    Lq == Lk), as the model path does; "distinct" three tensors; "equal"
    three distinct tensors with equal data."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(
        (rng.standard_normal(s) * scale).astype(np.float32)).cuda()
    query = f(B, Lq, D)
    if kv == "same":
        key = value = query if Lq == Lk else f(B, Lk, D)
    elif kv == "distinct":
        key, value = f(B, Lk, D), f(B, Lk, D)
    else:
        key = query.clone() if Lq == Lk else f(B, Lk, D)
        value = key.clone()
    mask = (gcd_block_mask(Lq, 12) if masked else torch.zeros(Lq, Lk)).cuda()
    G = D // heads if variant == "head" else D
    weights = []
    for n in (D, D, D, G, D):
        weights += [f(n, n, scale=n ** -0.5), f(n, scale=0.1)]
    return [query, key, value, mask, *weights]


@pytest.mark.parametrize("variant,shape,masked,kv", [
    ("head", (128, 52, 52, 64, 4), True, "same"),    # gated_v2 trend encoder
    ("head", (128, 52, 52, 64, 4), False, "same"),
    ("pure", (128, 1, 52, 64, 4), False, "same"),    # decoder cross-attention, non-AR
    ("pure", (128, 12, 52, 64, 4), False, "same"),   # decoder cross-attention, AR
    ("pure", (37, 52, 52, 48, 4), True, "same"),     # ragged batch, another width
    ("head", (37, 12, 52, 48, 4), False, "same"),
    # one CTA a row; two, eight and sixteen heads (two a CTA) at D = 64
    ("head", (128, 52, 52, 64, 1), True, "same"),
    ("head", (128, 52, 52, 64, 2), True, "same"),
    ("head", (128, 52, 52, 64, 8), True, "same"),
    ("head", (128, 52, 52, 64, 16), True, "same"),
    ("pure", (128, 1, 52, 64, 16), False, "same"),
    ("head", (16, 52, 52, 48, 4), True, "same"),     # d = 12
    ("head", (16, 100, 100, 64, 4), True, "same"),   # Lk = 100
    ("pure", (16, 12, 100, 64, 4), False, "same"),
    ("pure", (128, 1, 52, 64, 4), False, "distinct"),
    ("head", (16, 52, 52, 64, 4), True, "equal"),    # equal data, three tensors
    ("pure", (16, 1, 52, 64, 4), False, "equal"),
    ("head", (4, 20, 30, 64, 64), False, "distinct"),  # d = 1: 8 heads a CTA
    ("head", (3, 124, 124, 64, 4), True, "same"),    # the earlier design's largest L at D = 64
    ("pure", (2, 1, 1, 4096, 1), False, "distinct"),  # unstaged: weights read in place
    ("head", (2, 9, 7, 4096, 8), False, "distinct"),
])
def test_gated_mha_kernel_matches_plain(variant, shape, masked, kv):
    B, Lq, Lk, D, heads = shape
    args = _mha_inputs(B, Lq, Lk, D, heads, variant, masked, kv=kv)
    before = tgm.fused_gated_mha.launches
    got = tgm.fused_gated_mha(*args, num_heads=heads, variant=variant)
    torch.cuda.synchronize()
    assert tgm.fused_gated_mha.launches == before + 1
    want = tgm.fused_gated_mha_plain(*args, num_heads=heads, variant=variant)
    torch.testing.assert_close(got, want, atol=MHA_ATOL, rtol=MHA_RTOL)


@pytest.mark.parametrize("variant", ["head", "pure"])
def test_gated_mha_fully_masked_row_and_same_bits(variant):
    """A query row whose keys are all masked gives NaN in both the kernel and
    the plain version (softmax over -inf), and the other rows agree; two
    calls give the same bits (the cluster sums its partials in rank order,
    no atomics)."""
    args = _mha_inputs(16, 12, 52, 64, 4, variant, False, kv="distinct")
    args[3][5] = float("-inf")
    before = tgm.fused_gated_mha.launches
    got = tgm.fused_gated_mha(*args, num_heads=4, variant=variant)
    again = tgm.fused_gated_mha(*args, num_heads=4, variant=variant)
    torch.cuda.synchronize()
    assert tgm.fused_gated_mha.launches == before + 2
    want = tgm.fused_gated_mha_plain(*args, num_heads=4, variant=variant)
    assert torch.isnan(want[:, 5]).all() and not torch.isnan(want[:, :5]).any()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(got, want, atol=MHA_ATOL, rtol=MHA_RTOL, equal_nan=True)
    assert torch.equal(got.nan_to_num(), again.nan_to_num())
    main = _mha_inputs(128, 52, 52, 64, 4, "head", True)
    assert torch.equal(tgm.fused_gated_mha(*main, num_heads=4, variant="head"),
                       tgm.fused_gated_mha(*main, num_heads=4, variant="head"))


def test_gated_mha_no_fallback_without_the_kernel(monkeypatch):
    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(_build, "load_library", no_library)
    tgm._kernel.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="unavailable"):
            tgm.fused_gated_mha(*_mha_inputs(4, 52, 52, 64, 4, "head", True),
                                num_heads=4, variant="head")
    finally:
        tgm._kernel.cache_clear()


def test_gated_v2_on_card_matches_cpu():
    """gated_v2 (tiny backbone, f32) launches the gated-MHA kernel three
    times per forward on the card and matches the CPU plain path."""
    kw = dict(image_arch="tiny", vocab=VocabSizes(5, 6, 5, 126))
    model = build("gated_v2", **kw)
    cpu = build("gated_v2", device="cpu", **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    tb = {k: torch.from_numpy(v) for k, v in _batch(6).items()}
    before = tgm.fused_gated_mha.launches
    with torch.inference_mode():
        on_card = model({k: v.cuda() for k, v in tb.items()})[0].cpu()
        on_cpu = cpu(tb)[0]
    assert tgm.fused_gated_mha.launches == before + 3
    torch.testing.assert_close(on_card, on_cpu, atol=1e-4, rtol=0)


def _batch(n, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "ts": rng.random((n, 12)).astype(np.float32),
        "cat": rng.integers(0, 5, n), "col": rng.integers(0, 6, n),
        "fab": rng.integers(0, 5, n), "store": rng.integers(0, 126, n),
        "temporal": rng.random((n, 4)).astype(np.float32),
        "gtrends": rng.random((n, 3, 52)).astype(np.float32),
        "images": rng.integers(0, 255, (n, 64, 64, 3)).astype(np.uint8),
    }


def test_slice_on_card_matches_cpu():
    """gated_v4 (tiny backbone, f32) built without a device lands on the card,
    launches the kernel twice per forward, and matches the CPU plain path."""
    kw = dict(image_arch="tiny", vocab=VocabSizes(5, 6, 5, 126))
    model = build("gated_v4", **kw)
    assert next(model.parameters()).is_cuda
    cpu = build("gated_v4", device="cpu", **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    tb = {k: torch.from_numpy(v) for k, v in _batch(6).items()}
    before = tgf.fused_gated_residual.launches
    with torch.inference_mode():
        on_card = model({k: v.cuda() for k, v in tb.items()})[0].cpu()
        on_cpu = cpu(tb)[0]
    assert tgf.fused_gated_residual.launches == before + 2
    # f32 on both; the card's cuDNN/cuBLAS sum in another order (TF32 off).
    torch.testing.assert_close(on_card, on_cpu, atol=1e-4, rtol=0)


def _additive_inputs(B, L, De, Dd, A, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(
        (rng.standard_normal(s) * scale).astype(np.float32)).cuda()
    return [f(B, L, De), f(B, Dd), f(De, A, scale=De ** -0.5), f(Dd, A, scale=Dd ** -0.5),
            f(A, 1, scale=A ** -0.5), f(1)]


@pytest.mark.parametrize("weight_on", ["inputs", "projected"])
@pytest.mark.parametrize("shape", [
    (128, 100, 512, 512, 512),   # Demand: image patches
    (128, 52, 512, 512, 512),    # trend steps
    (128, 4, 512, 512, 512),     # fused tokens
    (37, 13, 48, 40, 24),        # ragged batch, De ≠ Dd ≠ A
    (5, 2, 16, 20, 16),          # two tokens (ablations)
    (3, 150, 32, 16, 80),        # more rows than one tile, A not a multiple of 64
    (3, 7, 13, 9, 70),           # De not a multiple of the 32-deep slice
    (23, 100, 40, 24, 200),      # the large tile: rows and A not multiples of 128
])
def test_additive_attention_kernel_matches_plain(weight_on, shape):
    """Against the plain version, in at most two kernel launches a call (the
    grouped 3xTF32 GEMM, then the energies, softmax and scaling), counted by
    the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args = _additive_inputs(*shape)
    before = taa.fused_additive_attention.launches
    for calls in range(1, 4):  # the profiler can keep no record of a short window
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = taa.fused_additive_attention(*args, weight_on=weight_on)
            torch.cuda.synchronize()
        records = [(e.key, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.count]
        if records:
            break
    assert taa.fused_additive_attention.launches == before + calls
    assert 1 <= sum(n for _, n in records) <= 2, records
    want = taa.fused_additive_attention_plain(*args, weight_on=weight_on)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=MHA_ATOL, rtol=MHA_RTOL)


@pytest.mark.parametrize("bn", [32, 64, 104, 128])
@pytest.mark.parametrize("weight_on", ["inputs", "projected"])
def test_additive_attention_every_tile_width(weight_on, bn):
    """Both GEMM tile widths the launch plan may pick, on ragged rows,
    columns and depths, against the plain version."""
    args = _additive_inputs(29, 13, 52, 36, 136, seed=bn)
    B, L, De = args[0].shape
    Dd, A = args[3].shape
    projected = weight_on == "projected"
    plan = dict(taa.launch_plan(B, L, De, Dd, A, projected=projected), bn=bn)
    got = taa._launch(dict(zip(("enc", "dec", "we", "wd", "v", "vb"), args)), projected, plan)
    want = taa.fused_additive_attention_plain(*args, weight_on=weight_on)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=MHA_ATOL, rtol=MHA_RTOL)


def test_additive_attention_no_fallback_without_the_kernel(monkeypatch):
    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(_build, "load_library", no_library)
    taa._kernel.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="unavailable"):
            taa.fused_additive_attention(*_additive_inputs(4, 6, 8, 8, 8))
    finally:
        taa._kernel.cache_clear()


def _gru_inputs(B, T, I, H, seed=0):
    rng = np.random.default_rng(seed)
    bound = H ** -0.5
    f = lambda *s: torch.from_numpy(rng.uniform(-bound, bound, s).astype(np.float32)).cuda()
    x = torch.from_numpy(rng.random((B, T, I)).astype(np.float32)).cuda()
    return [x, f(I, 3 * H), f(H, 3 * H), f(3 * H), f(3 * H)]


@pytest.mark.parametrize("shape,atol", [((37, 9, 5, 24), 2e-5), ((5, 4, 3, 13), 2e-5),
                                        # static + dynamic shared memory over 48 KB,
                                        # the dynamic part under it
                                        ((9, 6, 3, 200), 2e-5),
                                        ((128, 52, 3, 512), 1e-4),
                                        ((7, 1, 3, 40), 2e-5),  # one step: no barrier
                                        # B not a multiple of the 32-row tile, H not
                                        # of the 16-unit slice; 13 slices x 5 tiles
                                        ((150, 6, 4, 200), 2e-5),
                                        # ten row tiles on four row groups: a block
                                        # walks over several tiles a step
                                        ((300, 4, 3, 512), 1e-4),
                                        # the streamed layout: past the resident
                                        # one's 724 (725 also takes no float4 loads),
                                        # at 1,664, and at the limit, 2,112: one
                                        # unit slice on each of an H100's 132 SMs
                                        ((128, 8, 64, 725), 1e-4),
                                        ((128, 8, 64, 1024), 1e-4),
                                        ((128, 8, 64, 1664), 1e-4),
                                        ((128, 8, 64, 2112), 1e-4)])
def test_gru_kernel_matches_plain_and_cudnn(shape, atol):
    """The recurrence kernel against the plain step loop and cuDNN's
    torch.nn.GRU (same weights, transposed).  At full width 52 steps of
    512-long sums carry the rounding forward: 1e-4 there (chip_smoke.py
    prints the measured error)."""
    args = _gru_inputs(*shape)
    before = tgs.fused_gru_sequence.launches
    outs, h_last = tgs.fused_gru_sequence(*args)
    torch.cuda.synchronize()
    assert tgs.fused_gru_sequence.launches == before + 1
    want, want_h = tgs.fused_gru_sequence_plain(*args)
    torch.testing.assert_close(outs, want, atol=atol, rtol=0)
    torch.testing.assert_close(h_last, want_h, atol=atol, rtol=0)
    x, w_i, w_h, b_i, b_h = args
    ref = tgs.cudnn_gru(w_i, w_h, b_i, b_h)
    with torch.inference_mode():
        lib, lib_h = ref(x)
    torch.testing.assert_close(outs, lib, atol=atol, rtol=0)
    torch.testing.assert_close(h_last, lib_h[0], atol=atol, rtol=0)


@pytest.mark.parametrize("shape", [(128, 52, 3, 512), (37, 9, 5, 24), (300, 4, 3, 512),
                                   (128, 8, 64, 1024)])
def test_gru_kernel_gives_the_same_bits_twice(shape):
    """The sums take no atomics and each has one order, so any difference
    between two calls on the same inputs is a race in the step barrier."""
    args = _gru_inputs(*shape)
    h0 = torch.randn(shape[0], shape[3], device="cuda")
    first = tgs.fused_gru_sequence(*args, h0=h0)
    second = tgs.fused_gru_sequence(*args, h0=h0)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_gru_kernel_in_a_cuda_graph_matches_eager():
    """Captured in a CUDA graph (the barrier's counters zeroed by a memset
    node of the graph), replayed twice on new inputs: equal to eager."""
    x, w_i, w_h, b_i, b_h = _gru_inputs(128, 52, 3, 512)
    static_x = x.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        tgs.fused_gru_sequence(static_x, w_i, w_h, b_i, b_h)  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs, h_last = tgs.fused_gru_sequence(static_x, w_i, w_h, b_i, b_h)
    for seed in (1, 2):
        new_x = _gru_inputs(128, 52, 3, 512, seed=seed)[0]
        static_x.copy_(new_x)
        graph.replay()
        want, want_h = tgs.fused_gru_sequence(new_x, w_i, w_h, b_i, b_h)
        torch.cuda.synchronize()
        assert torch.equal(outs, want) and torch.equal(h_last, want_h)


@pytest.mark.parametrize("H", [512, 1024])
def test_gru_kernel_on_two_streams_at_once(H):
    """Calls in flight on two streams at once, each grid nearly a whole card
    of blocks that meet at a barrier: the cooperative launch makes each grid
    resident as a whole or not at all, so no block spins waiting for one
    that has no SM.  Each stream's results equal the calls made alone; at
    H = 1,024 in the streamed layout."""
    inputs = [_gru_inputs(128, 52, 3, H, seed=3), _gru_inputs(300, 4, 3, H, seed=4)]
    want = [tgs.fused_gru_sequence(*a) for a in inputs]
    streams = [torch.cuda.Stream() for _ in inputs]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[] for _ in inputs]
    for _ in range(4):
        for s, a, g in zip(streams, inputs, got):
            with torch.cuda.stream(s):
                g.append(tgs.fused_gru_sequence(*a))
    torch.cuda.synchronize()
    for (outs, h_last), calls in zip(want, got):
        for o, h in calls:
            assert torch.equal(o, outs) and torch.equal(h, h_last)


def test_gru_module_kernel_path_on_card():
    """GRU(use_kernel=True) launches the kernel once per call, with h0."""
    from visuelle2_tpu_torch.ops.gru import GRU

    x, w_i, w_h, b_i, b_h = _gru_inputs(6, 11, 3, 32)
    gru = GRU(3, 32, use_kernel=True).cuda()
    with torch.no_grad():
        for p, v in zip((gru.w_i, gru.w_h, gru.b_i, gru.b_h), (w_i, w_h, b_i, b_h)):
            p.copy_(v)
    h0 = torch.randn(6, 32, device="cuda")
    before = tgs.fused_gru_sequence.launches
    with torch.inference_mode():
        outs, h_last = gru(x, h0)
    assert tgs.fused_gru_sequence.launches == before + 1
    want, want_h = tgs.fused_gru_sequence_plain(x, w_i, w_h, b_i, b_h, h0)
    torch.testing.assert_close(outs, want, atol=2e-5, rtol=0)
    torch.testing.assert_close(h_last, want_h, atol=2e-5, rtol=0)


@pytest.mark.parametrize("name,launches", [("cross_attn_rnn_demand", 36),
                                           ("cross_attn_rnn_21", 3),
                                           ("cross_attn_rnn_210", 30)])
def test_cross_attn_rnn_on_card_matches_cpu(name, launches):
    """A small model (tiny backbone, f32) on the card launches the additive
    attention kernel three times per decode step and matches the CPU."""
    kw = dict(image_arch="tiny", vocab=VocabSizes(5, 6, 5, 126), attention_dim=32,
              embedding_dim=32, hidden_dim=48)
    if name == "cross_attn_rnn_210":
        kw["out_len"] = 10
    model = build(name, **kw)
    cpu = build(name, device="cpu", **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    batch = _batch(6)
    if name != "cross_attn_rnn_demand":
        rng = np.random.default_rng(4)
        batch["X"] = rng.random((6, 2, 2)).astype(np.float32)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    before = taa.fused_additive_attention.launches
    with torch.inference_mode():
        on_card = model({k: v.cuda() for k, v in tb.items()})[0].cpu()
        on_cpu = cpu(tb)[0]
    assert taa.fused_additive_attention.launches == before + launches
    torch.testing.assert_close(on_card, on_cpu, atol=1e-4, rtol=0)


@pytest.mark.parametrize("weight_on", ["inputs", "projected"])
@pytest.mark.parametrize("shape", [(128, 100, 512, 512, 512), (128, 4, 512, 512, 512),
                                   (37, 13, 48, 40, 24)])
def test_additive_attention_under_autograd(weight_on, shape):
    """The kernel forward (2 launches, one call) and the recomputed plain
    backward (no launch) against autograd of the plain version."""
    B, L, De, Dd, A = shape
    gen = torch.Generator(device="cuda").manual_seed(7)
    args = [(torch.randn(*s, device="cuda", generator=gen) * sc).requires_grad_()
            for s, sc in (((B, L, De), 1.0), ((B, Dd), 1.0), ((De, A), De ** -0.5),
                          ((Dd, A), Dd ** -0.5), ((A, 1), A ** -0.5), ((1,), 1.0))]
    before = taa.fused_additive_attention.launches
    out, alpha = taa.fused_additive_attention(*args, weight_on=weight_on)
    assert type(out.grad_fn).__name__ == "_AdditiveAttentionBackward"
    cot = [torch.randn(t.shape, device="cuda", generator=gen) for t in (out, alpha)]
    got = torch.autograd.grad((out, alpha), args, cot)
    torch.cuda.synchronize()
    assert taa.fused_additive_attention.launches == before + 1
    want_out, want_alpha = taa.fused_additive_attention_plain(*args, weight_on=weight_on)
    want = torch.autograd.grad((want_out, want_alpha), args, cot)
    torch.testing.assert_close(out, want_out, atol=MHA_ATOL, rtol=MHA_RTOL)
    torch.testing.assert_close(alpha, want_alpha, atol=MHA_ATOL, rtol=MHA_RTOL)
    for name, g, w in zip(("enc", "dec", "we", "wd", "v", "vb"), got, want):
        torch.testing.assert_close(g, w, atol=MHA_ATOL, rtol=MHA_RTOL, msg=name)


def test_gru_sequence_under_autograd():
    """The kernel forward (one launch) and the step loop's recomputed
    backward (no launch) against autograd of the step loop, at the trend
    GRU's shape."""
    x, w_i, w_h, b_i, b_h = _gru_inputs(128, 52, 3, 512)
    weights = [t.requires_grad_() for t in (w_i, w_h, b_i, b_h)]
    before = tgs.fused_gru_sequence.launches
    outs, h_last = tgs.fused_gru_sequence(x, *weights)
    assert type(outs.grad_fn).__name__ == "_GRUSequenceBackward"
    gen = torch.Generator(device="cuda").manual_seed(8)
    cot = [torch.randn(t.shape, device="cuda", generator=gen) for t in (outs, h_last)]
    got = torch.autograd.grad((outs, h_last), weights, cot)
    torch.cuda.synchronize()
    assert tgs.fused_gru_sequence.launches == before + 1
    want = tgs.fused_gru_sequence_plain(x, *weights)
    want_grads = torch.autograd.grad(want, weights, cot)
    torch.testing.assert_close(outs, want[0], atol=1e-4, rtol=0)
    for name, g, w in zip(("w_i", "w_h", "b_i", "b_h"), got, want_grads):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4, msg=name)


def test_demand_train_step_on_card_matches_cpu():
    """A small Demand (teacher forcing at ratio 1) trained one step on the
    card and on the CPU: the same loss and gradients; 36 additive launches
    in the forward (image, trend and fused tokens, 12 steps), none in the
    backward.  The batch, of two images, is the first candidate whose CPU
    forward keeps every ReLU input of the trainable backbone blocks more
    than ``KINK_ATOL`` from zero: nearer, the two devices may give it two signs and
    take the loss's two one-sided derivatives (``chip_smoke.py``
    train_demand_parity screens its batches so too)."""
    from chip_smoke import KINK_ATOL, _relu_inputs
    from visuelle2_tpu_torch.ops import dropout
    from visuelle2_tpu_torch.train import loop
    from visuelle2_tpu_torch.train.optim import freeze_backbone

    kw = dict(image_arch="tiny", vocab=VocabSizes(5, 6, 5, 126), attention_dim=16,
              embedding_dim=16, hidden_dim=16, use_teacher_forcing=True,
              teacher_forcing_ratio=1.0)
    model = build("cross_attn_rnn_demand", **kw)
    cpu = build("cross_attn_rnn_demand", device="cpu", **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    freeze_backbone(cpu)
    stats = {k: v.clone() for k, v in cpu.state_dict().items()}
    with dropout.disabled():
        for seed in range(40):
            tb = {k: torch.from_numpy(v) for k, v in _batch(2, seed=seed).items()}
            with _relu_inputs(cpu) as seen, torch.no_grad():
                cpu.train()(tb)
            if min(x.abs().min().item() for x in seen) > KINK_ATOL:
                break
        else:
            pytest.fail("no candidate batch passed the ReLU screen")
    cpu.load_state_dict(stats)  # the screen's forwards moved the statistics
    losses, grads = [], []
    with dropout.disabled():
        for m, batch in ((model, {k: v.cuda() for k, v in tb.items()}), (cpu, tb)):
            trainer = loop.Trainer(m, loop.TrainConfig(learning_rate=1e-3))
            trainer.init_state()
            before = taa.fused_additive_attention.launches
            loss = trainer._train_loss(batch, None)
            forward = taa.fused_additive_attention.launches - before
            loss.backward()
            torch.cuda.synchronize()
            assert (forward, taa.fused_additive_attention.launches - before) == (
                (36, 36) if m is model else (0, 0))
            losses.append(loss.item())
            grads.append({n: p.grad.cpu() for n, p in m.named_parameters()
                          if p.grad is not None})
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])
    assert grads[0].keys() == grads[1].keys()
    for n, g in grads[1].items():
        torch.testing.assert_close(grads[0][n], g, atol=1e-4, rtol=1e-4, msg=n)


def _probe_inputs(m, k, n, seed=0):
    """bf16 x, w and int8 x, w with the ±127 extremes in both."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, device="cuda", generator=gen)
    w = torch.randn(k, n, device="cuda", generator=gen) * k ** -0.5
    xi = torch.randint(-127, 128, (m, k), device="cuda", generator=gen, dtype=torch.int8)
    wi = torch.randint(-127, 128, (k, n), device="cuda", generator=gen, dtype=torch.int8)
    xi[0], wi[:, 0] = 127, -127
    return x.to(torch.bfloat16), w.to(torch.bfloat16), xi, wi


PROBE_SHAPES = [
    (4096, 256, 64),      # the JAX parity check's size
    (720896, 256, 64),    # probe shape A
    (184320, 512, 128),   # probe shape B
    (10000, 128, 256),    # ragged M: the last row tile is masked
    (33, 128, 512),       # one partial tile, the widest N
]


@pytest.mark.parametrize("shape", PROBE_SHAPES)
def test_probe_gemm_bf16_matches_plain(shape):
    """Both sides round an f32 sum of the same products to bf16 once:
    within one bf16 ulp beyond the f32 sums' reordering bound."""
    x, w, _, _ = _probe_inputs(*shape)
    before = tpg.matmul_bf16.launches
    got = tpg.matmul_bf16(x, w)
    torch.cuda.synchronize()
    assert tpg.matmul_bf16.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (shape[0], shape[2])
    want = tpg.matmul_bf16_plain(x, w)
    assert bool(((got.float() - want.float()).abs()
                 <= tpg.bf16_tolerance(x, w, want)).all())


@pytest.mark.parametrize("n,k", [(64, 128), (128, 128), (256, 256), (512, 192)])
def test_probe_gemm_bf16_every_n_at_a_ragged_m(n, k):
    """Every N the wgmma kernel takes (at 512 each consumer warpgroup takes
    half of the columns of a 64-row tile), at an M that leaves a ragged last
    tile after several tiles per block of the persistent grid."""
    m = 3 * 128 * 132 + 77
    x, w, _, _ = _probe_inputs(m, k, n, seed=n)
    before = tpg.matmul_bf16.launches
    got = tpg.matmul_bf16(x, w)
    torch.cuda.synchronize()
    assert tpg.matmul_bf16.launches == before + 1
    want = tpg.matmul_bf16_plain(x, w)
    assert bool(((got.float() - want.float()).abs()
                 <= tpg.bf16_tolerance(x, w, want)).all())


@pytest.mark.parametrize("shape", PROBE_SHAPES)
def test_probe_gemm_int8_is_exact(shape):
    _, _, xi, wi = _probe_inputs(*shape)
    before = tpg.matmul_int8.launches
    got = tpg.matmul_int8(xi, wi)
    torch.cuda.synchronize()
    assert tpg.matmul_int8.launches == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, tpg.matmul_int8_plain(xi, wi))
    assert torch.equal(got, torch._int_mm(xi, wi))


@pytest.mark.parametrize("shape", [(4096, 256), (720896, 256), (184320, 512), (6144, 384),
                                   (2048, 128)])
def test_read_reduce_matches_plain_over_all_columns(shape):
    """Every column of x reaches the kernel's partials (the columns past
    128 too); 256 bf16 values summed in f32 in another order: atol 1e-4 +
    rtol 1e-5.  The bias reaches every one of the probe's partials."""
    x, _, _, _ = _probe_inputs(shape[0], shape[1], 64)
    bias = torch.randn(8, 128, device="cuda")
    before = trr.read_reduce.launches
    full = trr.read_reduce(x, bias, full_k=True)
    torch.cuda.synchronize()
    assert trr.read_reduce.launches == before + 1
    assert full.shape == (8 * shape[0] // 2048, shape[1])
    want = trr.read_reduce_plain(x, bias, full_k=True)
    torch.testing.assert_close(full, want, atol=1e-4, rtol=1e-5)
    rr, rr0 = trr.read_reduce(x, bias), trr.read_reduce(x, torch.zeros_like(bias))
    assert rr.shape == (8 * shape[0] // 2048, 128)
    torch.testing.assert_close(rr - rr0, bias.repeat(shape[0] // 2048, 1), atol=1e-5, rtol=0)


def test_probe_kernels_reject_what_they_cannot_take():
    x, w, xi, wi = _probe_inputs(4096, 256, 64)
    with pytest.raises(ValueError, match="contiguous"):
        tpg.matmul_bf16(x.t().contiguous().t(), w)
    with pytest.raises(ValueError, match="shared memory"):
        tpg.matmul_bf16(torch.zeros(64, 512, device="cuda", dtype=torch.bfloat16),
                        torch.zeros(512, 512, device="cuda", dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="int8"):
        tpg.matmul_int8(x, wi)
    with pytest.raises(ValueError, match="multiple of 2048"):
        trr.read_reduce(x[:3000], torch.zeros(8, 128, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        trr.read_reduce(torch.zeros(256, 2048, device="cuda", dtype=torch.bfloat16).t(),
                        torch.zeros(8, 128, device="cuda"))
    with pytest.raises(ValueError, match="aligned"):  # 16-byte loads
        tpg.matmul_bf16(x.view(-1)[1:1 + 4096 * 256 - 256].view(4095, 256), w)


@pytest.mark.parametrize("module,call", [
    (tpg, lambda: tpg.matmul_bf16(*_probe_inputs(256, 64, 64)[:2])),
    (tpg, lambda: tpg.matmul_int8(*_probe_inputs(256, 128, 64)[2:])),
    (trr, lambda: trr.read_reduce(_probe_inputs(2048, 128, 64)[0],
                                  torch.zeros(8, 128, device="cuda"))),
])
def test_probe_kernels_no_fallback_without_the_kernel(monkeypatch, module, call):
    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(_build, "load_library", no_library)
    module._kernel.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="unavailable"):
            call()
    finally:
        module._kernel.cache_clear()
