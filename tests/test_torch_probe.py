"""The roofline harness: the conv-floor probe's kernels (their plain versions
on the CPU) against the JAX Pallas probes in interpret mode, the harness's
copies of the JAX scripts' constants, the kernels' bounds, the wrappers'
checks, and the harness's plumbing on the CPU.

Tolerances: int8 exact; bf16 within one bf16 ulp (rtol 2^-7) beyond the
f32 sums' reordering bound (``probe_gemm.bf16_tolerance``), since both sides
round an f32 sum of the same products to bf16 once; the read probe's
partials, 256 bf16 values summed in f32 in another order, atol 1e-4 + rtol
1e-5.  The CUDA kernels themselves are held to the plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import importlib.util
import json
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visuelle2_tpu_torch.ops.cuda import probe_gemm, read_reduce, roofline
from visuelle2_tpu_torch.perf import convfloor, convfloor_v2, gemm_split
from visuelle2_tpu_torch.perf import roofline as harness_roofline
from visuelle2_tpu_torch.perf import timing

SCRIPTS = pathlib.Path(__file__).resolve().parents[1] / "scripts"


def _load_script(name):
    """A module of scripts/ loaded as tests/test_perf_scripts.py does."""
    sys.path.insert(0, str(SCRIPTS))
    try:
        spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(SCRIPTS))
    return mod


@pytest.fixture(scope="module")
def jprobe():
    return _load_script("perf_pallas_convfloor")


def _bf16_pair(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    return jnp.bfloat16(x), jnp.bfloat16(w)


def _to_torch(a):
    """A bf16 (or any) JAX array as a torch tensor of the same values."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("m,k,n,seed", [(4096, 256, 64, 3), (2048, 512, 128, 5)])
def test_bf16_gemm_matches_pallas_within_one_ulp(jprobe, m, k, n, seed):
    xb, wb = _bf16_pair(m, k, n, seed)
    want = _to_torch(jprobe._pallas_matmul(xb, wb, interpret=True))
    x, w = _to_torch(xb), _to_torch(wb)
    got = probe_gemm.matmul_bf16(x, w)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= probe_gemm.bf16_tolerance(x, w, want)).all()), diff.max()


@pytest.mark.parametrize("m,k,n", [(4096, 256, 64), (2048, 512, 128)])
def test_int8_gemm_matches_pallas_exactly(jprobe, m, k, n):
    rng = np.random.default_rng(11)
    xi = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wi = rng.integers(-127, 128, (k, n)).astype(np.int8)
    xi[:3] = 127   # the extremes: |sums| up to 127·127·K
    wi[:, :2] = -127
    wi[:, 2] = 127
    want = np.asarray(jprobe._pallas_matmul_int8(jnp.asarray(xi), jnp.asarray(wi),
                                                 interpret=True))
    got = probe_gemm.matmul_int8(torch.from_numpy(xi), torch.from_numpy(wi))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 0] == -127 * 127 * k


@pytest.mark.parametrize("k", [256, 512])
def test_read_reduce_matches_pallas(jprobe, k):
    xb, _ = _bf16_pair(4096, k, 8, 7)
    bias = np.random.default_rng(8).standard_normal((8, 128)).astype(np.float32)
    want = np.asarray(jprobe._pallas_read_reduce(xb, jnp.asarray(bias), interpret=True))
    want0 = np.asarray(jprobe._pallas_read_reduce(xb, jnp.zeros((8, 128), jnp.float32),
                                                  interpret=True))
    x = _to_torch(xb)
    got = read_reduce.read_reduce(x, torch.from_numpy(bias))
    assert got.shape == (16, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    got0 = read_reduce.read_reduce(x, torch.zeros(8, 128))
    np.testing.assert_allclose((got - got0).numpy(), np.tile(bias, (2, 1)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(want - want0, np.tile(bias, (2, 1)), atol=1e-5, rtol=0)
    # The full-K buffer: the first 128 columns are the probe's result, the
    # rest the same sums without the bias.
    full = read_reduce.read_reduce(x, torch.from_numpy(bias), full_k=True)
    assert full.shape == (16, k)
    torch.testing.assert_close(full[:, :128], got)
    plain = x.float().view(2, 256, 8, k).sum(1).reshape(16, k)
    torch.testing.assert_close(full[:, 128:], plain[:, 128:], atol=1e-4, rtol=1e-5)


def test_constants_match_the_jax_scripts(jprobe):
    jroof = _load_script("perf_roofline")
    assert convfloor.SHAPES == jprobe.SHAPES
    assert convfloor.TILE_M == jprobe.TILE_M == read_reduce.TILE_M
    assert harness_roofline.BATCH == jroof.BATCH
    assert harness_roofline.RESNET101_CONVS == jroof.RESNET101_CONVS
    for h in (299, 75, 38, 19, 10, 8):
        for k in (1, 3, 7):
            for stride in (1, 2):
                assert harness_roofline.conv_out_dim(h, k, stride) == jroof.conv_out_dim(
                    h, k, stride)
    jv2 = _load_script("perf_convfloor_v2")
    for _, hin, cin, cout, k, stride, _ in harness_roofline.RESNET101_CONVS:
        assert convfloor_v2.conv_flops(hin, cin, cout, k, stride) == jv2.conv_flops(
            hin, cin, cout, k, stride)


@pytest.mark.parametrize("shape,bounds_us", [
    ("A_720k_256_64", (137.7, 110.2, 110.6)),
    ("B_184k_512_128", (70.5, 56.4, 56.5)),
])
def test_probe_bounds_are_perf_md_s(shape, bounds_us):
    m, k, n = (convfloor.SHAPES[shape][d] for d in "mkn")
    got = (roofline.bound_ms(*roofline.probe_gemm_cost(m, k, n, "bf16"), "bf16"),
           roofline.bound_ms(*roofline.probe_gemm_cost(m, k, n, "int8"), "int8"),
           roofline.bound_ms(*roofline.read_reduce_cost(m, k)))
    assert [round(1e3 * ms, 1) for ms, _ in got] == list(bounds_us)
    assert {by for _, by in got} == {"bytes"}
    with pytest.raises(ValueError, match="kind"):
        roofline.probe_gemm_cost(m, k, n, "fp8")


def test_gemm_wrappers_take_a_ragged_m():
    """The kernel masks the last row tile, so any M >= 1 is taken."""
    x = torch.randn(1000, 128).to(torch.bfloat16)
    w = torch.randn(128, 64).to(torch.bfloat16)
    torch.testing.assert_close(probe_gemm.matmul_bf16(x, w), probe_gemm.matmul_bf16_plain(x, w))
    xi = torch.randint(-127, 128, (37, 128), dtype=torch.int8)
    wi = torch.randint(-127, 128, (128, 256), dtype=torch.int8)
    assert torch.equal(probe_gemm.matmul_int8(xi, wi), torch._int_mm(xi, wi))


def test_wrappers_raise_on_what_the_kernels_cannot_take():
    xb = torch.zeros(4096, 256, dtype=torch.bfloat16)
    bias = torch.zeros(8, 128)
    with pytest.raises(ValueError, match="multiple of 2048"):
        read_reduce.read_reduce(xb[:3000], bias)
    with pytest.raises(ValueError, match="at least 128"):
        read_reduce.read_reduce(xb[:, :64].contiguous(), bias)
    with pytest.raises(ValueError, match="bfloat16"):
        read_reduce.read_reduce(xb.float(), bias)
    with pytest.raises(ValueError, match=r"\[8, 128\]"):
        read_reduce.read_reduce(xb, torch.zeros(8, 64))
    w = torch.zeros(256, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16 only"):
        probe_gemm.matmul_bf16(xb.float(), w)
    with pytest.raises(ValueError, match="int8 only"):
        probe_gemm.matmul_int8(xb, w.to(torch.int8))
    with pytest.raises(ValueError, match="multiple of 128"):
        probe_gemm.matmul_int8(torch.zeros(8, 64, dtype=torch.int8),
                               torch.zeros(64, 64, dtype=torch.int8))
    with pytest.raises(ValueError, match="multiple of 64"):
        probe_gemm.matmul_bf16(xb[:, :96].contiguous(), w[:96])
    with pytest.raises(ValueError, match="N=96"):
        probe_gemm.matmul_bf16(xb, torch.zeros(256, 96, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="M > 0"):
        probe_gemm.matmul_bf16(xb[:0], w)
    with pytest.raises(ValueError, match="cuda or cpu"):
        probe_gemm.matmul_bf16(xb.to("meta"), w.to("meta"))


def test_shared_memory_of_the_probe_shapes_fits_a_block():
    for s in convfloor.SHAPES.values():
        for esize in (1, 2):
            assert probe_gemm.smem_bytes(s["k"], s["n"], esize) <= 232448


def test_parity_check_on_the_cpu():
    res = convfloor.parity_check("cpu")
    assert res["int8_exact"] and res["bias_shift_max_abs_err"] <= 1e-5


def test_measure_shape_plumbing_on_the_cpu():
    r = convfloor.measure_shape("small", 4096, 256, 64, target_s=0.01, device="cpu")
    for key in ("cublas_bf16", "cuda_bf16", "cublas_int8", "cuda_int8"):
        assert r[key]["secs"] > 0 and r[key]["tflops_per_sec"] > 0
        assert r[key]["bound_secs"] > 0
    for key in ("read_bw", "torch_sum_bw"):
        assert r[key]["gb_per_sec"] > 0 and r[key]["bw_roofline_tflops"] > 0
    assert r["best_cuda_over_cublas_bf16"] > 0


def test_measure_conv_shape_plumbing_on_the_cpu():
    r = convfloor_v2.measure_conv_shape("tiny", 8, 8, 8, 1, 1, device="cpu", target_s=0.01)
    assert r["bf16"]["secs"] > 0 and r["bf16"]["achieved_gbps"] > 0
    # bf16 in and out, as the port's backbone: 2 bytes each way.
    assert r["bf16"]["min_traffic_mb"] == 2 * 2 * 128 * 8 * 8 * 8 / 2**20
    r = convfloor_v2.measure_conv_shape("tiny", 9, 8, 16, 3, 2, dtypes=("bf16", "f32"),
                                        device="cpu", target_s=0.01, batch=2)
    assert r["out_dim"] == 5 and r["f32"]["secs"] > 0


def test_epilogue_chain_and_artifact_plumbing_on_the_cpu():
    res = convfloor_v2.measure_epilogue_and_chain(0.005, device="cpu", batch=1)
    assert res["epilogue_overhead_x"] > 0 and res["chain_over_sum_x"] > 0
    res = convfloor_v2.measure_artifact_check(0.005, device="cpu", batch=1)
    assert res["inflation_x"] > 0


def test_flop_guard_catches_missing_work():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    assert timing.verify_flops(torch.matmul, (a, b), 2 * 8 * 16 * 4) == 2 * 8 * 16 * 4
    with pytest.raises(RuntimeError, match="flop counter"):
        timing.verify_flops(lambda a, b: torch.matmul(a[:4], b), (a, b), 2 * 8 * 16 * 4)


def test_input_sets_rotate_past_the_l2():
    assert len(timing.input_sets(lambda i: (i,), 10 * 2**20, "cuda")) == 10
    assert len(timing.input_sets(lambda i: (i,), 200 * 2**20, "cuda")) == 1
    assert len(timing.input_sets(lambda i: (i,), 10 * 2**20, "cpu")) == 1


def test_clis_write_only_where_told(tmp_path, monkeypatch):
    """With a device forced to the CPU in code and tiny settings, each CLI
    writes nothing without --out and its results with it."""
    cpu = lambda device=None: torch.device("cpu")
    for mod in (convfloor, convfloor_v2, harness_roofline):
        monkeypatch.setattr(mod, "resolve_device", cpu)
    monkeypatch.setattr(convfloor, "SHAPES", {"tiny": dict(m=2048, k=128, n=64)})
    monkeypatch.setattr(convfloor_v2, "RESNET101_CONVS", [("tiny", 8, 8, 8, 1, 1, 2)])
    monkeypatch.chdir(tmp_path)
    runs = ((convfloor, ["--target_s", "0.001"]),
            (convfloor_v2, ["--target_s", "0.001", "--skip_extras"]),
            (harness_roofline, ["--gemm_sizes", "32", "--conv_names", "tiny"]))
    for mod, argv in runs:
        mod.main(argv)
    assert list(tmp_path.iterdir()) == []
    for mod, argv in runs:
        out = tmp_path / f"{mod.__name__.rsplit('.', 1)[-1]}.json"
        res = mod.main(argv + ["--out", str(out)])
        assert json.loads(out.read_text())["device"] == res["device"] == "cpu"
    for name in ("convfloor_v2", "roofline"):  # roofline measures convs by v2's method
        assert json.loads((tmp_path / f"{name}.json").read_text())[
            "conv_weighted_bf16"]["shapes_measured"] == 1


def test_gemm_split_variants_apply_to_the_kernel_source():
    """Each variant removes its part from the current kernel sources: the
    bf16 TMA/wgmma kernel's and the int8 mma.sync kernel's."""
    int8_text = gemm_split.SOURCES["int8"].read_text()
    variants = gemm_split.variant_sources("int8", int8_text)
    assert variants["whole"] == int8_text
    assert "mma(acc" not in variants["no_products"]
    assert "load_chunk(c +" not in variants["no_x_loads"]
    assert variants["no_fragment_loads"].count("if (0) ldmatrix_x4") == 2
    with pytest.raises(RuntimeError, match="is not in"):
        gemm_split.variant_sources("int8", int8_text.replace("load_chunk(s);", "load(s);"))
    bf16_text = gemm_split.SOURCES["bf16"].read_text()
    variants = gemm_split.variant_sources("bf16", bf16_text)
    assert variants["whole"] == bf16_text
    assert "wgmma_tile<NW>(acc" not in variants["no_wgmma"]
    assert "tma_load_2d(&x_map" not in variants["no_x_loads"]
    assert "expect_tx(full_bar" not in variants["no_x_loads"]
    assert "tma_load_2d(&w_map" in variants["no_x_loads"]  # w still arrives
    assert variants["no_stores"].count("w[0] == 0x12345u) *reinterpret_cast") == 1


@pytest.mark.parametrize("line", [
    "wgmma_tile<NW>(acc, a_desc + 2 * kk, b_desc + 128 * kk, kc | kk);",
    "mbar_arrive_expect_tx(full_bar, kStageBytes);",
])
def test_gemm_split_raises_when_a_bf16_line_is_gone(line):
    text = gemm_split.SOURCES["bf16"].read_text()
    assert line in text
    with pytest.raises(RuntimeError, match="is not in probe_gemm_bf16.cu"):
        gemm_split.variant_sources("bf16", text.replace(line, ""))


@pytest.mark.parametrize("esize,n,k_max", [
    (2, 64, 1536), (2, 128, 768), (2, 256, 384), (2, 512, 192),
    (1, 64, 1536), (1, 128, 1280), (1, 256, 768), (1, 512, 384),
])
def test_gemm_shared_memory_bounds_k_as_the_docstring_says(esize, n, k_max):
    """w stays whole in a block's shared memory beside the x ring, so K has
    a ceiling for each N, the one the module's docstring states."""
    step = 128 // esize
    assert probe_gemm.smem_bytes(k_max, n, esize) <= 232448
    assert probe_gemm.smem_bytes(k_max + step, n, esize) > 232448
    assert f"{k_max}" in probe_gemm.__doc__


def test_bf16_ring_depth_and_tile_rows():
    """Eight stages of 16 KB beside w at shape A, six at shape B; 64-row
    tiles of 8 KB at N = 512; fewer than two stages do not fit."""
    assert [probe_gemm.bf16_tile_rows(n) for n in (64, 128, 256, 512)] == [128, 128, 128, 64]
    assert probe_gemm.bf16_stages(256, 64) == 8
    assert probe_gemm.smem_bytes(256, 64, 2) == 1280 + 256 * 64 * 2 + 8 * 128 * 128
    assert probe_gemm.bf16_stages(512, 128) == 6
    assert probe_gemm.smem_bytes(512, 128, 2) == 1280 + 512 * 128 * 2 + 6 * 128 * 128
    assert probe_gemm.bf16_stages(192, 512) == 4 and probe_gemm.bf16_stages(256, 512) < 2
    # A shape with room for fewer than two stages is sized at two: past 227 KB.
    assert probe_gemm.smem_bytes(256, 512, 2) == 1280 + 256 * 512 * 2 + 2 * 64 * 128 > 232448
