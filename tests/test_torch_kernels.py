"""K1 grouped_mean / K2 segment_mean (and, on a GPU, K4 quantize, K5
dequantize, K6 segment_dequant_mean and K3 edge_interval) wrappers: input
checks, CPU dispatch, and, on a GPU, each CUDA kernel against its plain
PyTorch version. This file imports no jax, so it also runs on the card:

    PYTHONPATH=src python -m pytest tests/test_torch_kernels.py -q

Tests marked ``cuda`` skip without a GPU. On the card: f32 ``atol=1e-5``
(|x| ~ 1; the kernel and the plain version sum in another order) and bf16
``atol=5e-2`` (one bf16 ulp at |x| ~ 4); dead groups bit for bit. K4 and
K5 are bit-equal to their plain versions (the same IEEE divisions and
round-half-to-even); K6 agrees within ``1e-5 * max|x|``, dead groups bit
for bit. K3 agrees at the JAX kernel-vs-oracle ``rtol=3e-6, atol=5e-7``
(bf16 rows: plus one bf16 ulp), repeats itself bit for bit and is one
kernel launch per call. A sampled cohort's stages (compacted segment ids
with K2's table uploaded ahead) run K2 and K1 on the card, and
``n1m_cohort4096`` runs through them. K1/K2's schedule (``_schedule``: one
pass, or a tall group split over blocks) and K2's segment table are host
code, checked here on the CPU; on the card, the tall root leaves of
``n1m_cohort4096``, dead groups over several chunks, relaunches and
unaligned inputs (bit for bit) and 70,000 groups (K1, K2, K6).
"""
import numpy as np
import pytest
import torch

from pathlib import Path

from repro_torch.core import aggregation
from repro_torch.core.hierarchy import HierarchySpec
from repro_torch.kernels import _build
from repro_torch.kernels import hier_aggregate as ha
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels import quantize as qz


def test_kernel_wrappers_refuse_devices_other_than_cpu_and_cuda():
    x = torch.empty(4, 8, device="meta")
    w = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        ha.grouped_mean(x, w, 2)
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        ha.segment_mean(x, w, [0, 0, 1, 1], 2)


def test_segment_offsets():
    ids = np.array([0, 0, 0, 1, 1, 3, 3])
    np.testing.assert_array_equal(ha.segment_offsets(ids, 4), [0, 3, 5, 5, 7])
    with pytest.raises(ValueError, match="sorted"):
        ha.segment_offsets(np.array([0, 1, 0]), 2)
    with pytest.raises(ValueError, match=r"\[0, 2\)"):
        ha.segment_offsets(np.array([0, 1, 2]), 2)


@pytest.mark.parametrize("layout", ["env", "checkout", "installed"])
def test_build_dir_by_layout(layout, monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    if layout == "env":
        monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "kernels"))
        want = tmp_path / "kernels"
    elif layout == "checkout":  # these tests run from the source tree
        want = Path(__file__).resolve().parents[1] / "build" / "repro_torch_kernels"
    else:  # a non-editable install: nothing is written beside the package
        csrc = tmp_path / "lib" / "site-packages" / "repro_torch" / "kernels" / "csrc"
        csrc.mkdir(parents=True)
        (csrc / "hier_aggregate.cu").write_text("")
        monkeypatch.setattr(_build, "CSRC", csrc)
        want = tmp_path / "cache" / "repro_torch_kernels"
    assert _build.build_dir() == want
    assert _build.library_path("hier_aggregate").parent == want


def test_launch_counts_stay_zero_on_cpu():
    ha.reset_launch_counts()
    x = torch.randn(8, 16)
    ha.grouped_mean(x, torch.ones(8), 2)
    ha.segment_mean(x, torch.ones(8), [0, 0, 0, 1, 1, 1, 1, 2], 3)
    assert ha.LAUNCHES == {"grouped_mean": 0, "segment_mean": 0, "segment_dequant_mean": 0}


# -- K1/K2's schedule and K2's table: pure host code, checked here ------------------

N1M_ROOT_WIDTHS = (768, 480, 48, 10)  # n1m_cohort4096's leaves w1, w2, b1, b2 at the root (G = 1)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("d", N1M_ROOT_WIDTHS)
def test_schedule_splits_n1m_root_leaves_over_the_card(d, itemsize):
    s = ha._schedule(4096, d, 1, itemsize)
    assert s.chunks > 1 and s.kernels == 2 and s.groups_per_block == 1
    assert s.blocks(1) >= ha.SMS  # at least one block per SM
    assert s.chunks * s.chunk_rows >= 4096 > (s.chunks - 1) * s.chunk_rows
    # a narrow leaf fills its warps with row threads: at most half a warp idle
    assert 64 <= s.threads <= ha.THREADS and (-s.threads) % 32 <= 16
    assert s.chunk_rows >= s.rows  # every row thread has a row in its chunk
    assert s.vec == (16 // itemsize if d % (16 // itemsize) == 0 else 1)


@pytest.mark.parametrize("n,d,groups,itemsize", [
    (8, 18874368, 1, 4), (8, 18874368, 2, 4), (8, 18874368, 1, 2), (8, 18874368, 2, 2),  # lm-100m mlp w1
    (32, 262144, 1, 4), (32, 262144, 4, 4),  # mlp307k w1
    (20, 768, 4, 4), (8, 768, 2, 4),  # quickstart, lm-100m final_norm
])
def test_schedule_keeps_short_groups_in_one_pass(n, d, groups, itemsize):
    s = ha._schedule(n // groups, d, groups, itemsize)
    assert s.chunks == 1 and s.kernels == 1 and s.chunk_rows == n // groups
    assert s.vec == 16 // itemsize  # 16-byte slots
    assert s.threads <= ha.THREADS and s.blocks(groups) >= 1


@pytest.mark.parametrize("d", [4, 10, 48, 768])
def test_schedule_stays_inside_the_grid_at_70000_groups(d):
    n, g = 140_000, 70_000
    s = ha._schedule(n // g, d, g, 4)
    assert s.chunks == 1 and s.threads <= ha.THREADS
    assert g <= s.blocks(g) * s.groups_per_block // s.tiles + s.groups_per_block
    assert s.blocks(g) <= ha.GRID_LIMIT
    # K2 over 70,000 ragged segments (some empty): no segment is taller
    # than the chunk, so the table is the offsets alone and one pass runs
    ids = np.repeat(np.arange(g), np.tile([1, 3, 0, 4], g // 4))
    table = ha.segment_table(ids, g)
    assert ha.table_items(table.size, g) == 0
    np.testing.assert_array_equal(table, ha.segment_offsets(ids, g))
    assert ha._segment_schedule(n, d, g, 4, 0).blocks(g) <= ha.GRID_LIMIT


def test_schedule_depends_on_the_shape_alone():
    shapes = [(4096, 768, 1, 4), (4096, 10, 1, 2), (8, 18874368, 2, 4), (2, 768, 70_000, 4), (100, 96, 3, 4)]
    for shape in shapes:
        assert ha._schedule(*shape) == ha._schedule(*shape)
    # the same rows per group at another width, group count or item size
    # may take another schedule, but never a different answer for the same
    # shape; and K2's table depends on the ids alone, so a tree level's
    # table serves every leaf
    ids = np.repeat(np.arange(3), [200, 5, 3000])
    np.testing.assert_array_equal(ha.segment_table(ids, 3), ha.segment_table(ids.copy(), 3))
    for n in (1, 50, 64, 65, 4096, 140_000):
        r = ha._segment_chunk_rows(n)
        assert r == ha._segment_chunk_rows(n) and (r == n if n <= ha.SPLIT_ABOVE else r * r >= 4 * n)


def test_segment_table_work_items_cover_each_segment_once():
    sizes = [200, 5, 0, 3000, 129, 128, 1]
    ids = np.repeat(np.arange(len(sizes)), sizes)
    g, n = len(sizes), ids.size
    table = ha.segment_table(ids, g)
    offsets, chunk = table[: g + 1], ha._segment_chunk_rows(n)
    np.testing.assert_array_equal(offsets, ha.segment_offsets(ids, g))
    items = ha.table_items(table.size, g)
    first, seg = table[g + 1: 2 * (g + 1)], table[2 * (g + 1):]
    assert table.dtype == np.int32 and seg.size == items == first[-1]
    covered = np.zeros(n, np.int64)
    for item, s in enumerate(seg):  # what the kernels compute for each item
        lo = offsets[s] + (item - first[s]) * chunk
        hi = min(lo + chunk, offsets[s + 1])
        assert first[s] <= item < first[s + 1] and lo < hi
        covered[lo:hi] += 1
    np.testing.assert_array_equal(covered, 1)
    np.testing.assert_array_equal(np.diff(first), -(-np.asarray(sizes) // chunk))


def test_grid_limit_is_refused_by_name():
    with pytest.raises(ValueError, match=r"grid.x's limit of 2\^31 - 1"):
        ha._check_grid(ha.GRID_LIMIT + 1, "grouped_mean", (2**20, 4096))
    ha._check_grid(ha.GRID_LIMIT, "grouped_mean", (2**20, 4096))


# -- on the card: the kernels against their plain versions -----------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 4])
def test_grouped_mean_kernel_matches_plain_on_gpu(cuda, dtype, groups):
    x = torch.randn(32, 4099, device=cuda).to(dtype)
    w = torch.rand(32, device=cuda) + 0.5
    w[:8] = 0.0
    before = ha.LAUNCHES["grouped_mean"]
    got = ha.grouped_mean(x, w, groups)
    assert ha.LAUNCHES["grouped_mean"] == before + 1
    want = ha.grouped_mean_plain(x, w, groups)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=1e-5 if dtype == torch.float32 else 5e-2)
    if groups == 4:
        assert torch.equal(got[:8], x[:8])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_mean_kernel_matches_plain_on_gpu(cuda, dtype):
    ids = np.repeat(np.arange(5), [16, 12, 10, 7, 5])
    x = torch.randn(50, 1000, device=cuda).to(dtype)
    w = torch.rand(50, device=cuda) + 0.5
    w[:16] = 0.0
    got = ha.segment_mean(x, w, ids, 5)
    want = ha.segment_mean_plain(x, w, ids, 5)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=1e-5 if dtype == torch.float32 else 5e-2)
    assert torch.equal(got[:16], x[:16])


@pytest.mark.cuda
def test_wrappers_check_their_inputs_on_gpu(cuda):
    x = torch.randn(8, 16, device=cuda)
    w = torch.ones(8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ha.grouped_mean(x.t().contiguous().t(), w, 2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ha.grouped_mean(x.half(), w, 2)
    with pytest.raises(ValueError, match="weights must be float32"):
        ha.segment_mean(x, w.double(), [0, 0, 0, 1, 1, 1, 1, 2], 3)
    with pytest.raises(ValueError, match="sorted"):
        ha.segment_mean(x, w, [0, 1, 0, 1, 1, 1, 1, 2], 3)


@pytest.mark.cuda
def test_quickstart_on_gpu_goes_through_k1_and_tracks_the_cpu(cuda):
    from repro_torch.fed import scenarios

    spec = scenarios.get("quickstart", overrides=["run.num_rounds=8"])
    params = spec.init_params(1, "cpu")
    cpu, _ = spec.run_experiment(device="cpu", params=params)
    ha.reset_launch_counts()
    gpu, state = spec.run_experiment(device=cuda, params=params)
    assert ha.LAUNCHES["grouped_mean"] == 4 * 12  # 4 cloud intervals x (1 + 2) stages x 4 leaves
    assert state.params["w1"].is_cuda
    for a, b in zip(cpu.history, gpu.history):
        assert b.loss == pytest.approx(a.loss, rel=1e-4)
        if a.accuracy is not None:
            assert abs(b.accuracy - a.accuracy) <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,qblock", [(20, 768, 128), (50, 10, 256), (32, 4099, 256), (3, 1000, 64)])
def test_quantize_kernels_are_bit_equal_to_plain_on_gpu(cuda, dtype, n, d, qblock):
    x = (torch.randn(n, d, device=cuda) * 3).to(dtype)
    x[0, :qblock] = 0.0  # an all-zero block
    before = dict(qz.LAUNCHES)
    q, s = qz.quantize_stacked(x, qblock)
    back = qz.dequantize_stacked(q, s, d, dtype)
    assert qz.LAUNCHES == {k: v + 1 for k, v in before.items()}
    qp, sp = qz.quantize_stacked_plain(x, qblock)
    assert torch.equal(q, qp) and torch.equal(s, sp) and float(s[0, 0]) == 0.0
    assert torch.equal(back, qz.dequantize_stacked_plain(q, s, d, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("ids", [[4] * 8, [16, 12, 10, 7, 5]], ids=["uniform", "ragged"])
def test_segment_dequant_mean_kernel_matches_plain_on_gpu(cuda, ids):
    seg = np.repeat(np.arange(len(ids)), ids)
    n = seg.size
    q, s = qz.quantize_stacked(torch.randn(n, 2048, device=cuda), 256)
    w = torch.rand(n, device=cuda) + 0.5
    w[: ids[0]] = 0.0  # segment 0 dead
    got = ha.segment_dequant_mean(q, s, w, seg, len(ids))
    want = ha.segment_dequant_mean_plain(q, s, w, seg, len(ids))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    assert torch.equal(got[: ids[0]], want[: ids[0]])


@pytest.mark.cuda
def test_quantize_wrappers_check_their_inputs_on_gpu(cuda):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        qz.quantize_stacked(torch.ones(2, 8, device=cuda, dtype=torch.float16), 4)
    with pytest.raises(ValueError, match="contiguous"):
        qz.quantize_stacked(torch.ones(8, 2, device=cuda).t(), 4)
    with pytest.raises(ValueError, match="int8 codes"):
        qz.dequantize_stacked(torch.zeros(2, 8, device=cuda), torch.zeros(2, 2, device=cuda), 8)


@pytest.mark.cuda
def test_int8_ef_both_on_gpu_goes_through_k4_k5_and_tracks_the_cpu(cuda):
    from repro_torch.fed import scenarios

    spec = scenarios.get("int8_ef_both", overrides=["run.num_rounds=4", "data.num_samples=1000"])
    params = spec.init_params(1, "cpu")
    cpu, _ = spec.run_experiment(device="cpu", params=params)
    qz.reset_launch_counts()
    gpu, state = spec.run_experiment(device=cuda, params=params)
    assert qz.LAUNCHES == {"quantize": 16, "dequantize": 16}  # 4 syncs x 4 leaves, both hops compressed
    assert state.residual["w1"].is_cuda
    for a, b in zip(cpu.history, gpu.history):
        assert b.loss == pytest.approx(a.loss, rel=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,e,k1,b,feat,out,mom", [
    (8, 2, 3, 2, 4, 3, 0.0),
    (16, 4, 2, 1, 8, 5, 0.9),
    (32, 4, 8, 1, 64, 1024, 0.9),  # full width, columns in registers
    (8, 2, 3, 2, 512, 96, 0.9),  # wide feat: the scratch-column path
    (16, 4, 3, 2, 32, 100, 0.0),  # out not a multiple of 32
    (32, 2, 4, 1, 64, 256, 0.9),  # 16 clients per edge: two rounds of 8 warps
    (24, 2, 3, 2, 16, 64, 0.0),  # 12 clients per edge: idle warps in the last round
    (32, 2, 2, 1, 96, 40, 0.9),  # 16 clients per edge on the scratch-column path
    (8, 2, 12, 1, 16, 40, 0.9),  # kappa1 12: the 8-step ring wraps
    (8, 2, 40, 1, 16, 40, 0.9),  # kappa1 40: loss partials stored every 32 steps
    (16, 2, 5, 48, 64, 64, 0.9),  # b 48: only a one-step ring fits
])
def test_edge_interval_kernel_matches_plain_on_gpu(cuda, dtype, n, e, k1, b, feat, out, mom):
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = (torch.randn(n, feat * out, device=cuda, generator=gen) * 0.1).to(dtype)
    x = torch.randn(n, k1, b, feat, device=cuda, generator=gen)
    y = torch.randn(n, k1, b, out, device=cuda, generator=gen)
    w = torch.rand(n, device=cuda, generator=gen) * 2 + 1
    mu = (torch.randn(n, feat * out, device=cuda, generator=gen) * 0.01).to(dtype) if mom else None
    kw = dict(num_edges=e, feat=feat, lr=0.1, momentum=mom, mu=mu)
    before = mk.LAUNCHES["edge_interval"]
    got = mk.edge_interval(params, x, y, w, **kw)
    assert mk.LAUNCHES["edge_interval"] == before + 1
    again = mk.edge_interval(params, x, y, w, **kw)
    want = mk.edge_interval_plain(params, x, y, w, **kw)
    for a, c, r, name in zip(got, want, again, ("params", "losses", "mu")):
        assert a.dtype == c.dtype and torch.equal(a, r), name
        a, c = a.float(), c.float()
        tol = 5e-7 + 3e-6 * c.abs()
        if dtype == torch.bfloat16 and name != "losses":
            tol = tol + torch.exp2(torch.floor(torch.log2(c.abs().clamp_min(1e-30))) - 7)
        assert bool(((a - c).abs() <= tol).all()), f"{name}: max abs err {float((a - c).abs().max())}"


@pytest.mark.cuda
def test_edge_interval_is_one_kernel_launch_on_gpu(cuda):
    from torch.profiler import ProfilerActivity, profile

    params = torch.randn(16, 8 * 40, device=cuda)
    x, y, w = torch.randn(16, 3, 1, 8, device=cuda), torch.randn(16, 3, 1, 40, device=cuda), torch.ones(16, device=cuda)
    kw = dict(num_edges=4, feat=8, lr=0.1, momentum=0.9, mu=torch.zeros_like(params))
    mk.edge_interval(params, x, y, w, **kw)  # the build and the ticket buffer
    for _ in range(5):  # the tracer can lose a short window whole: take it again
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            mk.edge_interval(params, x, y, w, **kw)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    assert len(kernels) == 1 and "edge_interval" in kernels[0], kernels


def test_edge_interval_scratch_only_above_feat_64():
    work, work_mu, partial = mk.scratch(8, 64, 100, 3, True, "cpu")
    assert work is None and work_mu is None and partial.shape == (8, 3, 4)
    work, work_mu, partial = mk.scratch(8, 65, 100, 3, True, "cpu")
    assert work.shape == work_mu.shape == (8, 65, 128) and partial.shape == (8, 3, 4)
    work, work_mu, _ = mk.scratch(8, 65, 100, 3, False, "cpu")
    assert work.shape == (8, 65, 128) and work_mu is None


def test_edge_interval_ticket_buffer_is_kept_and_grown():
    cache = {}
    first = mk.ticket_buffer(cache, (0, 7), 4, "cpu")
    assert first.dtype == torch.int32 and first.numel() == 4 and not first.any()
    assert mk.ticket_buffer(cache, (0, 7), 3, "cpu") is first
    grown = mk.ticket_buffer(cache, (0, 7), 5, "cpu")
    assert grown.numel() == 8 and not grown.any() and cache[(0, 7)] is grown
    assert mk.ticket_buffer(cache, (0, 9), 2, "cpu") is not grown  # another stream, its own buffer


@pytest.mark.cuda
def test_edge_interval_wrapper_checks_its_inputs_on_gpu(cuda):
    params = torch.zeros(4, 6, device=cuda)
    x, y, w = torch.zeros(4, 1, 1, 3, device=cuda), torch.zeros(4, 1, 1, 2, device=cuda), torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mk.edge_interval(params.half(), x, y, w, num_edges=2, feat=3, lr=0.1)
    with pytest.raises(ValueError, match="mu must be"):
        mk.edge_interval(params, x, y, w, num_edges=2, feat=3, lr=0.1, momentum=0.9, mu=params.bfloat16())
    with pytest.raises(ValueError, match="shared memory"):
        mk.edge_interval(params, torch.zeros(4, 1, 4096, 3, device=cuda), torch.zeros(4, 1, 4096, 2, device=cuda), w,
                         num_edges=1, feat=3, lr=0.1)


def _tolerance_ok(got, want, x):
    """f32: within 1e-5 of the largest |x| (another summation order); bf16:
    plus one bf16 ulp of the result, where the two f32 means round apart."""
    diff = (got.float() - want.float()).abs()
    tol = 1e-5 * float(x.float().abs().max())
    if got.dtype == torch.bfloat16:
        mag = want.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
        return bool((diff <= torch.exp2(torch.floor(torch.log2(mag)) - 7) + tol).all())
    return float(diff.max()) <= tol


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["grouped_mean", "segment_mean"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", N1M_ROOT_WIDTHS)
def test_tall_group_kernels_match_plain_on_gpu(cuda, kernel, dtype, d):
    g = torch.Generator().manual_seed(d)
    x = torch.randn(4096, d, generator=g).to(cuda, dtype)
    w = (torch.rand(4096, generator=g) + 0.5) * (torch.rand(4096, generator=g) > 0.3)
    w = w.to(cuda)
    ids = np.zeros(4096, np.int64)
    if kernel == "grouped_mean":
        got, want = ha.grouped_mean(x, w, 1), ha.grouped_mean_plain(x, w, 1)
    else:
        got, want = ha.segment_mean(x, w, ids, 1), ha.segment_mean_plain(x, w, ids, 1)
        assert ha.table_items(ha._device_table(ids.tobytes(), 1, x.device).numel(), 1) > 1  # split
    assert _tolerance_ok(got, want, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_dead_group_over_several_chunks_keeps_its_rows_on_gpu(cuda, dtype):
    x = torch.randn(8192, 48, device=cuda).to(dtype)
    w = torch.rand(8192, device=cuda) + 0.5
    w[:4096] = 0.0  # group 0 (K1) / segment 0 (K2): 4096 rows over many chunks, all dead
    assert ha._schedule(4096, 48, 2, x.element_size()).chunks > 1
    got = ha.grouped_mean(x, w, 2)
    assert torch.equal(_bits(got[:4096]), _bits(x[:4096]))
    assert _tolerance_ok(got, ha.grouped_mean_plain(x, w, 2), x)
    ids = np.repeat(np.arange(3), [4096, 4000, 96])
    got = ha.segment_mean(x, w, ids, 3)
    assert torch.equal(_bits(got[:4096]), _bits(x[:4096]))
    assert _tolerance_ok(got, ha.segment_mean_plain(x, w, ids, 3), x)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,groups", [(4096, 768, 1), (4096, 10, 1), (8, 262144, 2), (20, 768, 4), (50, 48, 5)])
def test_relaunches_and_unaligned_inputs_are_bit_equal_on_gpu(cuda, n, d, groups):
    x = torch.randn(n, d, device=cuda)
    w = torch.rand(n, device=cuda) + 0.5
    ids = np.sort(np.random.default_rng(n).integers(0, groups, n))
    ids[:groups] = np.arange(groups)
    ids.sort()
    # one element past a 16-byte boundary: element loads instead of 16-byte
    # ones, the same sums in the same order
    shifted = torch.empty(x.numel() + 1, device=cuda)[1:].view(n, d).copy_(x)
    for run in (lambda t: ha.grouped_mean(t, w, groups), lambda t: ha.segment_mean(t, w, ids, groups)):
        first = run(x)
        assert torch.equal(_bits(run(x)), _bits(first))
        assert torch.equal(_bits(run(shifted)), _bits(first))


@pytest.mark.cuda
def test_70000_groups_run_on_gpu(cuda):
    """F2: more groups than a grid's y dimension takes (65,535)."""
    n, g = 140_000, 70_000
    x = torch.randn(n, 48, device=cuda)
    w = torch.rand(n, device=cuda) + 0.5
    w[:2] = 0.0  # group 0 dead
    got = ha.grouped_mean(x, w, g)
    assert _tolerance_ok(got, ha.grouped_mean_plain(x, w, g), x) and torch.equal(got[:2], x[:2])
    ids = np.repeat(np.arange(g), np.tile([1, 3, 0, 4], g // 4))
    w[:1] = 0.0
    got = ha.segment_mean(x, w, ids, g)
    assert _tolerance_ok(got, ha.segment_mean_plain(x, w, ids, g), x)
    q, s = qz.quantize_stacked(torch.randn(n, 256, device=cuda), 128)
    got = ha.segment_dequant_mean(q, s, w, ids, g)
    want = ha.segment_dequant_mean_plain(q, s, w, ids, g)
    assert float((got - want).abs().max()) <= 1e-5 * float(qz.dequantize_stacked(q, s, 256).abs().max())


@pytest.mark.cuda
def test_launch_errors_name_the_cuda_error(cuda):
    with pytest.raises(RuntimeError, match=r"grouped_mean kernel launch failed with cudaErrorInvalidValue \(1\): "
                                           r".*; given x \(4, 8\)"):
        _build.raise_on_error(1, "grouped_mean", "x (4, 8)")


# -- sampled participation on the card: cohort stages through K1 and K2 -----------


@pytest.mark.cuda
def test_a_cohort_sync_launches_k2_with_its_compact_table(cuda):
    spec = HierarchySpec.uniform(70_000, 2)
    c = 64
    ids = np.sort(np.concatenate([[0, 1], np.random.default_rng(0).choice(np.arange(2, 140_000, 2), c - 2,
                                                                        replace=False)]))
    segments = np.asarray(spec.segments(1), np.int32)[ids][None]
    stages = aggregation.cohort_stages(segments, c)
    assert not stages[0].uniform and stages[0].num_segments == c - 1  # clients 0 and 1 share edge 0
    tables = [tuple(None if a is None else torch.from_numpy(a).pin_memory() for a in aggregation.stage_host_tables(st))
              for st in stages]
    dev_stages = aggregation.stages_to_device(stages, tables, cuda, non_blocking=True)
    rng = np.random.default_rng(1)
    tree = {"w": torch.from_numpy(rng.normal(size=(c, 48, 10)).astype(np.float32))}
    w = torch.from_numpy(rng.uniform(0.5, 2.0, size=c).astype(np.float32))
    want = aggregation.staged_mean(tree, w, stages[:1])
    ha.reset_launch_counts()
    got = aggregation.staged_mean({"w": tree["w"].to(cuda)}, w.to(cuda), dev_stages[:1])
    assert ha.LAUNCHES["segment_mean"] == 1 and ha.LAUNCHES["grouped_mean"] == 0
    torch.testing.assert_close(got["w"].cpu(), want["w"], rtol=1e-5, atol=1e-6)
    full = aggregation.staged_mean({"w": tree["w"].to(cuda)}, w.to(cuda), dev_stages)
    assert ha.LAUNCHES["grouped_mean"] == 1
    torch.testing.assert_close(full["w"].cpu(), aggregation.staged_mean(tree, w, stages)["w"], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_population_scenario_runs_on_the_card_through_k1_and_k2(cuda):
    from repro_torch.fed import scenarios

    spec = scenarios.get("n1m_cohort4096", overrides=["run.num_rounds=2"])
    params = spec.init_params(spec.run.seed + 1, "cpu")
    ha.reset_launch_counts()
    runner, state = spec.run_experiment(device=cuda, params=params)
    assert ha.LAUNCHES["segment_mean"] == 8 and ha.LAUNCHES["grouped_mean"] == 4
    assert all(v.shape[0] == 4096 and v.is_cuda for v in state.params.values())
    # one cloud interval against the plain versions on the CPU from the same
    # init: its rounds, and the params after its cloud sync (K2 over the
    # compacted edges with the prefetched table, K1 at the root)
    ref, ref_state = spec.run_experiment(device="cpu", params=params)
    for a, b in zip(runner.history, ref.history):
        assert a.loss == pytest.approx(b.loss, rel=1e-4) and a.grad_norm == pytest.approx(b.grad_norm, rel=1e-4)
    for k, v in state.params.items():
        torch.testing.assert_close(v.cpu(), ref_state.params[k], rtol=0, atol=1e-5)
