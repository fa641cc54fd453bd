"""K1 grouped_mean / K2 segment_mean (and, on a GPU, K4 quantize, K5
dequantize and K6 segment_dequant_mean) wrappers: input checks, CPU
dispatch, and, on a GPU, each CUDA kernel against its plain PyTorch
version. This file imports no jax, so it also runs on the card:

    PYTHONPATH=src python -m pytest tests/test_torch_kernels.py -q

Tests marked ``cuda`` skip without a GPU. On the card: f32 ``atol=1e-5``
(|x| ~ 1; the kernel and the plain version sum in another order) and bf16
``atol=5e-2`` (one bf16 ulp at |x| ~ 4); dead groups bit for bit. K4 and
K5 are bit-equal to their plain versions (the same IEEE divisions and
round-half-to-even); K6 agrees within ``1e-5 * max|x|``, dead groups bit
for bit.
"""
import numpy as np
import pytest
import torch

from pathlib import Path

from repro_torch.kernels import _build
from repro_torch.kernels import hier_aggregate as ha
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
