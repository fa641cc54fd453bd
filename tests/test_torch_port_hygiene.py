"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, its entry points default to CUDA and refuse to fall back to the
CPU, and configurations that need an unported feature say which ROADMAP
item brings it."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.MULTILINE)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_every_port_module_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.') "
        "or k == 'repro' or k.startswith('repro.'))\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]), bad)\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import _build\n"
        "assert _build._libs == {}, 'importing built a kernel'\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 20  # every module was imported


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_port_file_imports_jax_or_the_jax_package(path):
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_run_experiment_without_device_raises_when_no_gpu(monkeypatch):
    from repro_torch.fed import scenarios

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = scenarios.get("quickstart", overrides=["run.num_rounds=2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec.run_experiment()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec.build()


def test_runner_without_device_raises_when_no_gpu(monkeypatch):
    from repro_torch.fed import scenarios

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    runner = scenarios.get("quickstart").build(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        type(runner)(
            loss_fn=runner.loss_fn, optimizer=runner.optimizer, topology=runner.topology,
            hier_config=runner.hier_config, data_sizes=runner.batcher.data_sizes,
            batcher=runner.batcher, runner_config=runner.cfg,
        )


def test_resolve_device_turns_tf32_off():
    from repro_torch import resolve_device

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        assert resolve_device("cpu") == torch.device("cpu")
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = True  # torch's own default


@pytest.mark.parametrize(
    "overrides,item",
    [
        (["aggregators.levels=weighted_mean/coordinate_median"], 8),
        (["schedule.async_cloud=true"], 11),
        (["aggregators.levels=trimmed_mean:0.1/weighted_mean"], 8),
        (["precision.param_dtype=bfloat16"], 8),
        (["failures.p_fail=0.1"], 9),
        (["participation.cohort_size=8"], 10),
        (["deadline.enabled=true"], 11),
        (["topology.mesh_axes=clients"], 12),
        (["run.engine=megakernel"], 6),
        (["model.arch=lm-10m"], 13),
        (["data.dataset=tokens"], 13),
        (["run.checkpoint_dir=ckpt"], 5),
    ],
)
def test_unported_features_name_their_roadmap_item(overrides, item):
    from repro_torch.fed import scenarios

    spec = scenarios.get("quickstart", overrides=overrides)
    with pytest.raises(NotImplementedError, match=rf"ROADMAP\.md Queue 1 item {item} "):
        spec.build(device="cpu")


@pytest.mark.parametrize("name", ["trimmed_int8", "trimmed_edge", "lm_edge_niid", "n1m_cohort4096", "fedbuff_k4"])
def test_unported_scenarios_name_their_roadmap_item(name):
    from repro_torch.fed import scenarios

    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md Queue 1 item \d+"):
        scenarios.get(name)


def test_unknown_scenario_lists_the_ported_ones():
    from repro_torch.fed import scenarios

    with pytest.raises(ValueError, match="quickstart"):
        scenarios.get("no_such_scenario")
    assert scenarios.names() == sorted([
        "quickstart", "favg", "hierfavg_iid", "hierfavg_edge_iid", "hierfavg_edge_niid",
        "kappa_sweep_fast", "edge_only", "ragged_edges", "three_level", "int8_cloud", "int8_ef_both",
    ])


def test_kernel_sources_build_for_hopper():
    from repro_torch.kernels import _build

    assert _build.SOURCES == ("hier_aggregate", "quantize")
    assert all((_build.CSRC / f"{name}.cu").exists() for name in _build.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
