"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, its entry points default to CUDA and refuse to fall back to the
CPU, and configurations that need an unported feature say which ROADMAP
item brings it; features of items once unported build."""
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


def test_serve_without_device_raises_when_no_gpu(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "yi-9b", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve(serve.get_smoke("recurrentgemma-9b"), gen=2)


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
        (["participation.cohort_size=8", "topology.mesh_axes=clients"], 12),
        (["topology.mesh_axes=clients"], 12),
    ],
)
def test_unported_features_name_their_roadmap_item(overrides, item):
    from repro_torch.fed import scenarios

    spec = scenarios.get("quickstart", overrides=overrides)
    with pytest.raises(NotImplementedError, match=rf"ROADMAP\.md Queue 1 item {item} "):
        spec.build(device="cpu")


@pytest.mark.parametrize(
    "overrides,attr,want",
    [
        (["aggregators.levels=weighted_mean/coordinate_median"], "aggregators", "weighted_mean/coordinate_median"),
        (["aggregators.levels=trimmed_mean:0.1/weighted_mean"], "aggregators", "trimmed_mean:0.1/weighted_mean"),
        (["precision.remat=true"], "remat", True),
        (["failures.p_fail=0.1"], "failures", "FailureSimulator"),
        (["failures.straggler_sigma=0.3"], "stragglers", "StragglerModel"),
        (["run.checkpoint_dir=ckpt"], "checkpointer", "CheckpointManager"),
    ],
)
def test_features_of_items_5_8_and_9_build_on_the_cpu(overrides, attr, want, tmp_path, monkeypatch):
    """Robust aggregators, remat (item 8), failure and straggler models
    (9) and checkpointing (5), once raising their items, build into the
    runner."""
    from repro_torch.fed import scenarios

    monkeypatch.chdir(tmp_path)
    runner = scenarios.get("quickstart", overrides=overrides).build(device="cpu")
    if attr == "aggregators":
        got = runner.hier_config.aggregators.describe()
    elif attr == "remat":
        got = runner.hier_config.precision.remat
    else:
        got = type(getattr(runner, attr)).__name__
    assert got == want


@pytest.mark.parametrize(
    "overrides,error",
    [
        (["model.arch=lm-10m"], "'lm-10m' is a language model and needs data.dataset=tokens"),
        (["data.dataset=tokens"], "data.dataset=tokens needs a language model, got model.arch='mlp'"),
        (["model.lr_schedule=warmup_cosine"], None),
    ],
)
def test_lm_options_on_quickstart_behave_like_jax(overrides, error):
    """The LM options, once raising item 13, now do what the JAX package
    does on the MLP quickstart: an LM on gaussians and tokens on the MLP
    raise JAX's ValueError, and ``warmup_cosine`` builds."""
    from repro_torch.fed import scenarios

    spec = scenarios.get("quickstart", overrides=overrides)
    if error is None:
        assert spec.build(device="cpu").optimizer is not None
    else:
        with pytest.raises(ValueError, match=re.escape(error)):
            spec.build(device="cpu")


@pytest.mark.parametrize(
    "name,overrides",
    [
        ("quickstart", ["schedule.async_cloud=true", "run.num_rounds=2"]),
        ("quickstart", ["deadline.enabled=true", "run.num_rounds=2"]),
        ("straggler_tail", []),
        ("stale_decay", ["run.num_rounds=10", "run.eval_every=10"]),
        ("deadline_straggler", ["run.num_rounds=10", "run.eval_every=10"]),
        ("fedbuff_k4", ["run.num_rounds=10", "run.eval_every=10"]),
    ],
)
def test_features_of_item_11_build_on_the_cpu(name, overrides, recwarn):
    """The deadline engine and the scenarios of item 11, once raising it,
    run: a deadline configuration (``async_cloud`` maps to one, with a
    DeprecationWarning) through the ``DeadlineEngine``, a simulator
    scenario into a synchronous runner (its ``network`` section is inert
    for training) and a replay."""
    from repro_torch import sim
    from repro_torch.fed import scenarios
    from repro_torch.fed.engine import DeadlineEngine

    assert name in scenarios.names()
    spec = scenarios.get(name, overrides=overrides)
    if spec.network.is_active:
        assert spec.build(device="cpu").deadline is None
        assert sim.simulate_spec(spec).round_time.shape == (1,)
    else:
        runner, _ = spec.run_experiment(device="cpu")
        assert type(runner._engine) is DeadlineEngine and len(runner.history) == spec.run.num_rounds


def test_unknown_scenario_lists_the_ported_ones():
    from repro_torch.fed import scenarios

    with pytest.raises(ValueError, match="quickstart"):
        scenarios.get("no_such_scenario")
    assert scenarios.names() == sorted([
        "quickstart", "favg", "hierfavg_iid", "hierfavg_edge_iid", "hierfavg_edge_niid",
        "kappa_sweep_fast", "edge_only", "ragged_edges", "three_level", "int8_cloud", "int8_ef_both",
        "lm_edge_niid", "trimmed_edge", "median_cloud", "trimmed_int8", "n1m_cohort4096",
        "congested_backhaul", "hetero_clients_assoc", "straggler_tail", "deadline_straggler", "fedbuff_k4",
        "stale_decay",
    ])


def test_kernel_sources_build_for_hopper():
    from repro_torch.kernels import _build

    assert _build.SOURCES == ("hier_aggregate", "quantize", "megakernel", "flash_attention", "rglru_scan")
    assert all((_build.CSRC / f"{name}.cu").exists() for name in _build.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
