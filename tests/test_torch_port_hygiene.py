"""The PyTorch port stands alone: it imports neither jax nor the JAX
package nor the JAX reproduction scripts (``benchmarks``), its entry
points (the figure and table scripts and the examples among them) default
to CUDA and refuse to fall back to the CPU; features of items once
unported build (items 16 and 16b: tensor parallelism over a "model" axis
larger than 1, where only a count that does not split is refused, by
name), and the hint mesh follows JAX's table."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro|benchmarks)(\.|\s|$)", re.MULTILINE)


def _port_files():
    # the modules of the port, the chip script, and the modules the tests'
    # spawned ranks import (they run without JAX)
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_sharded_runs.py",
                                         ROOT / "tests" / "torch_mp_ranks.py"]


def test_the_launch_modules_are_checked():
    names = {str(p.relative_to(PORT)) for p in _port_files() if PORT in p.parents}
    assert {"launch/mesh.py", "launch/specs.py", "launch/steps.py", "dist/sharding.py"} <= names


def test_the_analysis_and_library_modules_are_checked():
    names = {str(p.relative_to(PORT)) for p in _port_files() if PORT in p.parents}
    assert {"analysis/__init__.py", "analysis/roofline.py", "analysis/opcount.py", "core/convergence.py",
            "core/divergence.py", "core/reference.py", "kernels/ref.py", "models/cnn.py", "testing/property.py",
            "launch/dryrun.py", "experiments/roofline_report.py"} <= names


def test_the_script_and_example_modules_are_checked():
    names = {str(p.relative_to(PORT)) for p in _port_files() if PORT in p.parents}
    scripts = {"common", "table1_cost_model", "fig4_convergence", "table2_latency_energy", "fig2_topologies",
               "compression_tradeoff", "aggregation_scaling", "round_time_sim", "wallclock_curves", "__main__"}
    assert {f"experiments/{n}.py" for n in scripts} <= names
    assert {f"examples/{n}.py" for n in ("quickstart", "compare_topologies", "serve_lm", "train_hier_lm")} <= names


# The dry run (``launch.dryrun``) and its report (``experiments.roofline_report``)
# are not among these: the dry run counts ops on meta tensors over a fake
# process group and the report reads its JSON files, so neither touches a
# device, and neither has a CPU fallback to refuse.
def _entry_points():
    from repro_torch.examples import compare_topologies, quickstart, serve_lm, train_hier_lm
    from repro_torch.experiments import (aggregation_scaling, compression_tradeoff, fig2_topologies,
                                         fig4_convergence, round_time_sim, table1_cost_model,
                                         table2_latency_energy, wallclock_curves)

    return {
        **{m.__name__: (lambda m=m: m.cli([])) for m in (
            table1_cost_model, fig4_convergence, table2_latency_energy, fig2_topologies, compression_tradeoff,
            round_time_sim)},
        **{m.__name__: (lambda m=m: m.main([])) for m in (
            aggregation_scaling, wallclock_curves, quickstart, compare_topologies, serve_lm, train_hier_lm)},
        "fig4_convergence.main": lambda: fig4_convergence.main(),
        "round_time_sim.main": lambda: round_time_sim.main(),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_every_script_and_example_raises_without_a_gpu_and_a_device(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_the_scripts_runner_names_the_script_that_raised(monkeypatch, capsys):
    from repro_torch.experiments import __main__ as runner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="scripts failed: \\['table1_cost_model'\\]"):
        runner.main(["--only", "table1_cost_model"])
    assert "no CUDA device" in capsys.readouterr().out


def test_importing_every_port_module_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'repro', 'benchmarks'))\n"
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


class _Mesh:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


def _model_axis_refused(sharding):
    # tensor parallelism runs every family (items 16 and 16b): only a count
    # that does not split is refused, by name and without a ROADMAP item
    import dataclasses

    from repro_torch.configs.registry import get_smoke

    for arch in ("recurrentgemma-9b", "xlstm-350m", "deepseek-v3-671b", "arctic-480b", "deepseek-7b"):
        sharding.refuse_model_axis(_Mesh(data=2, model=2), get_smoke(arch))
    with pytest.raises(ValueError, match=r'RG-LRU width d_rnn 66 do not split over a "model" axis of 4'):
        sharding.refuse_model_axis(_Mesh(data=2, model=4),
                                   dataclasses.replace(get_smoke("recurrentgemma-9b"), d_rnn=66))
    sharding.refuse_model_axis(_Mesh(data=2, model=1), get_smoke("recurrentgemma-9b"))  # a "model" axis of 1 is none
    assert sharding.hint_mesh() is None


def _ep_mode_follows_jax(sharding):
    # JAX's table (repro/dist/sharding.py:84-98): "ep_data" on a data axis of
    # size > 1 that divides the expert count, "none" otherwise and off-mesh
    assert sharding.moe_ep_mode(256) == "none"
    for shape, experts, want in ((dict(data=2, model=1), 256, "ep_data"), (dict(data=3), 256, "none"),
                                 (dict(data=1), 256, "none"), (dict(pod=2, model=1), 256, "none"),
                                 (dict(data=4), 8, "ep_data")):
        with sharding.using_hint_mesh(_Mesh(**shape)):
            assert sharding.moe_ep_mode(experts) == want, shape
    with pytest.raises(ValueError, match="unknown ep mode: none"):
        sharding.moe_dispatch_exchange(None, "none")


@pytest.mark.parametrize("case", [_model_axis_refused, _ep_mode_follows_jax], ids=["model_axis", "ep_mode"])
def test_unported_features_name_their_roadmap_item(case):
    from repro_torch.dist import sharding

    case(sharding)


@pytest.mark.parametrize("overrides", [["participation.cohort_size=8", "topology.mesh_axes=clients"],
                                       ["topology.mesh_axes=clients"]])
def test_the_item_12_mesh_refusals_are_gone(overrides):
    """A mesh now needs a process group (``dist.launch.spawn``) and names how
    to start one; the sharded cohort swap runs."""
    import numpy as np

    from repro_torch.core.hierarchy import parse_fanouts, plan_shard_placement
    from repro_torch.fed import scenarios
    from repro_torch.fed.client_store import ClientStateStore

    spec = scenarios.get("quickstart", overrides=overrides)
    with pytest.raises(RuntimeError, match="torch.distributed process group.*spawn"):
        spec.build(device="cpu")
    store = ClientStateStore(4, {"m": np.zeros(2, np.float32)})
    placement = plan_shard_placement(parse_fanouts("2,2"), 2)
    store.scatter_placed(np.arange(4), placement, {"m": np.ones((4, 2), np.float32)})
    assert store.gather_placed(np.arange(4), placement)["m"].sum() == 8 and store.num_touched == 4


@pytest.mark.parametrize("name", ["dist/sharding.py", "dist/launch.py", "fed/topology.py", "checkpoint/reshard.py"])
def test_the_multi_device_modules_stand_alone(name):
    path = PORT / name
    assert path in _port_files()
    assert not _FORBIDDEN.findall(path.read_text())


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


@pytest.mark.parametrize("arch", ["xlstm-350m", "deepseek-v3-671b", "arctic-480b"])
def test_the_item_13_archs_build(arch):
    """MLA, MoE, mLSTM and sLSTM, once raising item 13, build: the smoke
    config initialises and serves a step. xlstm-350m is also an LM that the
    LM scenario trains (its published config at the scenario's vocabulary),
    and on the MLP quickstart it needs token data, as lm-10m does there;
    the scenarios refuse the MLA and MoE archs with the words JAX's
    scenarios refuse every registry arch with."""
    import dataclasses

    from repro_torch.configs.registry import get_config, get_smoke
    from repro_torch.fed import api, scenarios
    from repro_torch.launch import serve

    out = serve.serve(get_smoke(arch), batch=1, prompt_len=4, gen=2, device="cpu")
    assert tuple(out["tokens"].shape) == (1, 2)
    spec = scenarios.get("lm_edge_niid", overrides=[f"model.arch={arch}"])
    if arch != "xlstm-350m":
        with pytest.raises(ValueError, match=re.escape(f"model.arch must be one of ('mlp',) + ('lm-10m', "
                                                       f"'lm-100m'), got '{arch}'")):
            spec.build(device="cpu")
        return
    assert api._lm_config(spec) == dataclasses.replace(get_config(arch), vocab_size=512)
    with pytest.raises(ValueError, match=re.escape(f"model.arch='{arch}' is a language model and needs")):
        scenarios.get("quickstart", overrides=[f"model.arch={arch}"]).build(device="cpu")


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
