"""The slice as a whole on the CPU: scenarios run end to end through both
packages' ``ExperimentSpec.run_experiment`` from the same init (the JAX
init carried across with ``params_from_numpy``) and their histories agree.

Tolerances: per-round loss ``rtol=1e-4`` (f32 drift over 32 local steps;
the losses fall to ~1e-3, where the logsumexp's cancellation amplifies an
ulp of the logits), accuracy within 0.01, final parameters ``atol=1e-4``.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.fed import api as japi
from repro.fed import runner as jrunner
from repro.fed import scenarios as jscen
from repro_torch.fed import api as tapi
from repro_torch.fed import runner as trunner
from repro_torch.fed import scenarios as tscen
from repro_torch.testing.parity import assert_close, to_numpy


def _run_both(name, overrides):
    jspec = jscen.get(name, overrides=overrides)
    tspec = tscen.get(name, overrides=overrides)
    np_params = jax.device_get(jspec.init_params(jax.random.PRNGKey(jspec.run.seed + 1)))
    jr, js = jspec.run_experiment()
    tr, ts = tspec.run_experiment(device="cpu", params=tspec.params_from_numpy(np_params, "cpu"))
    return (jr, js), (tr, ts)


def _check_histories(jr, tr):
    assert len(tr.history) == len(jr.history)
    for a, b in zip(jr.history, tr.history):
        assert (b.round, b.step, b.mask_alive) == (a.round, a.step, a.mask_alive)
        assert b.loss == pytest.approx(a.loss, rel=1e-4), f"round {a.round} loss"
        assert b.grad_norm == pytest.approx(a.grad_norm, rel=1e-4), f"round {a.round} grad_norm"
        assert (a.accuracy is None) == (b.accuracy is None)
        if a.accuracy is not None:
            assert abs(b.accuracy - a.accuracy) <= 0.01, f"round {a.round} accuracy"
        assert b.sim_time_s == pytest.approx(a.sim_time_s, rel=1e-12)
        assert b.sim_energy_j == pytest.approx(a.sim_energy_j, rel=1e-12)
        assert b.wire_mb == pytest.approx(a.wire_mb, rel=1e-12)


@pytest.mark.parametrize(
    "name,overrides",
    [
        ("quickstart", ["run.num_rounds=8"]),
        ("ragged_edges", ["run.num_rounds=4"]),
        ("three_level", ["run.num_rounds=10", "run.eval_every=10", "data.num_samples=1000"]),
    ],
)
def test_scenario_tracks_jax(name, overrides):
    (jr, js), (tr, ts) = _run_both(name, overrides)
    _check_histories(jr, tr)
    assert_close(to_numpy(ts.params), jax.device_get(js.params), rtol=0.0, atol=1e-4, what=f"{name} final params")
    assert int(ts.step) == int(js.step)


def test_target_accuracy_stops_at_the_same_round():
    (jr, _), (tr, _) = _run_both("quickstart", ["run.num_rounds=8", "run.target_accuracy=0.7"])
    assert len(tr.history) == len(jr.history) == 4
    _check_histories(jr, tr)


@pytest.mark.parametrize("name,overrides", [
    ("quickstart", ["run.num_rounds=9"]),  # 4 intervals, then a per-round remainder
    ("ragged_edges", ["run.num_rounds=20", "run.eval_every=10", "data.num_samples=600"]),
])
def test_per_round_and_superround_engines_give_the_same_history(name, overrides):
    spec = tscen.get(name, overrides=overrides)
    params = spec.init_params(1, "cpu")
    runs = {}
    for engine in ("per_round", "auto"):
        s = spec.with_overrides([f"run.engine={engine}"])
        runner, state = s.run_experiment(device="cpu", params={k: v.clone() for k, v in params.items()})
        runs[engine] = (runner.records_to_dict(), state)
    (ha, sa), (hb, sb) = runs["per_round"], runs["auto"]
    assert ha == hb  # same ops in the same order: identical, not just close
    for k in sa.params:
        assert np.array_equal(to_numpy(sa.params[k]), to_numpy(sb.params[k]))


def test_superround_engine_refuses_a_finer_eval_cadence():
    spec = tscen.get("quickstart", overrides=["run.num_rounds=8", "run.eval_every=3", "run.engine=superround"])
    with pytest.raises(ValueError, match="kappa2_effective"):
        spec.run_experiment(device="cpu")


@pytest.mark.parametrize("name", tscen.names())
def test_spec_json_round_trips_between_packages(name):
    jspec = jscen.get(name)
    tspec = tapi.ExperimentSpec.from_json(jspec.to_json())
    assert tspec == tscen.get(name)
    assert tspec.to_json() == jspec.to_json()
    assert japi.ExperimentSpec.from_json(tspec.to_json()) == jspec
    assert tspec.describe() == jspec.describe()


@pytest.mark.parametrize("overrides", [
    ["schedule.kappas=4,2", "run.num_rounds=12"],
    ["topology.fanouts=3,5,2/2,1/2", "schedule.kappas=2,2,2"],
    ["data.partition=iid", "model.lr=0.05", "schedule.sync_opt_state=true", "model.optimizer=adam"],
])
def test_dotted_overrides_match(overrides):
    assert tapi.ExperimentSpec.parse(overrides).to_dict() == japi.ExperimentSpec.parse(overrides).to_dict()


@pytest.mark.parametrize("bad", ["run.no_such=1", "run=3", "run.num_rounds=x", "noequals", "schedule.kappas=a,b"])
def test_bad_overrides_raise_like_jax(bad):
    with pytest.raises(ValueError):
        japi.ExperimentSpec.parse([bad])
    with pytest.raises(ValueError):
        tapi.ExperimentSpec.parse([bad])


def test_records_and_config_fields_match_jax():
    assert [f.name for f in dataclasses.fields(trunner.RoundRecord)] == [
        f.name for f in dataclasses.fields(jrunner.RoundRecord)
    ]
    runner, _ = tscen.get("quickstart", overrides=["run.num_rounds=4"]).run_experiment(device="cpu")
    cols = runner.records_to_dict()
    assert set(cols) == {f.name for f in dataclasses.fields(trunner.RoundRecord)}
    assert cols["round"] == [0, 1, 2, 3] and cols["step"] == [4, 8, 12, 16]
    assert json.dumps(cols)  # plain Python values, no tensors
    assert runner.spec.name == "quickstart"


def test_params_from_numpy_checks_names_shapes_and_dtypes():
    spec = tscen.get("quickstart")
    good = {"w1": np.zeros((16, 48), np.float32), "b1": np.zeros(48, np.float32),
            "w2": np.zeros((48, 10), np.float32), "b2": np.zeros(10, np.float32)}
    out = spec.params_from_numpy(good, "cpu")
    assert sorted(out) == ["b1", "b2", "w1", "w2"] and out["w1"].shape == (16, 48)
    with pytest.raises(ValueError, match="names"):
        spec.params_from_numpy({**good, "extra": np.zeros(1, np.float32)}, "cpu")
    with pytest.raises(ValueError, match="shape"):
        spec.params_from_numpy({**good, "w1": np.zeros((16, 47), np.float32)}, "cpu")
    with pytest.raises(ValueError, match="dtype"):
        spec.params_from_numpy({**good, "b2": np.zeros(10, np.float64)}, "cpu")


def test_port_init_is_seeded_and_shaped_like_jax():
    spec = tscen.get("quickstart")
    a, b = spec.init_params(3, "cpu"), spec.init_params(3, "cpu")
    jp = jax.device_get(jscen.get("quickstart").init_params(jax.random.PRNGKey(3)))
    for k in jp:
        assert np.array_equal(a[k].numpy(), b[k].numpy())
        assert a[k].shape == jp[k].shape and a[k].numpy().dtype == jp[k].dtype
    assert abs(float(a["w1"].std()) - 0.25) < 0.05  # N(0, 1) * 0.25 like the JAX init


def test_run_consumes_the_state_but_not_the_init_params():
    """The port updates stacked parameters in place (the counterpart of the
    JAX engine's donated state); the unstacked init is copied, not reused."""
    spec = tscen.get("quickstart", overrides=["run.num_rounds=2"])
    params = spec.init_params(1, "cpu")
    before = {k: v.clone() for k, v in params.items()}
    runner = spec.build(device="cpu")
    state = runner.init(torch.Generator().manual_seed(0), params)
    stacked = state.params["b2"]
    out = runner.run(state)
    for k in params:
        assert np.array_equal(params[k].numpy(), before[k].numpy())
    assert int(out.step) == 8 and int(state.step) == 0
    assert not np.array_equal(stacked.numpy(), np.zeros_like(stacked.numpy()))  # trained in place
