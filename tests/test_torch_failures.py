"""The port's failure models (``repro_torch.fed.failures``, a numpy
copy-port) against the JAX package's: masks from the same seeds are bit
identical over 50 steps, ``state_dict``s round-trip, mask composition
keeps its channels; and the runner's mask path (per-round loop and
superround engine) records the same survivors and tracks JAX's histories.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.hierarchy import parse_fanouts as jparse
from repro.fed import api as japi
from repro.fed import failures as jf
from repro.fed import scenarios as jscen
from repro_torch.core.hierarchy import parse_fanouts as tparse
from repro_torch.fed import api as tapi
from repro_torch.fed import failures as tf
from repro_torch.fed import scenarios as tscen
from repro_torch.fed.runner import FederatedRunner
from repro_torch.testing.parity import assert_close, to_numpy

STEPS = 50


@pytest.mark.parametrize("n,p_fail,p_recover,seed", [(20, 0.05, 0.5, 1), (50, 0.3, 0.2, 7), (8, 0.9, 0.9, 0)])
def test_failure_masks_are_bit_identical_to_jax(n, p_fail, p_recover, seed):
    j = jf.FailureSimulator(n, p_fail=p_fail, p_recover=p_recover, seed=seed)
    t = tf.FailureSimulator(n, p_fail=p_fail, p_recover=p_recover, seed=seed)
    for _ in range(STEPS):
        a, b = j.step(), t.step()
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("n,sigma,mean_s,seed,kappa1", [(20, 0.3, 1.0, 1, 4), (50, 1.0, 0.5, 2, 6)])
def test_straggler_masks_and_deadlines_are_bit_identical_to_jax(n, sigma, mean_s, seed, kappa1):
    j = jf.StragglerModel(n, mean_step_s=mean_s, sigma=sigma, seed=seed)
    t = tf.StragglerModel(n, mean_step_s=mean_s, sigma=sigma, seed=seed)
    assert np.array_equal(j.slowness, t.slowness)
    for pct in (90.0, 95.0, 99.0, 50.0):
        assert t.deadline_for(kappa1, percentile=pct) == j.deadline_for(kappa1, percentile=pct)
    for i in range(STEPS):
        deadline = None if i % 2 else 0.9 * kappa1 * mean_s
        (a, da), (b, db) = j.survivors(kappa1, deadline), t.survivors(kappa1, deadline)
        assert np.array_equal(a, b) and da == db


@pytest.mark.parametrize("tree,tier", [("5,5,5,5/4", 1), ("16,12,10,7,5/5", 1), ("10,10,10,10,10/3,2/2", 2)])
def test_subtree_outage_masks_are_bit_identical_to_jax(tree, tier):
    j = jf.SubtreeOutageSimulator(jparse(tree), tier=tier, p_fail=0.3, p_recover=0.4, seed=5)
    t = tf.SubtreeOutageSimulator(tparse(tree), tier=tier, p_fail=0.3, p_recover=0.4, seed=5)
    for _ in range(STEPS):
        assert np.array_equal(j.step(), t.step())
    with pytest.raises(ValueError, match="tier 3 outside 1..2"):
        tf.SubtreeOutageSimulator(tparse("5,5/2"), tier=3)


@pytest.mark.parametrize("make", [
    lambda m: m.FailureSimulator(30, p_fail=0.2, seed=3),
    lambda m: m.StragglerModel(30, sigma=0.5, seed=4),
    lambda m: m.SubtreeOutageSimulator((jparse if m is jf else tparse)("10,10,10/3"), p_fail=0.3, seed=6),
], ids=["failures", "stragglers", "outage"])
def test_state_dicts_round_trip(make):
    """A model restored from the state after 20 steps continues exactly as
    the original (and as JAX's from the same point)."""
    step = lambda m: m.survivors(4)[0] if hasattr(m, "survivors") else m.step()
    t, j = make(tf), make(jf)
    for _ in range(20):
        step(t)
        step(j)
    saved = t.state_dict()
    restored = make(tf)
    restored.load_state_dict(saved)
    jrestored = make(jf)
    jrestored.load_state_dict(j.state_dict())
    for _ in range(STEPS - 20):
        a, b, c = step(t), step(restored), step(jrestored)
        assert np.array_equal(a, b) and np.array_equal(a, c)


@pytest.mark.parametrize("dead_n,late_n", [(0, 0), (1, 0), (0, 1), (2, 1), (1, 2)])
def test_mask_composition_matches_jax(dead_n, late_n):
    rng = np.random.default_rng(dead_n * 10 + late_n)
    dead = [(rng.random(12) > 0.3).astype(np.float32) for _ in range(dead_n)]
    late = [(rng.random(12) > 0.3).astype(np.float32) for _ in range(late_n)]
    j, t = jf.compose_masks(dead=dead, late=late), tf.compose_masks(dead=dead, late=late)
    for a, b in zip(j, t):
        assert (a is None) == (b is None) and (a is None or np.array_equal(a, b))
    assert (t.late_count, t.dead_count) == (j.late_count, j.dead_count)
    got, want = tf.combine_masks(*dead, *late), jf.combine_masks(*dead, *late)
    assert (got is None) == (want is None) and (want is None or np.array_equal(got, want))


@pytest.mark.parametrize("overrides", [["failures.p_fail=0.1"], ["failures.straggler_sigma=0.3"],
                                       ["failures.p_fail=0.2", "failures.straggler_sigma=0.5", "failures.seed=9"]])
def test_failure_spec_builds_models_like_jax(overrides):
    jspec, tspec = japi.ExperimentSpec.parse(overrides), tapi.ExperimentSpec.parse(overrides)
    (ja, jb), (ta, tb) = jspec.failures.build(50), tspec.failures.build(50)
    for jm, tm in ((ja, ta), (jb, tb)):
        assert (jm is None) == (tm is None)
        if tm is not None:
            assert type(tm).__name__ == type(jm).__name__
            for _ in range(10):
                step = (lambda m: m.survivors(6)[0]) if hasattr(tm, "survivors") else (lambda m: m.step())
                assert np.array_equal(step(jm), step(tm))
    assert tspec.describe() == jspec.describe()


# -- the runner's mask path ---------------------------------------------------------


def _run_both(name, overrides):
    jspec, tspec = jscen.get(name, overrides=overrides), tscen.get(name, overrides=overrides)
    np_params = jax.device_get(jspec.init_params(jax.random.PRNGKey(jspec.run.seed + 1)))
    jr, js = jspec.run_experiment()
    tr, ts = tspec.run_experiment(device="cpu", params=tspec.params_from_numpy(np_params, "cpu"))
    return (jr, js), (tr, ts)


@pytest.mark.parametrize("engine", ["per_round", "auto"])
def test_stragglers_and_failures_track_jax(engine):
    overrides = ["run.num_rounds=8", f"run.engine={engine}", "failures.p_fail=0.15",
                 "failures.straggler_sigma=0.4"]
    (jr, js), (tr, ts) = _run_both("quickstart", overrides)
    assert [h.mask_alive for h in tr.history] == [h.mask_alive for h in jr.history]
    assert min(h.mask_alive for h in tr.history) < 20
    for a, b in zip(jr.history, tr.history):
        assert b.loss == pytest.approx(a.loss, rel=1e-4)
        assert (a.accuracy is None) == (b.accuracy is None)
        if a.accuracy is not None:
            assert abs(b.accuracy - a.accuracy) <= 0.01
    assert_close(to_numpy(ts.params), jax.device_get(js.params), rtol=0.0, atol=1e-4, what="final params")


def test_engines_record_the_same_survivors_and_histories():
    spec = tscen.get("trimmed_edge", overrides=["run.num_rounds=8", "failures.straggler_sigma=0.3"])
    params = spec.init_params(1, "cpu")
    runs = {}
    for engine in ("per_round", "auto"):
        runner, state = spec.with_overrides([f"run.engine={engine}"]).run_experiment(
            device="cpu", params={k: v.clone() for k, v in params.items()})
        runs[engine] = (runner, state)
    (a, sa), (b, sb) = runs["per_round"], runs["auto"]
    assert b._engine is not None and a._engine is None
    assert [(h.mask_alive, h.loss, h.accuracy) for h in a.history] == [
        (h.mask_alive, h.loss, h.accuracy) for h in b.history]
    for k in sa.params:
        assert torch.equal(sa.params[k], sb.params[k])


def test_megakernel_names_the_runner_reasons_in_jax_words():
    spec = tscen.get("quickstart", overrides=["run.engine=megakernel", "run.num_rounds=2", "failures.p_fail=0.1"])
    runner = spec.build(device="cpu")
    assert runner._check_megakernel() == "failure/straggler masks need the scan-fused survival plumbing"
    runner, _ = spec.run_experiment(device="cpu")
    assert not runner._engine.uses_megakernel
    assert runner._engine.megakernel_reason == "failure/straggler masks need the scan-fused survival plumbing"

    plain = tscen.get("quickstart", overrides=["run.engine=megakernel"]).build(device="cpu")
    assert plain._check_megakernel() is None

    class Detector(FederatedRunner):
        def _mask_for_round(self):
            return np.ones(self.topology.num_clients, np.float32)

    plain.__class__ = Detector
    assert plain._check_megakernel() == "an overridden failure detector is a live per-round mask seam"


def test_straggler_deadline_percentile_sets_the_deadline():
    """``RunnerConfig.straggler_deadline_pct`` picks the deadline's
    percentile: 99 leaves at least as many clients in time as 95 (the
    default, JAX's masks) and 90 at most as many, round by round."""
    alive = {}
    for pct in (90.0, 95.0, 99.0):
        runner = tscen.get("quickstart", overrides=["failures.straggler_sigma=0.8"]).build(device="cpu")
        runner.cfg.straggler_deadline_pct = pct
        alive[pct] = [int(runner._mask_for_round().sum()) for _ in range(STEPS)]
    assert all(a <= b <= c for a, b, c in zip(alive[90.0], alive[95.0], alive[99.0]))
    assert sum(alive[90.0]) < sum(alive[99.0])
    j = jf.StragglerModel(20, sigma=0.8, seed=1)
    assert alive[95.0] == [int(j.survivors(4)[0].sum()) for _ in range(STEPS)]
