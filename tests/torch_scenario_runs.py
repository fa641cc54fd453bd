"""Helpers of the port's scenario tests (``test_torch_runner*.py``): a
scenario run through both packages' ``ExperimentSpec.run_experiment`` from
the same init (the JAX init carried across with ``params_from_numpy``),
and their histories held together (loss and grad norm ``rtol=1e-4``,
accuracy within 0.01, the cost columns equal)."""
import jax
import pytest

from repro.fed import scenarios as jscen
from repro_torch.fed import scenarios as tscen


def run_both(name, overrides):
    """JAX's run and the port's of scenario ``name`` with ``overrides``."""
    jspec = jscen.get(name, overrides=overrides)
    tspec = tscen.get(name, overrides=overrides)
    np_params = jax.device_get(jspec.init_params(jax.random.PRNGKey(jspec.run.seed + 1)))
    jr, js = jspec.run_experiment()
    tr, ts = tspec.run_experiment(device="cpu", params=tspec.params_from_numpy(np_params, "cpu"))
    return (jr, js), (tr, ts)


def check_histories(jr, tr):
    """Every record of the two runs within the tolerances above."""
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
