"""Helpers of the port's LM training tests: ``lm_edge_niid`` run through
both packages from the JAX init (carried across with
``params_from_numpy``) and held together.

Tolerances: every record's loss and grad_norm ``rtol=1e-4``, as the MLP
scenarios; final parameters ``atol=1e-5``; ``wire_mb`` equal. Adam needed
nothing looser: a run whose warmup is one step longer misses both
(``test_torch_lm_train_scenario.py``'s control).
"""
import jax
import pytest

from repro.fed import scenarios as jscen
from repro_torch.fed import scenarios as tscen
from repro_torch.testing.parity import assert_close, to_numpy

LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-5
# one cloud interval (kappa (4, 2): 8 local steps, inside the 20-step warmup)
LM_SHORT = ["run.num_rounds=2", "data.num_samples=128"]
INT8_EF = ["run.num_rounds=2", "data.num_samples=128", "transport.levels=int8_ef:128/int8_ef:128"]


def run_both(overrides, port_overrides=()):
    """JAX's ``lm_edge_niid`` run and the port's (with ``port_overrides``
    too) from the JAX init: ((runner, state), (runner, state))."""
    jspec = jscen.get("lm_edge_niid", overrides=overrides)
    tspec = tscen.get("lm_edge_niid", overrides=list(overrides) + list(port_overrides))
    np_params = jax.device_get(jspec.init_params(jax.random.PRNGKey(jspec.run.seed + 1)))
    jr, js = jspec.run_experiment()
    tr, ts = tspec.run_experiment(device="cpu", params=tspec.params_from_numpy(np_params, "cpu"))
    return (jr, js), (tr, ts)


def check_lm_run(jr, js, tr, ts):
    """The scenario's tolerance: every record's loss and grad_norm within
    ``LOSS_RTOL``, wire_mb equal, final parameters within ``PARAM_ATOL``."""
    assert len(tr.history) == len(jr.history) == jr.cfg.num_rounds
    for a, b in zip(jr.history, tr.history):
        assert (b.round, b.step, b.mask_alive) == (a.round, a.step, a.mask_alive)
        assert b.loss == pytest.approx(a.loss, rel=LOSS_RTOL), f"round {a.round} loss {b.loss} vs {a.loss}"
        assert b.grad_norm == pytest.approx(a.grad_norm, rel=LOSS_RTOL), f"round {a.round} grad_norm"
        assert a.accuracy is None and b.accuracy is None
        assert b.sim_time_s == a.sim_time_s == 0.0 and b.sim_energy_j == a.sim_energy_j == 0.0
        assert b.wire_mb == pytest.approx(a.wire_mb, rel=1e-12)
    assert int(ts.step) == int(js.step)
    assert_close(to_numpy(ts.params), jax.device_get(js.params), rtol=0.0, atol=PARAM_ATOL, what="final params")
