"""Helpers of the port's script tests: a port run held to the same spec
trained by the JAX package from the same init."""
import jax
import pytest

from repro.fed import api as japi

BAND = 0.01  # accuracy: the runs' tolerance, and the band around alpha where steps-to-alpha may differ


def jax_spec(tspec):
    """The JAX package's spec of the same fields."""
    return japi.ExperimentSpec.from_dict(tspec.to_dict())


def jax_init(tspec):
    """The JAX package's init of ``tspec``'s model, carried into the port."""
    jspec = jax_spec(tspec)
    np_params = jax.device_get(jspec.init_params(jax.random.PRNGKey(jspec.run.seed + 1)))
    return tspec.params_from_numpy(np_params, "cpu")


def held_to_jax(tr, overrides=()):
    """Train ``tr``'s spec (with ``overrides``) in the JAX package from the
    same init and hold the port's run to it; returns JAX's runner."""
    jspec = jax_spec(tr.spec).with_overrides(overrides)
    assert jspec.describe() == tr.spec.describe()
    jr, _ = jspec.run_experiment()
    assert len(tr.history) == len(jr.history)
    for a, b in zip(jr.history, tr.history):
        assert (b.round, b.step, b.mask_alive) == (a.round, a.step, a.mask_alive)
        assert b.loss == pytest.approx(a.loss, rel=1e-4), f"{jspec.name} round {a.round} loss"
        assert b.grad_norm == pytest.approx(a.grad_norm, rel=1e-4), f"{jspec.name} round {a.round} grad_norm"
        assert (a.accuracy is None) == (b.accuracy is None)
        if a.accuracy is not None:
            assert abs(b.accuracy - a.accuracy) <= BAND, f"{jspec.name} round {a.round} accuracy"
        for f in ("sim_time_s", "sim_energy_j", "wire_mb"):
            assert getattr(b, f) == pytest.approx(getattr(a, f), rel=1e-12), f
        assert b.wall_clock_s == a.wall_clock_s
    return jr


def clear_crossing(jr, alpha):
    """True when no eval up to JAX's first crossing of ``alpha`` lies within
    ``BAND`` of it."""
    for h in jr.history:
        if h.accuracy is None:
            continue
        if abs(h.accuracy - alpha) <= BAND:
            return False
        if h.accuracy >= alpha:
            return True
    return True
