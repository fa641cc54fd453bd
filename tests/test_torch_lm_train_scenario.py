"""``lm_edge_niid`` at lm-10m in the port against the JAX package, on the
CPU, over one cloud interval (2 rounds of kappa (4, 2): 8 local steps,
inside the scenario's 20-step warmup; the cosine half of the schedule runs
in ``test_torch_hierfavg.py``'s LM engine test, warmup 2 of 8 steps), with
``torch_lm_runs``'s tolerances, and the control: a warmup one step longer
(every learning rate 5 % lower) misses them.
"""
import os
import sys

import jax
import pytest
import torch

from repro.fed import scenarios as jscen
from repro_torch.fed import scenarios as tscen
from repro_torch.testing.parity import assert_close, to_numpy
from repro_torch.tree import leaves

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_lm_runs import LM_SHORT, PARAM_ATOL, check_lm_run, run_both  # noqa: E402


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread a test: the smoke and lm-10m tensors are small,
    and beside the suite's other workers a product spread over every core
    only contends."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lm_edge_niid_runs():
    return run_both(LM_SHORT)


def test_lm_edge_niid_tracks_jax(lm_edge_niid_runs):
    (jr, js), (tr, ts) = lm_edge_niid_runs
    check_lm_run(jr, js, tr, ts)
    assert tr.history[-1].loss < tr.history[0].loss
    assert tr.spec.model.arch == "lm-10m" and tr.eval_fn is None and tr.costs is None
    n_params = sum(x[0].numel() for x in leaves(ts.params))
    assert n_params == 3_410_176  # lm-10m at the scenario's vocabulary of 512


def test_the_lm_tolerance_fails_a_warmup_one_step_longer(lm_edge_niid_runs):
    """The control: the same run with ``model.warmup_steps`` 21 in place of
    20 (every learning rate 5 % lower) must miss the tolerance."""
    (jr, js), _ = lm_edge_niid_runs
    tspec = tscen.get("lm_edge_niid", overrides=LM_SHORT + ["model.warmup_steps=21"])
    np_params = jax.device_get(jscen.get("lm_edge_niid").init_params(jax.random.PRNGKey(1)))
    tr, ts = tspec.run_experiment(device="cpu", params=tspec.params_from_numpy(np_params, "cpu"))
    with pytest.raises(AssertionError):
        check_lm_run(jr, js, tr, ts)
    with pytest.raises(AssertionError):
        assert_close(to_numpy(ts.params), jax.device_get(js.params), rtol=0.0, atol=PARAM_ATOL, what="control")
