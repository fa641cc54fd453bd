"""The robust scenarios end to end through both packages'
``ExperimentSpec.run_experiment`` on both engines, from the same init (the
JAX init carried across): the trimmed edge sync under client failures,
the coordinate-median cloud sync and eval model, the trimmed edge sync
over an int8 cloud hop, with ``test_torch_runner.py``'s tolerances (loss
and grad norm ``rtol=1e-4``, accuracy within 0.01, final parameters
``atol=1e-4``), in a file of their own so the suite's workers share the
work out.
"""
import os
import sys

import jax
import pytest
import torch

from repro_torch.testing.parity import assert_close, to_numpy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_scenario_runs import check_histories, run_both  # noqa: E402


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread a test: the runs' tensors are small, and beside
    the suite's other workers a product spread over every core only
    contends."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("engine", ["per_round", "auto"])
@pytest.mark.parametrize("name,overrides", [
    ("trimmed_edge", ["run.num_rounds=8"]),
    ("median_cloud", ["run.num_rounds=10", "run.eval_every=10", "data.num_samples=1000"]),
    ("trimmed_int8", ["run.num_rounds=10", "run.eval_every=10", "data.num_samples=1000"]),
])
def test_robust_scenarios_track_jax(name, overrides, engine):
    """The robust scenarios on both engines: the trimmed edge sync under
    client failures (its survivors round by round equal to JAX's), the
    coordinate-median cloud sync and eval model, and the trimmed edge sync
    over an int8 cloud hop."""
    (jr, js), (tr, ts) = run_both(name, overrides + [f"run.engine={engine}"])
    assert (tr._engine is None) == (engine == "per_round")
    check_histories(jr, tr)
    assert_close(to_numpy(ts.params), jax.device_get(js.params), rtol=0.0, atol=1e-4, what=f"{name} final params")
    if name == "trimmed_edge":
        assert min(h.mask_alive for h in tr.history) < tr.topology.num_clients
