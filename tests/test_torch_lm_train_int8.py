"""``lm_edge_niid`` at lm-10m with error-feedback int8 on both hops, in the
port against the JAX package, on the CPU, with ``torch_lm_runs``'s
tolerances and the kernels' calls counted.
"""
import os
import sys

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.tree import leaves

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_lm_runs import INT8_EF, check_lm_run, run_both  # noqa: E402


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread a test: the smoke and lm-10m tensors are small,
    and beside the suite's other workers a product spread over every core
    only contends."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_int8_ef_variant_tracks_jax_and_counts_its_calls(monkeypatch):
    """Error-feedback int8 on both hops over 2 rounds; on the CPU the
    kernels' plain versions run, one call per leaf per level mean (K1: the
    edge sync one stage, the cloud sync two) and per compressed sync (K4,
    K5), the counts ``chip_smoke.py`` asserts on the card."""
    calls = {"grouped_mean": 0, "quantize_stacked": 0, "dequantize_stacked": 0}
    for name in calls:
        def counted(*a, _f=getattr(ops, name), _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    (jr, js), (tr, ts) = run_both(INT8_EF)
    check_lm_run(jr, js, tr, ts)
    n_leaves = len(list(leaves(ts.params)))
    assert n_leaves == 12
    assert calls == {"grouped_mean": n_leaves * (1 + 2), "quantize_stacked": n_leaves * 2,
                     "dequantize_stacked": n_leaves * 2}
    assert tr.history[-1].wire_mb == pytest.approx(jr.history[-1].wire_mb, rel=1e-12)
