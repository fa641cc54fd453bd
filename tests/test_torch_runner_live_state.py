"""The caller's one live state across a run's intervals
(``state = runner.run(state)``), in a file of its own so the suite's
workers share the work out.
"""
import gc

import pytest
import torch

from repro_torch.fed import engine
from repro_torch.fed import scenarios as tscen
from repro_torch.tree import leaves as tleaves


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_the_caller_keeps_one_live_state_across_intervals(optimizer, monkeypatch):
    """``state = runner.run(state)`` keeps the caller's state alive for the
    whole run. Each interval's stacked leaves go back into its tensors, so
    every interval starts with the tensors the first one did and the same
    bytes live, give or take a batch (no second state beside the
    caller's), and the run ends in
    the caller's tensors with the values a run that holds no state gets.

    lm-10m on 4 clients over 2 intervals: the claim needs two intervals and
    a state that outweighs the batches, not the scenario's 8 clients and 3
    intervals. It runs on one intra-op thread: with torch's default (one a
    core) the lm-10m steps slowed down tenfold when other test workers
    loaded every core (434 s against 55 s on 2 threads beside five busy
    processes on 8 cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _one_live_state(optimizer, monkeypatch, engine, gc)
    finally:
        torch.set_num_threads(threads)


def _one_live_state(optimizer, monkeypatch, engine, gc):
    def live_bytes():
        gc.collect()
        storages = {}
        for o in gc.get_objects():
            if isinstance(o, torch.Tensor) and not o.is_meta:
                storages[o.untyped_storage().data_ptr()] = o.untyped_storage().nbytes()
        return sum(storages.values())

    overrides = ["run.num_rounds=4", "run.eval_every=0", "topology.clients_per_edge=2", f"model.optimizer={optimizer}"]
    spec = tscen.get("lm_edge_niid", overrides=overrides)
    params = spec.init_params(1, "cpu")
    runner = spec.build(device="cpu")
    state = runner.init(torch.Generator().manual_seed(0), params)
    seen = []
    dispatch = engine.SuperRoundEngine._dispatch_interval

    def spied(self, s, *a, **k):
        seen.append(([id(x) for x in tleaves(s.params)], live_bytes()))
        return dispatch(self, s, *a, **k)

    monkeypatch.setattr(engine.SuperRoundEngine, "_dispatch_interval", spied)
    out = runner.run(state)
    monkeypatch.setattr(engine.SuperRoundEngine, "_dispatch_interval", dispatch)
    assert len(seen) == 2
    assert all(ids == seen[0][0] for ids, _ in seen)
    # a second state would add every stacked leaf's bytes; the prefetched
    # batch block and the metrics come and go
    state_bytes = sum(x.numel() * x.element_size() for x in tleaves((state.params, state.opt_state)) if x.dim())
    assert max(b for _, b in seen) - seen[0][1] < state_bytes / 4
    assert all(a is b for a, b in zip(tleaves(out.params), tleaves(state.params)))
    fresh = spec.build(device="cpu")
    want = fresh.run(fresh.init(torch.Generator().manual_seed(0), params))
    for a, b in zip(tleaves(out.params), tleaves(want.params)):
        assert torch.equal(a, b)
    assert [h.loss for h in runner.history] == [h.loss for h in fresh.history]


