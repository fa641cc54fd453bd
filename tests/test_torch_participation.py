"""The port's cohort samplers and population batchers against the JAX
package's: the same cohorts id for id, the same quotas and slot layout, the
same JSON-safe states and error texts, and bit-equal batches from
``VirtualClientBatcher`` and ``FederatedBatcher.next_batches_for``; plus
the laws of ``tests/test_participation.py`` as parametrised cases.

Everything here is numpy on both sides, so every comparison is exact.
"""
import json

import numpy as np
import pytest

from repro.core.hierarchy import parse_fanouts as jparse
from repro.data import pipeline as jpipe
from repro.fed import participation as jp
from repro_torch.core.hierarchy import parse_fanouts as tparse
from repro_torch.data import pipeline as tpipe
from repro_torch.fed import participation as tp

SHAPES = [(12, 5, 0), (64, 16, 3), (1000, 37, 11), (7, 7, 2)]


def _make(mod, kind, n, c, seed):
    if kind == "uniform":
        return mod.UniformSampler(n, c, seed)
    if kind == "round_robin":
        return mod.RoundRobinSampler(n, c, seed)
    sizes = np.random.default_rng(n).integers(1, 9, size=max(1, min(c, n // 2)))
    seg = np.repeat(np.arange(sizes.shape[0]), sizes)
    return mod.StratifiedSampler(seg.shape[0], min(c, seg.shape[0]), seg, seed)


def _valid(ids, n, c):
    assert ids.shape == (c,) and ids.dtype == np.int64
    assert np.all(np.diff(ids) > 0) and 0 <= ids[0] and ids[-1] < n


@pytest.mark.parametrize("kind", ["uniform", "round_robin", "stratified"])
@pytest.mark.parametrize("n,c,seed", SHAPES)
def test_samplers_draw_jax_cohorts_id_for_id(kind, n, c, seed):
    js, ts = _make(jp, kind, n, c, seed), _make(tp, kind, n, c, seed)
    for _ in range(10):
        got, want = ts.sample(), js.sample()
        _valid(got, ts.num_clients, ts.cohort_size)
        np.testing.assert_array_equal(got, want)
    assert ts.state_dict() == js.state_dict()


@pytest.mark.parametrize("kind", ["uniform", "round_robin", "stratified"])
def test_a_json_state_resumes_jax_sequence(kind):
    """The port's state survives json dumps/loads and replays the JAX
    sampler's stream; JAX's state loads into the port's sampler too, even
    one built with another seed."""
    js, ts = _make(jp, kind, 64, 16, 5), _make(tp, kind, 64, 16, 5)
    for _ in range(3):
        js.sample(), ts.sample()
    from_port, from_jax = _make(tp, kind, 64, 16, 6), _make(tp, kind, 64, 16, 6)
    from_port.load_state_dict(json.loads(json.dumps(ts.state_dict())))
    from_jax.load_state_dict(json.loads(json.dumps(js.state_dict())))
    for _ in range(5):
        want = js.sample()
        np.testing.assert_array_equal(from_port.sample(), want)
        np.testing.assert_array_equal(from_jax.sample(), want)


@pytest.mark.parametrize("sizes,c", [([1000] * 1000, 4096), ([5, 4, 3], 6), ([16, 12, 10, 7, 5], 5),
                                     ([2, 9, 1, 30], 40), ([3, 3, 3], 9), ([7], 3)])
def test_stratified_quotas_and_slot_edges_equal_jax(sizes, c):
    sizes = np.asarray(sizes)
    np.testing.assert_array_equal(tp.stratified_quotas(sizes, c), jp.stratified_quotas(sizes, c))
    np.testing.assert_array_equal(tp.stratified_slot_edges(sizes, c), jp.stratified_slot_edges(sizes, c))


@pytest.mark.parametrize("call", [
    lambda m: m.stratified_quotas(np.array([3, 3, 3]), 2),
    lambda m: m.stratified_quotas(np.array([2, 2]), 5),
    lambda m: m.stratified_quotas(np.array([0, 3]), 2),
    lambda m: m.ParticipationSpec(cohort_size=-1),
    lambda m: m.ParticipationSpec(cohort_size=4, sampler="lottery"),
    lambda m: m.UniformSampler(5, 6),
    lambda m: m.UniformSampler(5, 0),
    lambda m: m.StratifiedSampler(5, 3, np.zeros(4, np.int64)),
    lambda m: m.UniformSampler(10, 3).load_state_dict(m.RoundRobinSampler(10, 3).state_dict()),
    lambda m: m.build_sampler(m.ParticipationSpec(), jparse("2,3/2")),
    lambda m: m.build_sampler(m.ParticipationSpec(cohort_size=9), jparse("2,3/2")),
])
def test_value_errors_keep_jax_texts(call):
    with pytest.raises(ValueError) as want:
        call(jp)
    with pytest.raises(ValueError) as got:
        call(tp)
    assert str(got.value) == str(want.value)


# -- the laws of tests/test_participation.py ----------------------------------


@pytest.mark.parametrize("n,c", [(1, 1), (10, 3), (64, 64), (63, 8), (17, 16)])
def test_round_robin_covers_population(n, c):
    sampler = tp.RoundRobinSampler(n, c)
    seen = np.zeros(n, bool)
    for _ in range(-(-n // c)):
        ids = sampler.sample()
        _valid(ids, n, c)
        seen[ids] = True
    assert seen.all()


@pytest.mark.parametrize("n,c,seed", [(2, 1, 0), (128, 100, 3), (50, 7, 7)])
def test_uniform_seed_deterministic_and_resume_exact(n, c, seed):
    a, b = tp.UniformSampler(n, c, seed), tp.UniformSampler(n, c, seed)
    for _ in range(3):
        np.testing.assert_array_equal(a.sample(), b.sample())
    resumed = tp.UniformSampler(n, c, seed + 1)
    resumed.load_state_dict(json.loads(json.dumps(a.state_dict())))
    for _ in range(3):
        ids = a.sample()
        _valid(ids, n, c)
        np.testing.assert_array_equal(ids, resumed.sample())


@pytest.mark.parametrize("num_edges,extra,seed", [(2, 0, 0), (6, 10, 4), (4, 3, 9)])
def test_stratified_never_leaves_an_edge_empty(num_edges, extra, seed):
    sizes = np.random.default_rng(seed).integers(1, 9, size=num_edges)
    seg = np.repeat(np.arange(num_edges), sizes)
    n = int(seg.shape[0])
    c = min(n, num_edges + extra)
    sampler = tp.StratifiedSampler(n, c, seg)
    assert sampler.quotas.sum() == c
    assert (sampler.quotas >= 1).all() and (sampler.quotas <= sizes).all()
    for _ in range(2):
        ids = sampler.sample()
        _valid(ids, n, c)
        np.testing.assert_array_equal(np.bincount(seg[ids], minlength=num_edges), sampler.quotas)


@pytest.mark.parametrize("num_edges,seed", [(1, 0), (10, 5), (7, 9)])
def test_stratified_quota_laws(num_edges, seed):
    sizes = np.random.default_rng(seed).integers(1, 101, size=num_edges).astype(np.int64)
    total, floor = int(sizes.sum()), num_edges
    for c in sorted({floor, total, (floor + total) // 2}):
        q = tp.stratified_quotas(sizes, c)
        assert int(q.sum()) == c and (q >= 1).all() and (q <= sizes).all()


def test_participation_spec_and_build_sampler_dispatch():
    assert not tp.ParticipationSpec().is_active and tp.ParticipationSpec(cohort_size=4).is_active
    tree = tparse("2,3/2")
    assert isinstance(tp.ParticipationSpec(cohort_size=3, sampler="stratified").build_sampler(tree),
                      tp.StratifiedSampler)
    assert isinstance(tp.build_sampler(tp.ParticipationSpec(cohort_size=2, sampler="round_robin"), tree),
                      tp.RoundRobinSampler)
    assert isinstance(tp.build_sampler(tp.ParticipationSpec(cohort_size=2), tree), tp.UniformSampler)


# -- population batchers ---------------------------------------------------------


def _pool(n=300, dim=5):
    rng = np.random.default_rng(4)
    return {"inputs": rng.normal(size=(n, dim)).astype(np.float32),
            "targets": rng.integers(0, 10, size=n).astype(np.int32)}


def _cohorts():
    sampler = jp.UniformSampler(40, 12, seed=3)
    return [sampler.sample() for _ in range(6)]


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("count", [1, 8, 11])
def test_virtual_client_batches_equal_jax(count):
    """Several intervals of overlapping cohorts, with epochs wrapping
    (samples_per_client 16, batch 3), a state round trip in the middle."""
    kw = dict(num_clients=40, samples_per_client=16, batch_size=3, seed=7)
    jb, tb = jpipe.VirtualClientBatcher(_pool(), **kw), tpipe.VirtualClientBatcher(_pool(), **kw)
    for q, ids in enumerate(_cohorts()):
        _same(tb.next_batches_for(ids, count), jb.next_batches_for(ids, count))
        _same(tb.next_batch_for(ids), jb.next_batch_for(ids))
        state = json.loads(json.dumps(tb.state_dict()))
        assert state == json.loads(json.dumps(jb.state_dict()))
        if q == 2:
            tb = tpipe.VirtualClientBatcher(_pool(), **kw)
            tb.load_state_dict(state)
    np.testing.assert_array_equal(tb.data_sizes, jb.data_sizes)


def test_virtual_client_batcher_rejects_a_short_shard():
    for mod in (jpipe, tpipe):
        with pytest.raises(ValueError, match="samples_per_client 2 < batch_size 3"):
            mod.VirtualClientBatcher(_pool(), num_clients=4, samples_per_client=2, batch_size=3)


def test_federated_batcher_cohort_batches_equal_jax():
    pool = _pool()
    parts = [np.arange(i * 7, i * 7 + 7) for i in range(40)]
    jb = jpipe.FederatedBatcher(pool, parts, batch_size=3, seed=2)
    tb = tpipe.FederatedBatcher(pool, parts, batch_size=3, seed=2)
    for q, ids in enumerate(_cohorts()):
        _same(tb.next_batches_for(ids, 5), jb.next_batches_for(ids, 5))
        if q == 3:
            state = json.loads(json.dumps(tb.state_dict()))
            tb = tpipe.FederatedBatcher(pool, parts, batch_size=3, seed=2)
            tb.load_state_dict(state)
    # the full population in order is next_batch exactly
    ref = tpipe.FederatedBatcher(pool, parts, batch_size=3, seed=2)
    full = tpipe.FederatedBatcher(pool, parts, batch_size=3, seed=2)
    _same(full.next_batches_for(range(40), 4), ref.next_batches(4))
