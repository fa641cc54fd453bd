"""The port's copy-ported host modules against the JAX package: seeded data,
partitions and batches byte-identical; hierarchy, cost and traffic
models equal."""
import numpy as np
import pytest

from repro.core import cost_model as jcm
from repro.core.hierarchy import HierarchySpec as JSpec, parse_fanouts as jparse
from repro.data.partition import partition_hierarchy as jpartition
from repro.data.pipeline import FederatedBatcher as JBatcher, SuperBatchPrefetcher as JPrefetcher
from repro.data.synthetic import clustered_gaussians as jgaussians
from repro.dist.collectives import hierarchy_traffic_per_step as jtraffic
from repro_torch.core import cost_model as tcm
from repro_torch.core.hierarchy import parse_fanouts as tparse
from repro_torch.data import (
    FederatedBatcher as TBatcher,
    SuperBatchPrefetcher as TPrefetcher,
    clustered_gaussians as tgaussians,
    partition_hierarchy as tpartition,
)
from repro_torch.dist.collectives import hierarchy_traffic_per_step as ttraffic

TREES = ["5,5,5,5/4", "10,10,10,10,10/5", "16,12,10,7,5/5", "10,10,10,10,10/3,2/2", "3,5,2/2,1/2"]


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("dim", [(16,), (4, 4, 1)])
def test_clustered_gaussians_byte_identical(seed, dim):
    kw = dict(num_samples=500, num_classes=10, dim=dim, class_sep=3.5)
    a = jgaussians(np.random.default_rng(seed), **kw)
    b = tgaussians(np.random.default_rng(seed), **kw)
    _same(a.x, b.x)
    _same(a.y, b.y)


@pytest.mark.parametrize("kind", ["iid", "simple_niid", "edge_iid", "edge_niid"])
@pytest.mark.parametrize("tree", ["5,5,5,5/4", "10,10,10,10,10/5", "10,7,5/3", "4,3,3,2/2,2/2"])
def test_partition_hierarchy_byte_identical(kind, tree):
    labels = jgaussians(np.random.default_rng(3), num_samples=600, dim=(4,)).y
    a = jpartition(kind, labels, jparse(tree), np.random.default_rng(11))
    b = tpartition(kind, labels, tparse(tree), np.random.default_rng(11))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        _same(x, y)


def test_partition_edge_niid_classes_per_edge_and_errors():
    labels = jgaussians(np.random.default_rng(0), num_samples=400, dim=(4,)).y
    a = jpartition("edge_niid", labels, jparse("6,6/2"), np.random.default_rng(1), classes_per_edge=2)
    b = tpartition("edge_niid", labels, tparse("6,6/2"), np.random.default_rng(1), classes_per_edge=2)
    for x, y in zip(a, b):
        _same(x, y)
    with pytest.raises(ValueError, match="edge_iid"):
        tpartition("edge_iid", labels, tparse("16,4/2"), np.random.default_rng(1))
    with pytest.raises(ValueError, match="unknown partition"):
        tpartition("dirichlet", labels, tparse("4,4/2"), np.random.default_rng(1))


def _batchers(seed=5, batch_size=4):
    data = jgaussians(np.random.default_rng(seed), num_samples=300, dim=(6,))
    parts = jpartition("edge_iid", data.y, jparse("5,5,5/3"), np.random.default_rng(seed))
    arrays = {"inputs": data.x, "targets": data.y}
    return (
        JBatcher(arrays, parts, batch_size=batch_size, seed=seed),
        TBatcher(arrays, parts, batch_size=batch_size, seed=seed),
    )


@pytest.mark.parametrize("count", [1, 3, 7])
def test_federated_batcher_blocks_byte_identical(count):
    jb, tb = _batchers()
    for _ in range(6):  # crosses client epoch boundaries (20 samples, b=4)
        a, b = jb.next_batches(count), tb.next_batches(count)
        assert sorted(a) == sorted(b)
        for k in a:
            _same(np.asarray(a[k]), b[k])
    assert jb.state_dict() == tb.state_dict()
    _same(jb.data_sizes, tb.data_sizes)


@pytest.mark.parametrize("rounds,steps", [(3, 2), (1, 4)])
def test_prefetcher_blocks_match_jax_prefetcher(rounds, steps):
    jb, tb = _batchers()
    jp = JPrefetcher(jb, rounds_per_block=rounds, steps_per_round=steps, num_blocks=3, use_thread=False)
    tp = TPrefetcher(tb, rounds_per_block=rounds, steps_per_round=steps, num_blocks=3, device="cpu")
    try:
        for _ in range(3):
            a, _ = jp.get()
            b = tp.get()
            for k in a:
                assert tuple(b[k].shape) == (rounds, steps, 15, 4) + a[k].shape[4:]
                _same(np.asarray(a[k]), b[k].numpy())
        with pytest.raises(RuntimeError, match="exhausted"):
            tp.get()
    finally:
        tp.stop()
        jp.stop()
    assert jb.state_dict() == tb.state_dict()


def test_prefetcher_surfaces_worker_failure():
    class Broken:
        def next_batches(self, count):
            raise OSError("disk gone")

    tp = TPrefetcher(Broken(), rounds_per_block=1, steps_per_round=1, num_blocks=1, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="prefetch worker failed"):
            tp.get()
    finally:
        tp.stop()


@pytest.mark.parametrize("tree", TREES)
def test_hierarchy_spec_matches(tree):
    a, b = jparse(tree), tparse(tree)
    assert a.parents == b.parents and a.depth == b.depth and a.num_clients == b.num_clients
    assert a.describe() == b.describe() and a.is_paper_topology == b.is_paper_topology
    for level in range(1, a.depth + 1):
        _same(a.segments(level), b.segments(level))
        assert a.num_nodes(level) == b.num_nodes(level)
        assert a.is_uniform(level) == b.is_uniform(level)
        _same(a.group_sizes(level), b.group_sizes(level))


@pytest.mark.parametrize("bad", ["", "3,0/1", "3,x/2", "2,2/3"])
def test_hierarchy_spec_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError):
        jparse(bad)
    with pytest.raises(ValueError):
        tparse(bad)


def test_uniform_hierarchy_and_fed_topology():
    from repro_torch.core.hierarchy import HierarchySpec, as_hierarchy
    from repro_torch.core.hierfavg import FedTopology

    assert HierarchySpec.uniform(4, 5).parents == JSpec.uniform(4, 5).parents
    assert as_hierarchy(FedTopology(4, 5)) == HierarchySpec.uniform(4, 5)
    assert FedTopology(4, 5).num_clients == 20
    with pytest.raises(TypeError):
        as_hierarchy(object())


@pytest.mark.parametrize("workload", ["mnist", "cifar10"])
@pytest.mark.parametrize("k1,k2", [(6, 10), (60, 1), (4, 2)])
def test_cost_model_matches(workload, k1, k2):
    a, b = jcm.paper_workload(workload), tcm.paper_workload(workload)
    assert dataclasses_equal(a, b)
    for k in (0, 1, k1, k1 * k2, 3 * k1 * k2 + 5):
        assert jcm.time_at_step(a, k1, k2, k) == tcm.time_at_step(b, k1, k2, k)
        assert jcm.energy_at_step(a, k1, k2, k) == tcm.energy_at_step(b, k1, k2, k)


def dataclasses_equal(a, b):
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("tree,kappas", [("5,5,5,5/4", (4, 2)), ("16,12,10,7,5/5", (6, 10)),
                                         ("10,10,10,10,10/3,2/2", (6, 5, 2))])
def test_hierarchy_traffic_matches(tree, kappas):
    assert jtraffic(1234.0, jparse(tree), kappas) == ttraffic(1234.0, tparse(tree), kappas)
