"""Client data partitioning (Section IV-A's non-IID protocols).

Copy-port of ``repro.data.partition``'s ``partition_hierarchy``,
``partition`` and ``partition_stats`` (numpy): same protocols, same
generator draws in the same order, so seeded partitions are byte-identical
to the JAX package's.

* ``iid``          — uniform random split.
* ``simple_niid``  — each client holds samples of ``classes_per_client``
  (=2) classes (McMahan-style shards).
* ``edge_iid``     — each client holds ONE class; each edge's clients cover
  distinct classes, so edge datasets are IID replicas.
* ``edge_niid``    — each client holds ONE class; each edge covers only
  ``classes_per_edge`` (=C/2) classes, so edges are non-IID.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _shards_by_class(labels: np.ndarray, rng: np.random.Generator) -> List[np.ndarray]:
    return [rng.permutation(np.where(labels == c)[0]) for c in range(int(labels.max()) + 1)]


def _balanced_take(pool: np.ndarray, count: int, cursor: int) -> Tuple[np.ndarray, int]:
    """Take ``count`` indices from pool starting at cursor, wrapping."""
    n = pool.shape[0]
    idx = np.arange(cursor, cursor + count) % n
    return pool[idx], (cursor + count) % n


def partition_iid(labels: np.ndarray, num_clients: int, rng: np.random.Generator) -> List[np.ndarray]:
    perm = rng.permutation(labels.shape[0])
    return [np.sort(s) for s in np.array_split(perm, num_clients)]


def partition_simple_niid(
    labels: np.ndarray,
    num_clients: int,
    rng: np.random.Generator,
    *,
    classes_per_client: int = 2,
) -> List[np.ndarray]:
    """Sort by label, slice into num_clients * classes_per_client shards,
    deal each client k shards."""
    order = np.argsort(labels, kind="stable")
    shards = np.array_split(order, num_clients * classes_per_client)
    shard_ids = rng.permutation(len(shards))
    out = []
    for i in range(num_clients):
        take = shard_ids[i * classes_per_client : (i + 1) * classes_per_client]
        out.append(np.sort(np.concatenate([shards[s] for s in take])))
    return out


def partition_hierarchy(
    kind: str,
    labels: np.ndarray,
    spec,  # core.hierarchy.HierarchySpec
    rng: np.random.Generator,
    **kw,
) -> List[np.ndarray]:
    """Partition for a (possibly ragged) ``HierarchySpec``: each edge deals
    to however many clients it has. ``iid``/``simple_niid`` ignore the tree
    shape; ``edge_iid``/``edge_niid`` walk the level-1 fan-out."""
    n = spec.num_clients
    if kind == "iid":
        return partition_iid(labels, n, rng)
    if kind == "simple_niid":
        return partition_simple_niid(labels, n, rng, **kw)
    if kind not in ("edge_iid", "edge_niid"):
        raise ValueError(f"unknown partition kind: {kind}")

    num_classes = int(labels.max()) + 1
    sizes = spec.group_sizes(1)
    if kind == "edge_iid" and int(sizes.max()) > num_classes:
        raise ValueError("edge_iid needs clients_per_edge <= num_classes at every edge")
    pools = _shards_by_class(labels, rng)
    cursors = [0] * num_classes
    per_client = labels.shape[0] // n
    out: List[np.ndarray] = []
    for l, c_l in enumerate(sizes):
        cpe = kw.get("classes_per_edge", 0) or max(int(c_l) // 2, 1)
        base = (l * cpe) % num_classes
        for j in range(int(c_l)):
            if kind == "edge_iid":
                c = (j + l) % num_classes
            else:
                c = (base + (j % cpe)) % num_classes
            take, cursors[c] = _balanced_take(pools[c], per_client, cursors[c])
            out.append(np.sort(take))
    return out


def partition(
    kind: str,
    labels: np.ndarray,
    num_edges: int,
    clients_per_edge: int,
    rng: np.random.Generator,
    **kw,
) -> List[np.ndarray]:
    """``partition_hierarchy`` on the uniform two-level tree of
    ``num_edges`` x ``clients_per_edge`` clients (the launchers' form)."""
    from repro_torch.core.hierarchy import HierarchySpec

    return partition_hierarchy(kind, labels, HierarchySpec.uniform(num_edges, clients_per_edge), rng, **kw)


def partition_stats(parts: List[np.ndarray], labels: np.ndarray) -> np.ndarray:
    """(num_clients, num_classes) label histogram — used by tests and the
    divergence probes to verify the protocol produced the intended skew."""
    num_classes = int(labels.max()) + 1
    out = np.zeros((len(parts), num_classes), np.int64)
    for i, idx in enumerate(parts):
        out[i] = np.bincount(labels[idx], minlength=num_classes)
    return out
