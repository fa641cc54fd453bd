"""Multi-tier ragged hierarchies: the segment-id tree model.

Copy-port of ``repro.core.hierarchy`` (numpy only). The paper's
client-edge-cloud tree is two aggregation levels with equal fan-out;
``HierarchySpec`` describes an arbitrary-depth ragged tree by **parent
vectors**:

    parents[t][i] = index of the tier-(t+1) node that tier-t node i reports to

Tier 0 nodes are clients; the last tier is the single cloud root.
Aggregation level l in {1..depth} averages clients within their tier-l
ancestor: level 1 is edge aggregation, level ``depth`` is cloud
aggregation. ``segments(level)`` is the sorted (N,) client->ancestor id
vector the aggregation operators and kernel K2 reduce over.

Shard placement (``ShardPlacement`` and the planners) waits for the
multi-device slice.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class HierarchySpec:
    """An arbitrary-depth ragged aggregation tree over N clients.

    parents: tuple of int tuples, bottom-up. ``parents[t]`` maps tier-t
    nodes to tier-(t+1) nodes; tier 0 = clients, top tier = cloud (1 node).
    """

    parents: Tuple[Tuple[int, ...], ...]

    def __post_init__(self):
        if not self.parents:
            raise ValueError("HierarchySpec needs at least one level")
        norm = tuple(tuple(int(p) for p in lvl) for lvl in self.parents)
        object.__setattr__(self, "parents", norm)
        for t, lvl in enumerate(norm):
            arr = np.asarray(lvl, np.int64)
            if arr.size == 0:
                raise ValueError(f"level {t}: empty parent vector")
            if arr.min() < 0:
                raise ValueError(f"level {t}: negative parent id")
            if np.any(np.diff(arr) < 0):
                raise ValueError(
                    f"level {t}: parent ids must be non-decreasing "
                    "(children of a node must be contiguous)"
                )
            if np.any(np.diff(arr) > 1) or arr[0] != 0:
                raise ValueError(f"level {t}: parent ids must be dense 0..P-1 (empty parent)")
            n_parents = int(arr.max()) + 1
            if t + 1 < len(norm) and n_parents != len(norm[t + 1]):
                raise ValueError(
                    f"level {t}: {n_parents} parents but level {t+1} has "
                    f"{len(norm[t + 1])} nodes"
                )
        if int(max(norm[-1])) != 0:
            raise ValueError("top level must map to a single cloud root")

    @classmethod
    def uniform(cls, num_edges: int, clients_per_edge: int) -> "HierarchySpec":
        """The paper's two-level equal-fan-out topology."""
        return cls.from_fanouts([[clients_per_edge] * num_edges, [num_edges]])

    @classmethod
    def from_fanouts(cls, fanouts: Sequence[Sequence[int]]) -> "HierarchySpec":
        """fanouts[t][p] = number of tier-t children of tier-(t+1) node p."""
        if not fanouts:
            raise ValueError("need at least one fan-out level")
        if len(fanouts[-1]) != 1:
            raise ValueError("last fan-out level must have exactly one (root) node")
        parents: List[Tuple[int, ...]] = []
        for t, level in enumerate(fanouts):
            if any(int(c) < 1 for c in level):
                raise ValueError(f"level {t}: every node needs >= 1 children")
            vec: List[int] = []
            for p, count in enumerate(level):
                vec.extend([p] * int(count))
            parents.append(tuple(vec))
            if t + 1 < len(fanouts) and len(level) != sum(int(c) for c in fanouts[t + 1]):
                raise ValueError(
                    f"level {t} has {len(level)} nodes but level {t+1} fans out "
                    f"to {sum(int(c) for c in fanouts[t + 1])}"
                )
        return cls(parents=tuple(parents))

    @property
    def depth(self) -> int:
        """Number of aggregation levels (2 for the paper's client-edge-cloud)."""
        return len(self.parents)

    @property
    def num_clients(self) -> int:
        return len(self.parents[0])

    def num_nodes(self, tier: int) -> int:
        """Node count at tier in {0..depth}; tier 0 = clients, depth = root."""
        if tier == 0:
            return self.num_clients
        return int(max(self.parents[tier - 1])) + 1

    def segments(self, level: int) -> np.ndarray:
        """(N,) int32 vector: each client's tier-``level`` ancestor id.
        Sorted by construction."""
        if not 1 <= level <= self.depth:
            raise ValueError(f"level must be in 1..{self.depth}, got {level}")
        seg = np.asarray(self.parents[0], np.int32)
        for t in range(1, level):
            seg = np.asarray(self.parents[t], np.int32)[seg]
        return seg

    def group_sizes(self, level: int) -> np.ndarray:
        """Clients per tier-``level`` node."""
        return np.bincount(self.segments(level), minlength=self.num_nodes(level))

    def is_uniform(self, level: int) -> bool:
        """True iff every tier-``level`` node aggregates the same number of
        clients."""
        sizes = self.group_sizes(level)
        return bool(np.all(sizes == sizes[0]))

    @property
    def is_paper_topology(self) -> bool:
        """Two levels, equal edges — reduces to ``FedTopology``."""
        return self.depth == 2 and self.is_uniform(1)

    def describe(self) -> str:
        tiers = [str(self.num_clients)] + [str(self.num_nodes(t)) for t in range(1, self.depth + 1)]
        shape = "ragged" if any(not self.is_uniform(l) for l in range(1, self.depth + 1)) else "uniform"
        return f"{'/'.join(tiers)} ({shape}, depth {self.depth})"


def parse_fanouts(text: str) -> HierarchySpec:
    """Parse a fan-out string, bottom-up, levels separated by '/'.

    ``"3,5,2/2,1/2"`` = edges with 3/5/2 clients, regions with 2/1 edges,
    cloud of 2 regions. A trailing root level of 1 may be omitted:
    ``"10,10,10,10,10/5"`` is the paper's 50/5 topology.
    """
    try:
        levels = [[int(x) for x in part.split(",") if x] for part in text.split("/") if part]
    except ValueError as e:
        raise ValueError(
            f"bad fan-out spec {text!r}: expected comma-separated counts with "
            f"'/' between levels, e.g. '3,5,2/2,1/2' ({e})"
        ) from None
    if not levels:
        raise ValueError(f"empty fan-out spec: {text!r}")
    if len(levels[-1]) != 1:
        levels.append([len(levels[-1])])
    return HierarchySpec.from_fanouts(levels)


def as_hierarchy(topology: Union[HierarchySpec, "object"]) -> HierarchySpec:
    """Normalize a FedTopology (two-level uniform) or HierarchySpec."""
    if isinstance(topology, HierarchySpec):
        return topology
    # duck-typed FedTopology (avoids an import cycle with core.hierfavg)
    if hasattr(topology, "num_edges") and hasattr(topology, "clients_per_edge"):
        return HierarchySpec.uniform(topology.num_edges, topology.clients_per_edge)
    raise TypeError(f"cannot interpret {type(topology).__name__} as a hierarchy")
