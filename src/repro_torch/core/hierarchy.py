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

``ShardPlacement`` / ``plan_shard_placement`` pack whole root-child
subtrees onto the ranks of a client mesh (``dist.sharding``), so that every
sync below the top stays on one rank; ``cohort_hierarchy`` /
``plan_cohort_placement`` do the same for a stratified cohort's slots.
"""
from __future__ import annotations

import dataclasses
import functools
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

    def fanouts(self) -> Tuple[Tuple[int, ...], ...]:
        """Inverse of ``from_fanouts``: child counts per node, bottom-up."""
        return tuple(tuple(int(c) for c in np.bincount(np.asarray(lvl, np.int64))) for lvl in self.parents)

    def fanouts_text(self) -> str:
        """The ``parse_fanouts`` grammar for this tree: ``parse_fanouts(
        spec.fanouts_text()) == spec``."""
        return "/".join(",".join(str(c) for c in lvl) for lvl in self.fanouts())

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

    def replica_groups(self, level: int) -> List[List[int]]:
        """Client-index groups for the level-``level`` grouped collective."""
        seg = self.segments(level)
        return [list(np.where(seg == g)[0]) for g in range(self.num_nodes(level))]

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


@functools.lru_cache(maxsize=16)
def _uniform(num_edges: int, clients_per_edge: int) -> HierarchySpec:
    """``HierarchySpec.uniform``, built once per shape: the spec is frozen,
    and building it walks every client in Python (0.4 s at 1,000,000
    clients, which a runner's setup would otherwise pay several times)."""
    return HierarchySpec.uniform(num_edges, clients_per_edge)


def as_hierarchy(topology: Union[HierarchySpec, "object"]) -> HierarchySpec:
    """Normalize a FedTopology (two-level uniform) or HierarchySpec."""
    if isinstance(topology, HierarchySpec):
        return topology
    # duck-typed FedTopology (avoids an import cycle with core.hierfavg)
    if hasattr(topology, "num_edges") and hasattr(topology, "clients_per_edge"):
        return _uniform(int(topology.num_edges), int(topology.clients_per_edge))
    raise TypeError(f"cannot interpret {type(topology).__name__} as a hierarchy")


# ---------------------------------------------------------------------------
# Edge-aligned client -> shard placement (the mesh-sharded superround)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardPlacement:
    """Edge-aligned client→shard placement for a ``"clients"`` mesh axis
    (copy-port of ``repro/core/hierarchy.py:191-304``; a shard is a rank of
    ``dist.sharding.RankMesh``).

    Permutes the stacked client axis so that every *alignment group* — the
    clients of one child subtree of the root, i.e. one ``segments(depth-1)``
    group (= one edge for the paper's two-level tree) — lands wholly inside
    one shard. Every aggregation level below the top then reduces entirely
    within a shard (no cross-device collective); only the top (cloud) sync
    crosses shards.

    Non-divisible packings pad: each shard is padded to ``capacity`` clients
    with *phantom* positions (``perm == -1``). Phantoms carry zero
    aggregation weight, reuse client 0's batch rows and RNG stream, and own
    a dedicated trailing local segment per level, so they can never perturb
    a real group's sums — padding is numerically inert (the +0.0 terms they
    contribute to weighted sums leave every bit unchanged).

    ``perm[p]`` maps padded position p → original client id (-1 = phantom);
    positions are shard-major: shard s owns ``[s*capacity, (s+1)*capacity)``.
    Within a shard, groups keep ascending group-id order and clients keep
    their original relative order, so shard-local segment reductions add
    members in exactly the single-device order.
    """

    num_shards: int
    capacity: int
    perm: Tuple[int, ...]
    spec: HierarchySpec

    def __post_init__(self):
        object.__setattr__(self, "perm", tuple(int(p) for p in self.perm))
        if len(self.perm) != self.num_shards * self.capacity:
            raise ValueError(
                f"perm has {len(self.perm)} positions, expected "
                f"num_shards*capacity = {self.num_shards * self.capacity}"
            )

    # -- shape queries ------------------------------------------------------

    @property
    def num_clients(self) -> int:
        return self.spec.num_clients

    @property
    def padded_clients(self) -> int:
        return self.num_shards * self.capacity

    @property
    def num_phantoms(self) -> int:
        return sum(1 for p in self.perm if p < 0)

    def valid(self) -> np.ndarray:
        """(padded,) bool: True at real-client positions, False at phantoms."""
        return np.asarray([p >= 0 for p in self.perm], bool)

    # -- layout maps --------------------------------------------------------

    def gather_index(self) -> np.ndarray:
        """(padded,) int32 original→padded gather map. Phantoms read client
        0 — their values are inert (zero weight, dedicated segment)."""
        return np.asarray([max(p, 0) for p in self.perm], np.int32)

    def positions(self) -> np.ndarray:
        """(N,) int32: each original client's position in the padded order
        (the inverse gather for un-sharding)."""
        pos = np.full(self.num_clients, -1, np.int64)
        for where, orig in enumerate(self.perm):
            if orig >= 0:
                pos[orig] = where
        if (pos < 0).any():
            raise ValueError("placement dropped a client (corrupt perm)")
        return pos.astype(np.int32)

    def pad_weights(self, weights) -> np.ndarray:
        """(padded,) f32 permuted aggregation weights, phantoms zeroed."""
        w = np.asarray(weights, np.float32)[self.gather_index()]
        return np.where(self.valid(), w, np.float32(0.0)).astype(np.float32)

    # -- shard-local tree views ---------------------------------------------

    def local_segments(self, level: int) -> np.ndarray:
        """(num_shards, capacity) int32 shard-local segment ids at ``level``
        (1 <= level < depth): global ids relabeled densely per shard in
        order of appearance; phantoms take the dedicated last id."""
        if not 1 <= level <= self.spec.depth - 1:
            raise ValueError(
                f"shard-local segments exist for levels 1..{self.spec.depth - 1} "
                f"(the top level is the cross-shard reduction), got {level}"
            )
        seg = self.spec.segments(level)
        nseg = self.local_num_segments(level)
        out = np.zeros((self.num_shards, self.capacity), np.int32)
        for s in range(self.num_shards):
            row = self.perm[s * self.capacity : (s + 1) * self.capacity]
            local: dict = {}
            for j, orig in enumerate(row):
                if orig < 0:
                    out[s, j] = nseg - 1
                else:
                    out[s, j] = local.setdefault(int(seg[orig]), len(local))
        return out

    def local_num_segments(self, level: int) -> int:
        """Static per-shard segment count at ``level``: the heaviest shard's
        real segment count, plus one trailing phantom segment when padded."""
        seg = self.spec.segments(level)
        most = 0
        for s in range(self.num_shards):
            row = self.perm[s * self.capacity : (s + 1) * self.capacity]
            most = max(most, len({int(seg[p]) for p in row if p >= 0}))
        return most + (1 if self.num_phantoms else 0)

    def describe(self) -> str:
        return (
            f"{self.num_clients} clients -> {self.num_shards} shards x "
            f"{self.capacity} ({self.num_phantoms} phantom pad)"
        )


def plan_shard_placement(spec: HierarchySpec, num_shards: int) -> ShardPlacement:
    """Pack whole root-child subtrees onto shards, balanced by client count.

    Greedy LPT over the ``segments(depth-1)`` alignment groups (largest
    first onto the least-loaded shard, ties by id for determinism);
    ``capacity`` is the heaviest shard's client count and lighter shards pad
    with phantoms. Uniform trees whose group count divides ``num_shards``
    pack exactly (zero padding). Depth-1 trees (classic two-tier FedAvg)
    have no sub-cloud level: clients pack freely as singleton groups.
    """
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    n = spec.num_clients
    if spec.depth >= 2:
        seg = spec.segments(spec.depth - 1)
    else:
        seg = np.arange(n, dtype=np.int32)
    num_groups = int(seg.max()) + 1
    if num_groups < num_shards:
        raise ValueError(
            f"cannot shard {num_groups} aggregation subtree(s) over {num_shards} "
            f"devices: each shard needs at least one whole level-"
            f"{max(spec.depth - 1, 1)} subtree so sub-cloud syncs stay "
            f"device-local; use a mesh of <= {num_groups} devices or a finer tree"
        )
    members = [np.where(seg == g)[0] for g in range(num_groups)]
    order = sorted(range(num_groups), key=lambda g: (-len(members[g]), g))
    loads = [0] * num_shards
    assigned: List[List[int]] = [[] for _ in range(num_shards)]
    for g in order:
        s = min(range(num_shards), key=lambda k: (loads[k], k))
        assigned[s].append(g)
        loads[s] += len(members[g])
    capacity = max(loads)
    perm: List[int] = []
    for s in range(num_shards):
        row: List[int] = []
        for g in sorted(assigned[s]):
            row.extend(int(c) for c in members[g])
        row.extend([-1] * (capacity - len(row)))
        perm.extend(row)
    return ShardPlacement(num_shards=num_shards, capacity=capacity, perm=tuple(perm), spec=spec)


def cohort_hierarchy(spec: HierarchySpec, quotas) -> HierarchySpec:
    """The *slot* tree of a stratified cohort: ``quotas[e]`` cohort slots
    under level-1 node e, upper tiers unchanged.

    Slots stand in for the sampled clients; because stratified cohorts are
    sorted and edges are contiguous id ranges, slot j of every interval's
    cohort reports to the same edge — the cohort tree (and any placement
    planned from it) is a pure function of (topology, quotas).
    """
    q = np.asarray(quotas, np.int64)
    if spec.depth == 1:
        # depth-1 trees have one "edge" (the root); all slots report to it
        if q.shape != (1,) or int(q.sum()) < 1:
            raise ValueError(f"depth-1 tree needs a single root quota, got {q}")
        return HierarchySpec(parents=(tuple([0] * int(q[0])),))
    num_edges = spec.num_nodes(1)
    if q.shape != (num_edges,):
        raise ValueError(f"quotas must be ({num_edges},) (one per level-1 node), got {q.shape}")
    if np.any(q < 1):
        raise ValueError("every level-1 node needs >= 1 cohort slot (floor-1 quotas)")
    slot_parents = tuple(int(e) for e in np.repeat(np.arange(num_edges), q))
    return HierarchySpec(parents=(slot_parents,) + spec.parents[1:])


def plan_cohort_placement(spec: HierarchySpec, quotas, num_shards: int) -> ShardPlacement:
    """Edge-aligned shard placement for a stratified cohort's *slot* axis.

    ``plan_shard_placement`` over :func:`cohort_hierarchy`: whole root-child
    subtrees of slots pack onto shards, so every sub-top cohort sync stays
    device-local and the placement is reused for every sampled cohort
    (placement-stable packing). The returned placement's ``spec`` is the
    slot tree (``num_clients == sum(quotas)``); at ``cohort == population``
    the quotas equal the edge sizes and this is exactly
    ``plan_shard_placement(spec, num_shards)``.
    """
    return plan_shard_placement(cohort_hierarchy(spec, quotas), num_shards)
