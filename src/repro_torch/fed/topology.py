"""Topology bookkeeping: N clients / L edges / cloud <-> a client mesh.

Copy-port of ``repro.fed.topology`` (126 lines, numpy): ``MeshFedPlan``,
``plan_for_mesh``, ``plan_for_hierarchy``, ``replica_groups``,
``edge_replica_groups``, ``pod_of_edge`` and ``client_weights``. The plans
take any mesh with ``axis_names`` and ``shape``, the port's
``dist.sharding.RankMesh`` (one ``"clients"`` axis of K ranks) among
them. The federated axes are ``("pod", "data")`` where the mesh has them:
clients shard over them, edges are contiguous groups of clients and pods
contiguous groups of edges. A client mesh has neither, so its plans have
no federated axes and one pod; the client-sharded engine places clients
with ``core.hierarchy.plan_shard_placement`` instead. ``replica_groups``
gives each level's client groups, the groups a grouped collective at that
hop would reduce over.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.hierarchy import HierarchySpec, as_hierarchy
from repro_torch.core.hierfavg import FedTopology


@dataclasses.dataclass(frozen=True)
class MeshFedPlan:
    """Concrete client->device assignment for a given mesh."""

    topology: FedTopology
    fed_axes: Tuple[str, ...]  # mesh axes the client dim is sharded over
    num_pods: int
    edges_per_pod: int
    hierarchy: Optional[HierarchySpec] = None  # ragged tree (None -> uniform)

    @property
    def num_clients(self) -> int:
        # the spec is authoritative for ragged trees (the uniform FedTopology
        # view is only exact for equal fan-out)
        return self.spec.num_clients

    @property
    def num_edges(self) -> int:
        return self.spec.num_nodes(1)

    @property
    def spec(self) -> HierarchySpec:
        return self.hierarchy if self.hierarchy is not None else as_hierarchy(self.topology)


def plan_for_mesh(
    mesh,
    *,
    edges_per_pod: int,
    clients_per_edge: int,
) -> MeshFedPlan:
    """Build the topology for a mesh with ("pod",)? ("data","model") axes.

    Total clients N = num_pods * edges_per_pod * clients_per_edge. The
    client axis is sharded over ("pod","data") (or ("data",) single-pod);
    N must be a multiple of the product of those axis sizes OR divide it
    evenly (both directions shard cleanly under GSPMD).
    """
    axis_names = mesh.axis_names
    num_pods = mesh.shape["pod"] if "pod" in axis_names else 1
    fed_axes = tuple(a for a in ("pod", "data") if a in axis_names)
    topo = FedTopology(num_edges=num_pods * edges_per_pod, clients_per_edge=clients_per_edge)
    return MeshFedPlan(
        topology=topo, fed_axes=fed_axes, num_pods=num_pods, edges_per_pod=edges_per_pod
    )


def plan_for_hierarchy(mesh, spec: HierarchySpec) -> MeshFedPlan:
    """Build a plan for an arbitrary ragged tree on a ("pod",)? ("data","model")
    mesh. The client axis is sharded over the federated axes exactly as in
    the uniform case — segment boundaries need not align with device
    boundaries (segment_sum lowers to grouped collectives over whichever
    devices hold the segment's rows)."""
    axis_names = mesh.axis_names
    num_pods = mesh.shape["pod"] if "pod" in axis_names else 1
    fed_axes = tuple(a for a in ("pod", "data") if a in axis_names)
    num_edges = spec.num_nodes(1)
    sizes = spec.group_sizes(1)
    # the uniform FedTopology view (used by two-level consumers) is exact
    # only for equal fan-out; ragged plans expose the spec directly
    cpe = int(sizes[0]) if spec.is_uniform(1) else int(round(spec.num_clients / num_edges))
    topo = FedTopology(num_edges=num_edges, clients_per_edge=max(cpe, 1))
    return MeshFedPlan(
        topology=topo,
        fed_axes=fed_axes,
        num_pods=num_pods,
        edges_per_pod=max(num_edges // num_pods, 1),
        hierarchy=spec,
    )


def replica_groups(plan_or_spec, level: int = 1) -> List[List[int]]:
    """Client-index groups for the level-``level`` grouped collective —
    the expected replica_groups of the lowered HLO at that hop."""
    if isinstance(plan_or_spec, MeshFedPlan):
        spec = plan_or_spec.spec
    else:
        spec = as_hierarchy(plan_or_spec)
    return spec.replica_groups(level)


def edge_replica_groups(plan: MeshFedPlan) -> List[List[int]]:
    """Client-index groups for edge aggregation (contiguous blocks)."""
    return replica_groups(plan, 1)


def pod_of_edge(plan: MeshFedPlan, edge: int) -> int:
    return edge // plan.edges_per_pod


def client_weights(data_sizes: Sequence[float]) -> np.ndarray:
    return np.asarray(data_sizes, np.float64)
