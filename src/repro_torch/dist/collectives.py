"""Analytic per-link traffic of the HierFAVG collective schedule.

Copy-port of ``repro.dist.collectives`` (numpy):
``hierarchy_traffic_per_step``, which ``RoundRecord.wire_mb`` reads, and
its two-level closed form ``hierfavg_traffic_per_step``. Ring model: an
all-reduce of S bytes over n participants moves 2*S*(n-1)/n per
participant; level l's hop
is a grouped all-reduce over each tier-l node's children every prod(kappa[:l])
steps, and the per-level figure is the maximum over groups (the bottleneck
link), at the level's codec bits per parameter.
"""
from __future__ import annotations

from math import prod
from typing import List, Optional, Sequence, Tuple

import numpy as np


def ring_allreduce_bytes(payload_bytes: float, participants: int) -> float:
    """Per-participant wire bytes of a ring all-reduce."""
    n = max(int(participants), 1)
    return 2.0 * payload_bytes * (n - 1) / n


def hierfavg_traffic_per_step(
    per_dev_bytes: float,
    clients_per_edge: int,
    num_edges: int,
    kappa1: int,
    kappa2: int,
    *,
    edge_bits_per_param: float = 32.0,
    cloud_bits_per_param: float = 32.0,
) -> Tuple[float, float]:
    """(edge_bytes_per_step, cloud_bytes_per_step) for the two-level tree.

    ``per_dev_bytes`` is the uncompressed fp32 payload; the per-hop
    bits-per-parameter (``fed.transport.TransportSpec.bits_per_param``)
    scale it to the compressed wire size.
    """
    edge_payload = per_dev_bytes * edge_bits_per_param / 32.0
    cloud_payload = per_dev_bytes * cloud_bits_per_param / 32.0
    edge = ring_allreduce_bytes(edge_payload, clients_per_edge) / kappa1
    cloud = ring_allreduce_bytes(cloud_payload, num_edges) / (kappa1 * kappa2)
    return edge, cloud


def hierarchy_traffic_per_step(
    per_dev_bytes: float,
    spec,  # core.hierarchy.HierarchySpec
    kappas: Sequence[int],
    *,
    bits_per_param: Optional[Sequence[float]] = None,
) -> List[float]:
    """Per-level bottleneck bytes per local step, bottom-up (level 1 = edge
    hop ... level depth = cloud hop). ``per_dev_bytes`` is the uncompressed
    fp32 payload; ``bits_per_param`` (one entry per level, bottom-up, as
    ``TransportSpec.bits_vector()`` gives them) rescales each hop to its
    codec's wire size; None means 32 bits everywhere."""
    kv = tuple(int(k) for k in kappas)
    if len(kv) != spec.depth:
        raise ValueError(f"kappas {kv} vs hierarchy depth {spec.depth}")
    if bits_per_param is None:
        bits = (32.0,) * spec.depth
    else:
        bits = tuple(float(b) for b in bits_per_param)
        if len(bits) != spec.depth:
            raise ValueError(f"bits_per_param {bits} vs hierarchy depth {spec.depth}")
        if any(b <= 0 for b in bits):
            raise ValueError(f"bits per parameter must be positive, got {bits}")
    out = []
    for level in range(1, spec.depth + 1):
        parents = np.asarray(spec.parents[level - 1])
        sizes = np.bincount(parents, minlength=spec.num_nodes(level))
        payload = per_dev_bytes * bits[level - 1] / 32.0
        out.append(ring_allreduce_bytes(payload, int(sizes.max())) / prod(kv[:level]))
    return out
