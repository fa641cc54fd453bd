"""Analytic per-link traffic of the HierFAVG collective schedule.

Copy-port of ``repro.dist.collectives.hierarchy_traffic_per_step``
(numpy), which ``RoundRecord.wire_mb`` reads. Ring model: an all-reduce of
S bytes over n participants moves 2*S*(n-1)/n per participant; level l's hop
is a grouped all-reduce over each tier-l node's children every prod(kappa[:l])
steps, and the per-level figure is the maximum over groups (the bottleneck
link).
"""
from __future__ import annotations

from math import prod
from typing import List, Sequence

import numpy as np


def ring_allreduce_bytes(payload_bytes: float, participants: int) -> float:
    """Per-participant wire bytes of a ring all-reduce."""
    n = max(int(participants), 1)
    return 2.0 * payload_bytes * (n - 1) / n


def hierarchy_traffic_per_step(
    per_dev_bytes: float,
    spec,  # core.hierarchy.HierarchySpec
    kappas: Sequence[int],
) -> List[float]:
    """Per-level bottleneck bytes per local step of the fp32 payload,
    bottom-up (level 1 = edge hop ... level depth = cloud hop). Per-level
    codec bit widths come with the transport slice."""
    kv = tuple(int(k) for k in kappas)
    if len(kv) != spec.depth:
        raise ValueError(f"kappas {kv} vs hierarchy depth {spec.depth}")
    out = []
    for level in range(1, spec.depth + 1):
        parents = np.asarray(spec.parents[level - 1])
        sizes = np.bincount(parents, minlength=spec.num_nodes(level))
        out.append(ring_allreduce_bytes(per_dev_bytes, int(sizes.max())) / prod(kv[:level]))
    return out
