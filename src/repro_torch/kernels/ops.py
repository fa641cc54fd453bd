"""Public kernel API, mirroring ``repro.kernels.ops``.

Each call goes to the hand-written CUDA kernel for a CUDA tensor and to
the kernel's plain PyTorch version for a CPU tensor (decided in
``kernels.hier_aggregate`` by the tensor's device). Kernels of later slices
(K3-K8 in ROADMAP.md Queue 2) join here as they are ported.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import hier_aggregate as _ha


def grouped_mean(x: torch.Tensor, weights: torch.Tensor, num_groups: int) -> torch.Tensor:
    """K1: equal contiguous groups of the (N, D) rows."""
    return _ha.grouped_mean(x, weights, num_groups)


def segment_mean(x: torch.Tensor, weights: torch.Tensor, segment_ids, num_segments: int) -> torch.Tensor:
    """K2: ragged groups over sorted host-side segment ids (N,). Callers
    that may hold equal blocks pick K1 themselves (``core.aggregation``
    decides once per level)."""
    return _ha.segment_mean(x, weights, segment_ids, num_segments)
