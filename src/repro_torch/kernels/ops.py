"""Public kernel API, mirroring ``repro.kernels.ops``.

Each call goes to the hand-written CUDA kernel for a CUDA tensor and to
the kernel's plain PyTorch version for a CPU tensor (decided in
``kernels.hier_aggregate`` and ``kernels.quantize`` by the tensor's
device). Kernels of later slices (K3, K7, K8 in ROADMAP.md Queue 2) join
here as they are ported.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import hier_aggregate as _ha
from repro_torch.kernels import quantize as _qz


def grouped_mean(x: torch.Tensor, weights: torch.Tensor, num_groups: int) -> torch.Tensor:
    """K1: equal contiguous groups of the (N, D) rows."""
    return _ha.grouped_mean(x, weights, num_groups)


def segment_mean(x: torch.Tensor, weights: torch.Tensor, segment_ids, num_segments: int) -> torch.Tensor:
    """K2: ragged groups over sorted host-side segment ids (N,). Callers
    that may hold equal blocks pick K1 themselves (``core.aggregation``
    decides once per level)."""
    return _ha.segment_mean(x, weights, segment_ids, num_segments)


def segment_dequant_mean(q: torch.Tensor, scales: torch.Tensor, weights: torch.Tensor, segment_ids,
                         num_segments: int) -> torch.Tensor:
    """K6: K2's ragged groups over int8 codes (N, D) and block scales
    (N, D / qblock), decoded on the fly; f32 out."""
    return _ha.segment_dequant_mean(q, scales, weights, segment_ids, num_segments)


def quantize_int8(x: torch.Tensor, qblock: int = 256):
    """K4 on a whole tensor: (q (R, qblock) int8, scales (R, 1), shape)."""
    return _qz.quantize_int8(x, qblock)


def quantize_stacked(x: torch.Tensor, qblock: int = 256):
    """K4 on (N, D) client rows: (q (N, Dp) int8, scales (N, Dp / qblock))."""
    return _qz.quantize_stacked(x, qblock)


def dequantize_int8(q: torch.Tensor, s: torch.Tensor, shape: Sequence[int], dtype=torch.float32) -> torch.Tensor:
    """K5, the inverse of ``quantize_int8``."""
    return _qz.dequantize_int8(q, s, shape, dtype)


def dequantize_stacked(q: torch.Tensor, scales: torch.Tensor, d: int, dtype=torch.float32) -> torch.Tensor:
    """K5, the inverse of ``quantize_stacked``: (N, d) rows in ``dtype``."""
    return _qz.dequantize_stacked(q, scales, d, dtype)
