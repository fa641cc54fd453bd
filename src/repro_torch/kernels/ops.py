"""Public kernel API, mirroring ``repro.kernels.ops``.

Each call goes to the hand-written CUDA kernel for a CUDA tensor and to
the kernel's plain PyTorch version for a CPU tensor (decided in
``kernels.hier_aggregate`` (K1, K2, K6), ``kernels.quantize`` (K4, K5),
``kernels.megakernel`` (K3), ``kernels.flash_attention`` (K7) and
``kernels.rglru_scan`` (K8) by the tensor's device). The LM layers reach K7
and K8 through those modules directly, on the model's own layout.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import hier_aggregate as _ha
from repro_torch.kernels import megakernel as _mk
from repro_torch.kernels import quantize as _qz
from repro_torch.kernels import rglru_scan as _rg


def grouped_mean(x: torch.Tensor, weights: torch.Tensor, num_groups: int) -> torch.Tensor:
    """K1: equal contiguous groups of the (N, D) rows."""
    return _ha.grouped_mean(x, weights, num_groups)


def segment_mean(x: torch.Tensor, weights: torch.Tensor, segment_ids, num_segments: int, *,
                 offsets=None) -> torch.Tensor:
    """K2: ragged groups over sorted host-side segment ids (N,). Callers
    that may hold equal blocks pick K1 themselves (``core.aggregation``
    decides once per level). ``offsets``: K2's ``segment_table`` of those
    ids, already on the device (a cohort's, uploaded by the prefetcher)."""
    return _ha.segment_mean(x, weights, segment_ids, num_segments, offsets=offsets)


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


def edge_interval(params: torch.Tensor, inputs: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor, *,
                  num_edges: int, feat: int, lr: float, momentum: float = 0.0, mu=None):
    """K3: kappa1 local SGD(+momentum) steps of every flat-row linear client
    plus the trailing per-edge weighted mean, one call per edge interval.
    The engine's client-blocked path is ``core.hierfavg.build_megakernel_super_round``,
    which does not call this. Returns (params (N, P), losses (N, kappa1),
    mu (N, P))."""
    return _mk.edge_interval(params, inputs, targets, weights, num_edges=num_edges, feat=feat, lr=lr,
                             momentum=momentum, mu=mu)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """K7 on (BH, S, d) with batch and heads folded: (BH, Sq, d) in q's
    dtype. The CUDA kernel picks its own tiles, so JAX's ``block_q`` /
    ``block_k`` have no counterpart."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"flash_attention: want (BH, S, d) inputs, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    out = _fa.attention(q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2), causal=causal, window=window)
    return out.squeeze(2)


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """K8: (h (B, S, D) f32, hT (B, D) f32). The CUDA kernel picks its own
    channel tiles, so JAX's ``block_d`` has no counterpart."""
    return _rg.rglru_scan(a, b, h0)
