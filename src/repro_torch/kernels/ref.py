"""The plain versions that sit beside each kernel, under the JAX package's
oracle names (``repro.kernels.ref``) and with its argument layouts.

Each name calls the plain PyTorch version of its kernel on any device and
never launches the kernel. Where the JAX oracle takes another layout the
adapter reshapes: ``attention_ref`` takes JAX's (BH, S, d) heads (the
plain version takes the model's (B, S, H, hd)); ``quantize_ref`` /
``dequantize_ref`` take a whole tensor (the plain versions take stacked
(N, D) rows). ``segment_mean_ref``'s and ``segment_dequant_mean_ref``'s
``block_d`` is JAX's column tile for its one-hot products; the plain
versions sum per segment with ``index_add_`` and take no tile.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.kernels.flash_attention import attention_plain
from repro_torch.kernels.hier_aggregate import grouped_mean_plain, segment_dequant_mean_plain, segment_mean_plain
from repro_torch.kernels.megakernel import edge_interval_plain
from repro_torch.kernels.quantize import dequantize_stacked_plain, quantize_stacked_plain
from repro_torch.kernels.rglru_scan import rglru_scan_plain

__all__ = [
    "attention_ref",
    "dequantize_ref",
    "edge_interval_ref",
    "grouped_mean_ref",
    "quantize_ref",
    "rglru_scan_ref",
    "segment_dequant_mean_ref",
    "segment_mean_ref",
]

grouped_mean_ref = grouped_mean_plain


def segment_mean_ref(x: torch.Tensor, weights: torch.Tensor, segment_ids, num_segments: int,
                     block_d: int = 512) -> torch.Tensor:
    """K2's function: (N, D) rows -> per-segment weighted means broadcast
    back, zero-weight segments keeping their rows, in x's dtype."""
    return segment_mean_plain(x, weights, segment_ids, num_segments)


def segment_dequant_mean_ref(q: torch.Tensor, scales: torch.Tensor, weights: torch.Tensor, segment_ids,
                             num_segments: int, block_d: int = 512) -> torch.Tensor:
    """K6's function: int8 (N, D) rows decoded by their (N, D / qblock)
    scales, then K2's function, f32 out."""
    return segment_dequant_mean_plain(q, scales, weights, segment_ids, num_segments)


def edge_interval_ref(params: torch.Tensor, inputs: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor,
                      num_edges: int, *, feat: int, lr: float, momentum: float = 0.0,
                      mu: Optional[torch.Tensor] = None):
    """K3's function: (aggregated params (N, P), losses (N, kappa1) f32,
    mu (N, P)); momentum without ``mu`` starts from zeros, as JAX's oracle."""
    if momentum and mu is None:
        mu = torch.zeros_like(params)
    return edge_interval_plain(params, inputs, targets, weights, num_edges=num_edges, feat=feat, lr=lr,
                               momentum=momentum, mu=mu)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                  window: int = 0) -> torch.Tensor:
    """K7's function on (BH, S, d) heads."""
    return attention_plain(q[:, :, None], k[:, :, None], v[:, :, None], causal=causal, window=window)[:, :, 0]


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """K8's function: h_t = a_t h_{t-1} + b_t over (B, S, D), h_0 = h0;
    (h (B, S, D) f32, hT (B, D) f32)."""
    return rglru_scan_plain(a, b, h0)


def quantize_ref(x: torch.Tensor, qblock: int = 256):
    """K4's function on a whole tensor: (q (R, qblock) int8, s (R, 1) f32,
    shape), the flattened tensor zero-padded to R * qblock values."""
    q, s = quantize_stacked_plain(x.reshape(1, -1), qblock)
    return q.reshape(-1, qblock), s.reshape(-1, 1), tuple(x.shape)


def dequantize_ref(q: torch.Tensor, s: torch.Tensor, shape: Sequence[int], dtype=torch.float32) -> torch.Tensor:
    """K5's function, the inverse of ``quantize_ref``."""
    out = dequantize_stacked_plain(q.reshape(1, -1), s.reshape(1, -1), math.prod(shape), dtype)
    return out.reshape(tuple(shape))
