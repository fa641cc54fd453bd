"""K1 ``grouped_mean`` and K2 ``segment_mean``: the aggregation operator on
hand-written CUDA kernels (``csrc/hier_aggregate.cu``), each beside its
plain PyTorch version; and K6 ``segment_dequant_mean``, K2 over int8
transport payloads decoded on the fly.

They replace the Pallas TPU kernels ``grouped_mean_pallas`` and
``segment_mean_pallas`` of ``repro/kernels/hier_aggregate.py`` and compute
the same function: x (N, D) stacked parameters of one leaf (f32 or bf16),
w (N,) f32 weights with the survival mask already folded in; each group's
weighted mean, accumulated in f32, broadcast back to its rows in x's type;
a group whose weights sum to zero keeps its rows bit for bit. K1 takes
equal contiguous groups, K2 groups given by sorted segment ids. K6
(``segment_dequant_mean_pallas``) takes K2's groups over int8 codes (N, D)
and f32 block scales (N, D / qblock), the row layout of
``kernels.quantize.quantize_stacked``, and returns f32; a dead group keeps
its decoded rows. The source notes what bounds the kernels on the card and
how they are laid out.

Dispatch is by the tensor's device alone: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel on the current stream (no
synchronisation) or raises. There is no fallback from one to the other.
``LAUNCHES`` counts kernel launches per kernel, so a run can show that it
went through the kernels.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import _build

LAUNCHES: Dict[str, int] = {"grouped_mean": 0, "segment_mean": 0, "segment_dequant_mean": 0}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- plain versions ------------------------------------------------------------


def grouped_mean_plain(x: torch.Tensor, w: torch.Tensor, num_groups: int) -> torch.Tensor:
    """K1's function in plain PyTorch, as the reshape/sum/where of
    ``repro.kernels.ref.grouped_mean_ref``."""
    n, d = x.shape
    c = n // num_groups
    xg = x.reshape(num_groups, c, d).to(torch.float32)
    wg = w.reshape(num_groups, c, 1).to(torch.float32)
    num = torch.sum(xg * wg, dim=1, keepdim=True)
    den = torch.sum(wg, dim=1, keepdim=True)
    mean = num / torch.where(den > 0, den, torch.ones_like(den))
    out = torch.where(den > 0, mean.expand_as(xg), xg)
    return out.reshape(n, d).to(x.dtype)


def segment_mean_plain(x: torch.Tensor, w: torch.Tensor, segment_ids, num_segments: int) -> torch.Tensor:
    """K2's function in plain PyTorch: segment sums with ``index_add_``,
    the means gathered back to the members, dead segments kept."""
    n, d = x.shape
    seg = torch.as_tensor(np.asarray(segment_ids), dtype=torch.long).to(x.device)
    wf = w.to(torch.float32)
    den = torch.zeros(num_segments, dtype=torch.float32, device=x.device).index_add_(0, seg, wf)
    sums = torch.zeros(num_segments, d, dtype=torch.float32, device=x.device)
    sums.index_add_(0, seg, x.to(torch.float32) * wf[:, None])
    mean = sums / torch.where(den > 0, den, torch.ones_like(den))[:, None]
    keep = (den > 0)[seg][:, None]
    return torch.where(keep, mean[seg], x.to(torch.float32)).to(x.dtype)


def segment_dequant_mean_plain(
    q: torch.Tensor, scales: torch.Tensor, w: torch.Tensor, segment_ids, num_segments: int
) -> torch.Tensor:
    """K6's function in plain PyTorch: decode ``q * scale`` per block (the
    math of ``repro.kernels.ref.segment_dequant_mean_ref``), then K2's plain
    version in f32."""
    n, d = q.shape
    nb = scales.shape[1]
    x = (q.to(torch.float32).reshape(n, nb, d // nb) * scales[..., None]).reshape(n, d)
    return segment_mean_plain(x, w, segment_ids, num_segments)


# -- kernel wrappers -------------------------------------------------------------


def _check_cuda(x: torch.Tensor, w: torch.Tensor, what: str, dtypes=tuple(_DTYPE_CODES)) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: tensors must be on the CPU (plain version) or CUDA, got {x.device}")
    if x.device != w.device:
        raise ValueError(f"{what}: x on {x.device} but weights on {w.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{what}: x is on {x.device} but the current CUDA device is {torch.cuda.current_device()}")
    if x.dim() != 2 or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"{what}: x must be a non-empty (N, D) matrix, got shape {tuple(x.shape)}")
    if x.dtype not in dtypes:
        names = " or ".join(str(t).removeprefix("torch.") for t in dtypes)
        raise ValueError(f"{what}: x dtype must be {names}, got {x.dtype}")
    if w.dtype != torch.float32 or tuple(w.shape) != (x.shape[0],):
        raise ValueError(f"{what}: weights must be float32 of shape ({x.shape[0]},), got {w.dtype} {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{what}: x and weights must be contiguous")
    if x.numel() >= 2**31:
        raise ValueError(f"{what}: x has {x.numel()} elements; the kernel indexes with int32 sizes")


def grouped_mean(x: torch.Tensor, w: torch.Tensor, num_groups: int) -> torch.Tensor:
    """K1: per equal contiguous group, the f32 weighted mean of the rows of
    ``x`` (N, D), broadcast back; zero-weight groups keep their rows."""
    n = x.shape[0]
    if num_groups <= 0 or n % num_groups:
        raise ValueError(f"N={n} not divisible by num_groups={num_groups}")
    if x.device.type == "cpu":
        return grouped_mean_plain(x, w, num_groups)
    _check_cuda(x, w, "grouped_mean")
    out = torch.empty_like(x)
    err = _build.load("hier_aggregate").hier_grouped_mean(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), n, x.shape[1], num_groups,
        _DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream,
    )
    _build.raise_on_error(err, "grouped_mean")
    LAUNCHES["grouped_mean"] += 1
    return out


def segment_offsets(segment_ids, num_segments: int) -> np.ndarray:
    """(G+1,) int32 row offsets of each segment for sorted ids in [0, G):
    segment g owns rows [offsets[g], offsets[g+1]). Raises on unsorted or
    out-of-range ids."""
    ids = np.asarray(segment_ids)
    if ids.ndim != 1 or ids.size == 0:
        raise ValueError(f"segment_ids must be a non-empty vector, got shape {ids.shape}")
    if np.any(np.diff(ids) < 0):
        raise ValueError("segment_ids must be sorted (the members of a group are contiguous)")
    if ids[0] < 0 or ids[-1] >= num_segments:
        raise ValueError(f"segment_ids must lie in [0, {num_segments}), got [{ids[0]}, {ids[-1]}]")
    return np.searchsorted(ids, np.arange(num_segments + 1), side="left").astype(np.int32)


@functools.lru_cache(maxsize=64)
def _device_offsets(ids_bytes: bytes, num_segments: int, device: torch.device) -> torch.Tensor:
    """The offsets table on ``device``, built once per (tree level, device):
    a fresh host-to-device copy per sync would stall the stream."""
    offsets = segment_offsets(np.frombuffer(ids_bytes, np.int64), num_segments)
    return torch.from_numpy(offsets).to(device)


def segment_mean(x: torch.Tensor, w: torch.Tensor, segment_ids, num_segments: int, *,
                 offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: per segment of sorted ``segment_ids`` (host-side, (N,)), the f32
    weighted mean of the rows of ``x`` (N, D), broadcast back; zero-weight
    segments keep their rows. ``offsets``, when given, is the ids'
    ``segment_offsets`` table already on x's device (a sampled cohort's
    ids change every interval, so its table comes uploaded with the
    cohort rather than from the per-level cache)."""
    ids = np.asarray(segment_ids, np.int64)
    if ids.shape != (x.shape[0],):
        raise ValueError(f"segment_ids shape {ids.shape} != ({x.shape[0]},)")
    if x.device.type == "cpu":
        return segment_mean_plain(x, w, ids, num_segments)
    _check_cuda(x, w, "segment_mean")
    if offsets is None:
        offsets = _device_offsets(ids.tobytes(), int(num_segments), x.device)
    elif offsets.dtype != torch.int32 or tuple(offsets.shape) != (int(num_segments) + 1,) or offsets.device != x.device:
        raise ValueError(f"segment_mean: offsets must be int32 of shape ({int(num_segments) + 1},) on {x.device}, "
                         f"got {offsets.dtype} {tuple(offsets.shape)} on {offsets.device}")
    out = torch.empty_like(x)
    err = _build.load("hier_aggregate").hier_segment_mean(
        x.data_ptr(), w.data_ptr(), offsets.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
        int(num_segments), _DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream,
    )
    _build.raise_on_error(err, "segment_mean")
    LAUNCHES["segment_mean"] += 1
    return out


def segment_dequant_mean(
    q: torch.Tensor, scales: torch.Tensor, w: torch.Tensor, segment_ids, num_segments: int
) -> torch.Tensor:
    """K6: per segment of sorted ``segment_ids`` (host-side, (N,)), the f32
    weighted mean of the decoded rows ``q * scale`` (q (N, D) int8, scales
    (N, D / qblock) f32), broadcast back; zero-weight segments keep their
    decoded rows."""
    n, d = q.shape
    if scales.dim() != 2 or scales.shape[0] != n or scales.shape[1] == 0 or d % scales.shape[1]:
        raise ValueError(f"scales shape {tuple(scales.shape)} incompatible with q {tuple(q.shape)}")
    ids = np.asarray(segment_ids, np.int64)
    if ids.shape != (n,):
        raise ValueError(f"segment_ids shape {ids.shape} != ({n},)")
    if q.device.type == "cpu":
        return segment_dequant_mean_plain(q, scales, w, ids, num_segments)
    _check_cuda(q, w, "segment_dequant_mean", dtypes=(torch.int8,))
    if scales.dtype != torch.float32 or scales.device != q.device or not scales.is_contiguous():
        raise ValueError("segment_dequant_mean: scales must be contiguous float32 on the device of q")
    offsets = _device_offsets(ids.tobytes(), int(num_segments), q.device)
    out = torch.empty((n, d), dtype=torch.float32, device=q.device)
    err = _build.load("hier_aggregate").hier_segment_dequant_mean(
        q.data_ptr(), scales.data_ptr(), w.data_ptr(), offsets.data_ptr(), out.data_ptr(), n, d,
        d // scales.shape[1], int(num_segments), torch.cuda.current_stream().cuda_stream,
    )
    _build.raise_on_error(err, "segment_dequant_mean")
    LAUNCHES["segment_dequant_mean"] += 1
    return out
