"""K4 quantize and K5 dequantize: the blockwise-absmax int8 codec on
hand-written CUDA kernels (``csrc/quantize.cu``), each beside its plain
PyTorch version.

They replace the Pallas TPU kernels ``quantize_pallas`` /
``quantize_stacked_pallas`` and ``dequantize_pallas`` of
``repro/kernels/quantize.py`` and compute the same functions. Per block of
``qblock`` values: ``scale = absmax / 127`` and ``q = clip(round(x / safe),
-127, 127)`` as int8, rounding half to even, with ``safe = 1`` for an
all-zero block (whose scale is 0); dequantizing is ``q * scale`` in f32,
cast to the requested type. Inputs are f32 or bf16 (widened to f32 first).

Two layouts, one pair of kernels:

* flat (``quantize_int8`` / ``dequantize_int8``): the whole tensor,
  flattened and zero-padded to a ``qblock`` multiple, as (R, qblock) codes
  and (R, 1) scales;
* stacked rows (``quantize_stacked`` / ``dequantize_stacked``): (N, D)
  client rows, each padded to Dp, a ``qblock`` multiple, so no block
  crosses a client: (N, Dp) codes and (N, Dp / qblock) scales. This is the
  compressed transport's wire layout (``fed.transport``) and K6's input.

Dispatch is by the tensor's device alone: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel on the current stream (no
synchronisation) or raises. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

LAUNCHES: Dict[str, int] = {"quantize": 0, "dequantize": 0}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _padded(d: int, qblock: int) -> int:
    if qblock < 1:
        raise ValueError(f"qblock must be >= 1, got {qblock}")
    return d + (-d) % qblock


# -- plain versions ------------------------------------------------------------


def quantize_stacked_plain(x: torch.Tensor, qblock: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's function in plain PyTorch on (N, D) rows: the math of
    ``repro.fed.transport.quantize_rows`` (and ``kernels.ref.quantize_ref``
    per block)."""
    n, d = x.shape
    dp = _padded(d, qblock)
    xf = x.to(torch.float32)
    if dp != d:
        xf = F.pad(xf, (0, dp - d))
    blocks = xf.reshape(n, dp // qblock, qblock)
    amax = torch.amax(torch.abs(blocks), dim=-1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the IEEE quotient the kernel computes
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(blocks / safe), -127.0, 127.0).to(torch.int8)
    return q.reshape(n, dp), scale[..., 0]


def dequantize_stacked_plain(
    q: torch.Tensor, scales: torch.Tensor, d: int, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """K5's function in plain PyTorch on (N, Dp) rows: ``q * scale`` per
    block, the first ``d`` columns, cast to ``dtype``."""
    n, dp = q.shape
    nb = scales.shape[1]
    x = q.to(torch.float32).reshape(n, nb, dp // nb) * scales[..., None]
    return x.reshape(n, dp)[:, :d].to(dtype)


# -- kernel wrappers -------------------------------------------------------------


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensors must be on the CPU (plain version) or CUDA, got {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{what}: input is on {t.device} but the current CUDA device is {torch.cuda.current_device()}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")
    if t.numel() >= 2**31:
        raise ValueError(f"{what}: input has {t.numel()} elements; the kernel indexes rows with int32 sizes")


def quantize_stacked(x: torch.Tensor, qblock: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 on (N, D) client rows: (q (N, Dp) int8, scales (N, Dp / qblock)
    f32), Dp = D padded to a ``qblock`` multiple per row."""
    if x.dim() != 2 or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"quantize: x must be a non-empty (N, D) matrix, got shape {tuple(x.shape)}")
    n, d = x.shape
    dp = _padded(d, qblock)
    if x.device.type == "cpu":
        return quantize_stacked_plain(x, qblock)
    _check_cuda(x, "quantize")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"quantize: x dtype must be float32 or bfloat16, got {x.dtype}")
    if n * dp >= 2**31:
        raise ValueError(f"quantize: the padded payload has {n * dp} elements; the kernel indexes with int32 sizes")
    q = torch.empty((n, dp), dtype=torch.int8, device=x.device)
    s = torch.empty((n, dp // qblock), dtype=torch.float32, device=x.device)
    err = _build.load("quantize").quant_quantize(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), n, d, dp, qblock, _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream().cuda_stream,
    )
    _build.raise_on_error(err, "quantize")
    LAUNCHES["quantize"] += 1
    return q, s


def dequantize_stacked(
    q: torch.Tensor, scales: torch.Tensor, d: int, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """K5 on (N, Dp) rows of codes with (N, nb) scales: the decoded (N, d)
    rows in ``dtype``, ``d <= Dp``."""
    if q.dim() != 2 or scales.dim() != 2 or scales.shape[0] != q.shape[0] or scales.shape[1] == 0 \
            or q.shape[1] % scales.shape[1]:
        raise ValueError(f"dequantize: scales shape {tuple(scales.shape)} incompatible with q {tuple(q.shape)}")
    n, dp = q.shape
    if not 0 < d <= dp:
        raise ValueError(f"dequantize: d={d} outside 1..{dp}")
    if q.device.type == "cpu":
        return dequantize_stacked_plain(q, scales, d, dtype)
    _check_cuda(q, "dequantize")
    _check_cuda(scales, "dequantize")
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(f"dequantize: need int8 codes and float32 scales, got {q.dtype} and {scales.dtype}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"dequantize: output dtype must be float32 or bfloat16, got {dtype}")
    out = torch.empty((n, d), dtype=dtype, device=q.device)
    err = _build.load("quantize").quant_dequantize(
        q.data_ptr(), scales.data_ptr(), out.data_ptr(), n, dp, d, dp // scales.shape[1],
        _DTYPE_CODES[dtype], torch.cuda.current_stream().cuda_stream,
    )
    _build.raise_on_error(err, "dequantize")
    LAUNCHES["dequantize"] += 1
    return out


def quantize_int8(x: torch.Tensor, qblock: int = 256):
    """K4 on a whole tensor of any shape: (q (R, qblock) int8, scales (R, 1)
    f32, shape), the flattened tensor zero-padded to R * qblock values."""
    if x.numel() == 0:
        raise ValueError("quantize: x is empty")
    q, s = quantize_stacked(x.reshape(1, -1), qblock)
    return q.reshape(-1, qblock), s.reshape(-1, 1), tuple(x.shape)


def dequantize_int8(q: torch.Tensor, s: torch.Tensor, shape: Sequence[int], dtype=torch.float32) -> torch.Tensor:
    """K5, the inverse of ``quantize_int8``: back to ``shape`` in ``dtype``."""
    if q.dim() != 2 or tuple(s.shape) != (q.shape[0], 1):
        raise ValueError(f"dequantize: want q (R, qblock) and s (R, 1), got {tuple(q.shape)} and {tuple(s.shape)}")
    out = dequantize_stacked(q.reshape(1, -1), s.reshape(1, -1), math.prod(shape), dtype)
    return out.reshape(tuple(shape))
