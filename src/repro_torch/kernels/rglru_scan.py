"""K8 RG-LRU scan on a hand-written CUDA kernel (``csrc/rglru_scan.cu``),
beside its plain PyTorch version.

It replaces the Pallas TPU kernel ``rglru_scan_pallas`` of
``repro/kernels/rglru_scan.py`` and computes the function of its oracle
``rglru_scan_ref``: the linear recurrence h_t = a_t * h_{t-1} + b_t over
a, b (B, S, D) from h0 (B, D), returning every state h (B, S, D) and the
last hT (B, D), both f32.

Dispatch is by the tensor's device alone: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel on the current stream (no
synchronisation) or raises. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

LAUNCHES: Dict[str, int] = {"rglru_scan": 0}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8's function in plain PyTorch: a sequential loop over S in f32, one
    multiply and one add per step (no fused multiply-add), so it equals the
    kernel bit for bit; ``rglru_scan_ref``'s associative scan pairs the
    terms in another order and agrees to rounding."""
    af, bf = a.float(), b.float()
    h = torch.empty(af.shape, dtype=torch.float32, device=a.device)
    carry = h0.float()
    for t in range(a.shape[1]):
        carry = af[:, t] * carry + bf[:, t]
        h[:, t] = carry
    return h, carry


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8: (h (B, S, D) f32, hT (B, D) f32) for a, b (B, S, D) in f32 or
    bf16 and h0 (B, D)."""
    if a.dim() != 3 or a.shape != b.shape or h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"rglru_scan: want a, b (B,S,D) and h0 (B,D), got {tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(h0.shape)}")
    if 0 in a.shape:
        raise ValueError(f"rglru_scan: empty input {tuple(a.shape)}")
    if a.dtype != b.dtype:
        raise ValueError(f"rglru_scan: a and b must share a dtype, got {a.dtype} and {b.dtype}")
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b, h0)
    for t in (a, b, h0):
        if t.device.type != "cuda":
            raise ValueError(f"rglru_scan: tensors must be on the CPU (plain version) or CUDA, got {t.device}")
        if t.device.index != torch.cuda.current_device():
            raise ValueError(f"rglru_scan: input is on {t.device} but the current CUDA device is "
                             f"{torch.cuda.current_device()}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("rglru_scan: a and b must be contiguous")
    if a.dtype not in _DTYPE_CODES:
        raise ValueError(f"rglru_scan: dtype must be float32 or bfloat16, got {a.dtype}")
    B, S, D = a.shape
    if B > 65535:
        raise ValueError(f"rglru_scan: batch {B} > 65535, the kernel's grid")
    h0f = h0.float().contiguous()
    h = torch.empty((B, S, D), dtype=torch.float32, device=a.device)
    h_last = torch.empty((B, D), dtype=torch.float32, device=a.device)
    err = _build.load("rglru_scan").rg_scan(
        a.data_ptr(), b.data_ptr(), h0f.data_ptr(), h.data_ptr(), h_last.data_ptr(), B, S, D,
        _DTYPE_CODES[a.dtype], torch.cuda.current_stream().cuda_stream,
    )
    _build.raise_on_error(err, "rglru_scan")
    LAUNCHES["rglru_scan"] += 1
    return h, h_last
