"""K8 RG-LRU scan on a hand-written CUDA kernel (``csrc/rglru_scan.cu``),
beside its plain PyTorch version.

It replaces the Pallas TPU kernel ``rglru_scan_pallas`` of
``repro/kernels/rglru_scan.py`` and computes the function of its oracle
``rglru_scan_ref``: the linear recurrence h_t = a_t * h_{t-1} + b_t over
a, b (B, S, D) from h0 (B, D), returning every state h (B, S, D) and the
last hT (B, D), both f32.

The kernel cuts the sequence into chunks of ``CHUNK`` steps and composes
each chunk's carry from h0 through the chunks' aggregates in a fixed order,
so its bits depend on ``CHUNK`` and on nothing else (not on the channel
tiling, not on timing). ``rglru_scan_plain(..., chunk=CHUNK)`` computes the
same order with one PyTorch multiply and one add per step, so the two agree
bit for bit; ``chunk=None`` is the plain sequential loop, which they meet to
rounding (and bit for bit when ``chunk >= S``).

Dispatch is by the tensor's device alone: a CPU tensor takes the plain
version at ``chunk=CHUNK``; a CUDA tensor launches the kernel on the
current stream (no synchronisation) or raises; a fake tensor
(``opcount.is_fake``: the dry run's) charges ``analysis.opcount`` with
``opcount.rglru_scan_work`` and returns empty outputs, neither built nor
launched. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.analysis import opcount
from repro_torch.kernels import _build

LAUNCHES: Dict[str, int] = {"rglru_scan": 0}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 128  # steps per chunk: the kernel's compile-time kChunk


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                     chunk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8's function in plain PyTorch, in f32, one multiply and one add per
    step (never a fused multiply-add).

    ``chunk=None``: the sequential loop over S. ``chunk=T``: the kernel's
    order. The sequence is cut into chunks of T steps; each chunk's
    aggregate (A, B), the map c -> A c + B, starts from (a_0, b_0) and takes
    A = A a_t, B = a_t B + b_t for each later step; the carry into chunk k
    is composed from h0 in order, c_{j+1} = A_j c_j + B_j; each chunk is then
    walked again from its carry. The last chunk's tail is padded with
    a = 1, b = -0.0, which leave A and B unchanged bit for bit. hT is
    h[:, -1]."""
    af, bf = a.float(), b.float()
    B, S, D = af.shape
    if chunk is None or chunk >= S:
        h = torch.empty(af.shape, dtype=torch.float32, device=a.device)
        carry = h0.float()
        for t in range(S):
            carry = af[:, t] * carry + bf[:, t]
            h[:, t] = carry
        return h, carry
    if chunk < 1:
        raise ValueError(f"rglru_scan_plain: chunk must be >= 1, got {chunk}")
    n = -(-S // chunk)
    pad = n * chunk - S
    if pad:
        af = torch.cat([af, af.new_ones(B, pad, D)], dim=1)
        bf = torch.cat([bf, bf.new_full((B, pad, D), -0.0)], dim=1)
    af, bf = af.reshape(B, n, chunk, D), bf.reshape(B, n, chunk, D)
    agg_a, agg_b = af[:, :, 0], bf[:, :, 0]
    for t in range(1, chunk):
        agg_a = agg_a * af[:, :, t]
        agg_b = af[:, :, t] * agg_b + bf[:, :, t]
    carries = [h0.float()]
    for j in range(n - 1):
        carries.append(agg_a[:, j] * carries[-1] + agg_b[:, j])
    carry = torch.stack(carries, dim=1)  # (B, n, D): the carry into each chunk
    steps = []
    for t in range(chunk):
        carry = af[:, :, t] * carry + bf[:, :, t]
        steps.append(carry)
    h = torch.stack(steps, dim=2).reshape(B, n * chunk, D)[:, :S]
    return h, h[:, -1].clone()


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
        return rglru_scan_plain(a, b, h0, chunk=CHUNK)
    cost = opcount.rglru_scan_work(a.shape[0], a.shape[1], a.shape[2], a.element_size())
    if opcount.is_fake(a):  # the dry run's: charged, neither built nor launched
        opcount.charge("rglru_scan", *cost)
        return (torch.empty(a.shape, dtype=torch.float32, device=a.device),
                torch.empty((a.shape[0], a.shape[2]), dtype=torch.float32, device=a.device))
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
    with opcount.kernel_region("rglru_scan", *cost):
        B, S, D = a.shape
        h0f = h0.float().contiguous()
        h = torch.empty((B, S, D), dtype=torch.float32, device=a.device)
        h_last = torch.empty((B, D), dtype=torch.float32, device=a.device)
        lib = _build.load("rglru_scan")
        # workspace: the ticket and one flag per tile, cleared by one memset,
        # then (A, B) per (row, chunk, channel), which the kernel writes before
        # any block reads them
        header = lib.rg_scan_header_bytes(B, S, D, _DTYPE_CODES[a.dtype])
        pairs = lib.rg_scan_aggregate_bytes(B, S, D)
        if header < 0 or pairs < 0:
            raise ValueError(f"rglru_scan: the kernel refuses {tuple(a.shape)}")
        work = torch.empty(header + pairs, dtype=torch.uint8, device=a.device)
        work[:header].zero_()
        err = lib.rg_scan(
            a.data_ptr(), b.data_ptr(), h0f.data_ptr(), h.data_ptr(), h_last.data_ptr(), work.data_ptr(), B, S, D,
            _DTYPE_CODES[a.dtype], torch.cuda.current_stream().cuda_stream,
        )
        _build.raise_on_error(err, "rglru_scan")
    LAUNCHES["rglru_scan"] += 1
    return h, h_last
