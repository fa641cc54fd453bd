"""K7 flash attention (forward) on a hand-written CUDA kernel
(``csrc/flash_attention.cu``), beside its plain PyTorch version.

It replaces the Pallas TPU kernel ``flash_attention_pallas`` of
``repro/kernels/flash_attention.py`` and computes the function of its
oracle ``attention_ref``: softmax attention with scale hd^-0.5, keys masked
where k > q if causal and where q - k >= window if window > 0, in f32, a
query row with no visible key giving 0, the result in q's dtype.

The layout is the model's: q (B, Sq, H, hd) and k, v (B, Sk, Hkv, hd) with
H a multiple of Hkv; query head h reads KV head h // (H / Hkv), so the
repeated K/V are never built. ``ops.flash_attention``'s (BH, S, d) contract
is the case H = Hkv = 1.

Dispatch is by the tensor's device alone: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel on the current stream (no
synchronisation) or raises; a fake tensor (``opcount.is_fake``: the dry
run's) charges ``analysis.opcount`` with ``opcount.attention_work`` and
returns an empty output, neither built nor launched. ``LAUNCHES`` counts
kernel launches. On the card the source holds two templates, chosen by
dtype: bf16 runs on the tensor cores (wgmma), f32 on the CUDA cores (no
TF32).

The bf16 template rounds the probabilities to bf16 for the PV product, as
the model's layer code does, while ``attention_plain`` keeps them in f32;
``bf16_tolerance`` is the bound between the two, row by row.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.analysis import opcount
from repro_torch.kernels import _build

LAUNCHES: Dict[str, int] = {"flash_attention": 0}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """K7's function in plain PyTorch, ``attention_ref``'s semantics on the
    model's layout: scores, softmax and the PV product in f32 over the whole
    (Sq, Sk) score matrix, masked entries at -1e30, rows with no visible key
    0, the result cast to q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, Sq, Hkv, g, hd).float(), k.float()) * hd ** -0.5
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    out = torch.where(mask.any(dim=-1)[None, :, None, None, None], out, torch.zeros((), device=q.device))
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def bf16_tolerance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, got: torch.Tensor, want: torch.Tensor,
                   atol: float, *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """Elementwise bound on |got - want| for K7 in bf16, ``want`` being
    ``attention_plain`` on the same inputs. Each probability is rounded to
    bf16 (relative error <= u = 2^-8) and l sums the rounded ones, so each
    normalised weight w_j differs from the oracle's by at most 2u/(1-u) w_j,
    and an output element by at most 2u/(1-u) sum_j w_j |v_j|: the oracle's
    attention over |v|, per row and head dim. The two results then round
    to bf16 apart, half an ulp each: at most one ulp of the larger.
    ``atol`` takes the f32 arithmetic's other orders."""
    weighted = attention_plain(q.float(), k.float(), v.float().abs(), causal=causal, window=window)
    larger = torch.maximum(got.float().abs(), want.float().abs())
    ulp = torch.exp2(torch.floor(torch.log2(larger.clamp_min(torch.finfo(torch.bfloat16).tiny))) - 7)
    u = 2.0 ** -8
    return atol + 2 * u / (1 - u) * weighted + ulp


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensors must be on the CPU (plain version) or CUDA, got {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{what}: input is on {t.device} but the current CUDA device is {torch.cuda.current_device()}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: inputs must be contiguous")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: int = 0) -> torch.Tensor:
    """K7 on q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd): (B, Sq, H, hd) in
    q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"attention: want q (B,Sq,H,hd) and k, v (B,Sk,Hkv,hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         "(same batch and head dim, H a multiple of Hkv)")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"attention: q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window)
    cost = opcount.attention_work(B, Sq, k.shape[1], H, k.shape[2], hd, v.shape[3], causal, window,
                                  q.element_size())
    if opcount.is_fake(q):  # the dry run's: charged, neither built nor launched
        opcount.charge("flash_attention", *cost)
        return torch.empty_like(q)
    for t in (q, k, v):
        _check_cuda(t, "attention")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"attention: dtype must be float32 or bfloat16, got {q.dtype}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"attention: head dim {hd} > {MAX_HEAD_DIM}, the kernel's largest")
    if B > 65535 or H > 65535 or q.numel() >= 2**31 or k.numel() >= 2**31 or Sq == 0 or k.shape[1] == 0:
        raise ValueError(f"attention: shapes {tuple(q.shape)}, {tuple(k.shape)} outside the kernel's grid")
    with opcount.kernel_region("flash_attention", *cost):
        out = torch.empty_like(q)
        err = _build.load("flash_attention").fa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, k.shape[1], H, k.shape[2], hd,
            hd ** -0.5, int(bool(causal)), int(window), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.raise_on_error(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
