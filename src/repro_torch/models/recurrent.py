"""The RG-LRU block (Griffin / RecurrentGemma temporal mixing), the
counterpart of the RG-LRU part of ``repro.models.recurrent``.

    init_rglru(gen, cfg)                      -> params
    rglru_sequence(params, x, cfg)            -> (y, h_S, u)  (full sequence)
    rglru_init_state(cfg, batch, dtype)       -> state        (O(1) decode state)
    rglru_step(params, x_t, state, cfg)       -> (y_t, state)

The recurrence h_t = a_t * h_{t-1} + b_t (h_0 = 0) over the sequence has two
routes, as attention has in ``layers`` (``layers._use_kernels``): K8
(``kernels.rglru_scan``) on CUDA tensors that neither autograd nor a
``torch.func`` transform would record, and otherwise ``_associative_scan``,
a log-step scan that mirrors JAX's ``jax.lax.associative_scan``. mLSTM and sLSTM are not
ported yet: ``transformer`` refuses configs that need them, naming ROADMAP
item 13.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.models.layers import _init_dense, _use_kernels

Params = Dict[str, torch.Tensor]
_RGLRU_C = 8.0


def init_rglru(gen: torch.Generator, cfg: ArchConfig, stack: Sequence[int] = ()) -> Params:
    d, dr = cfg.d_model, cfg.d_rnn_resolved
    dt = cfg.dtype()
    # Lambda init so that a = exp(-c*softplus(L)*sigma(..)) sits in (0.9, 0.999)
    lam = torch.rand((*stack, dr), generator=gen, dtype=torch.float32, device=gen.device) * 0.5 + 0.3
    return {
        "w_x": _init_dense(gen, (d, dr), dt, stack=stack),
        "w_gate": _init_dense(gen, (d, dr), dt, stack=stack),
        "conv": _init_dense(gen, (4, dr), dt, scale=0.5, stack=stack),
        "a_r": _init_dense(gen, (dr,), torch.float32, scale=1.0, stack=stack),
        "a_i": _init_dense(gen, (dr,), torch.float32, scale=1.0, stack=stack),
        "lambda": lam,
        "w_out": _init_dense(gen, (dr, d), dt, stack=stack),
    }


def _rglru_coeffs(params: Params, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-step recurrence coefficients. v: (..., dr) conv output.

    log a_t = -c * softplus(Lambda) * sigmoid(a_r * v_t)
    b_t     = sqrt(1 - a_t^2) * sigmoid(a_i * v_t) * v_t
    """
    vf = v.float()
    r = torch.sigmoid(params["a_r"] * vf)
    i = torch.sigmoid(params["a_i"] * vf)
    log_a = -_RGLRU_C * F.softplus(params["lambda"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 0.0, 1.0)) * i * vf
    return a, b


def _conv1d_causal(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width 4. x: (B,S,dr), kernel: (4,dr)."""
    pad = F.pad(x, (0, 0, 3, 0))
    return sum(pad[:, i:i + x.shape[1]] * kernel[i] for i in range(4))


def _associative_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t from h_0 = 0 over dim 1, by the combine
    (a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2) in ceil(log2 S) doubling steps
    (Hillis-Steele), the operator of JAX's ``associative_scan`` (whose
    recursion pairs the terms in another order)."""
    S = a.shape[1]
    shift = 1
    while shift < S:
        a_prev, b_prev = a[:, :-shift], b[:, :-shift]
        b = torch.cat([b[:, :shift], a[:, shift:] * b_prev + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a_prev], dim=1)
        shift *= 2
    return b


def rglru_sequence(params: Params, x: torch.Tensor, cfg: ArchConfig, *, default_positions: bool = False):
    """The full-sequence block and what a decode cache needs:
    (y (B,S,d), h_S (B,dr) f32, u = x @ w_x (B,S,dr)). K8 takes the scan on
    the card when autograd records nothing (``default_positions``: the
    sequence starts at position 0, so h_0 = 0)."""
    gate = F.gelu((x @ params["w_gate"]).float(), approximate="tanh")
    u = x @ params["w_x"]
    v = _conv1d_causal(u, params["conv"])
    a, b = _rglru_coeffs(params, v)
    if _use_kernels(default_positions, a, b):
        h, h_last = _rg.rglru_scan(a, b, torch.zeros_like(a[:, 0]))
    else:
        h = _associative_scan(a, b)
        h_last = h[:, -1]
    y = (h * gate).to(x.dtype) @ params["w_out"]
    return y, h_last, u


def rglru_init_state(cfg: ArchConfig, batch: int, dtype, device=None, stack: Sequence[int] = ()) -> Params:
    dr = cfg.d_rnn_resolved
    return {
        "h": torch.zeros((*stack, batch, dr), dtype=torch.float32, device=device),
        "conv": torch.zeros((*stack, batch, 3, dr), dtype=dtype, device=device),  # last 3 pre-conv inputs
    }


def rglru_step(params: Params, x_t: torch.Tensor, state: Params, cfg: ArchConfig):
    """x_t: (B,1,d) -> (y_t, state). Always the layer code."""
    xt = x_t[:, 0]
    gate = F.gelu((xt @ params["w_gate"]).float(), approximate="tanh")
    u = xt @ params["w_x"]  # (B, dr)
    window = torch.cat([state["conv"], u[:, None]], dim=1)  # (B,4,dr)
    v = sum(window[:, i] * params["conv"][i] for i in range(4))
    a, b = _rglru_coeffs(params, v)
    h = a * state["h"] + b
    y = ((h * gate).to(x_t.dtype) @ params["w_out"])[:, None]
    return y, {"h": h, "conv": window[:, 1:]}
