"""Learning-rate schedules as functions of the shared update count.

Port of ``repro.optim.schedule`` (``constant``, ``exponential_decay``,
``cosine_decay``, ``warmup_cosine``). The rate is an f32 tensor on the
count's device, computed in f32 as the JAX package computes it
(``schedule.py:37-63``): a Python double would drift from the reference in
the last bits. Divisions take a device tensor, not a Python scalar, since
PyTorch's CUDA division by a scalar multiplies by its reciprocal. ``cos``
may sit one f32 ulp from XLA's. ``torch.full`` fills on the device, so no
host-to-device copy (and no stream sync) happens per step.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def constant(value: float) -> Schedule:
    def schedule(count):
        return _f32(value, count)

    return schedule


def exponential_decay(
    init_value: float,
    decay_rate: float,
    transition_steps: int,
    *,
    staircase: bool = True,
) -> Schedule:
    """lr(k) = init * decay_rate ** (k / transition_steps); with staircase the
    exponent is floored (decay once per ``transition_steps``)."""

    def schedule(count):
        exp = count.to(torch.float32) / float(transition_steps)
        if staircase:
            exp = torch.floor(exp)
        return _f32(init_value, count) * torch.pow(_f32(decay_rate, count), exp)

    return schedule


def cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """lr(k) = init * ((1 - alpha) * cos_k + alpha), cos_k = (1 + cos(pi *
    min(k / decay_steps, 1))) / 2."""

    def schedule(count):
        frac = torch.clamp(count.to(torch.float32) / _f32(float(decay_steps), count), 0.0, 1.0)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return _f32(init_value, count) * ((1 - alpha) * cosine + alpha)

    return schedule


def warmup_cosine(init_value: float, warmup_steps: int, decay_steps: int, floor: float = 0.0) -> Schedule:
    """Linear warmup from 0 over ``warmup_steps`` (lr 0 at count 0), then
    ``cosine_decay`` to ``floor`` of the peak over the remaining
    ``decay_steps - warmup_steps``."""
    cos = cosine_decay(init_value, max(decay_steps - warmup_steps, 1), alpha=floor)

    def schedule(count):
        count = count.to(torch.float32)
        warm = _f32(init_value, count) * count / _f32(max(float(warmup_steps), 1.0), count)
        return torch.where(count < warmup_steps, warm, cos(count - warmup_steps))

    return schedule
