"""Learning-rate schedules as functions of the shared update count.

Port of ``repro.optim.schedule``'s ``constant`` and ``exponential_decay``.
The rate is an f32 tensor on the count's device, computed in f32 as the JAX
package computes it (``schedule.py:37-41``): a Python double would drift
from the reference in the last bits. ``torch.full`` fills on the device, so
no host-to-device copy (and no stream sync) happens per step.
"""
from __future__ import annotations

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
