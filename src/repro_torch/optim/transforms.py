"""Optax-style gradient transformations over dicts of stacked tensors.

Port of ``repro.optim.transforms`` (``sgd``, ``adam``, ``chain``,
``scale_by_learning_rate``, ``apply_updates``), written functionally:

    opt = sgd(lr)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Parameters, gradients and updates are ``{name: (N, ...) tensor}`` dicts
with the client axis first, so each client carries its own slice of any
per-parameter optimizer state. The schedule count is one shared scalar for
all clients, as in the JAX package (``transforms.py:96``).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Union

import torch

from repro_torch.optim.schedule import constant

Params = Dict[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]
ScalarOrSchedule = Union[float, Schedule]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params=None) -> (updates, state)


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: Params
    nu: Params


def _device_of(params: Params) -> torch.device:
    return next(iter(params.values())).device


def apply_updates(params: Params, updates: Params) -> Params:
    """Add ``updates`` to ``params`` in place and return ``params``.

    In place where the JAX package returns new arrays: the training loop
    owns its state the way a donated JAX buffer is owned, so the stacked
    parameters are updated without a second allocation."""
    for k, p in params.items():
        p.add_(updates[k].to(p.dtype))
    return params


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


def scale_by_learning_rate(lr: ScalarOrSchedule, *, flip_sign: bool = True) -> GradientTransformation:
    schedule = lr if callable(lr) else constant(lr)
    sign = -1.0 if flip_sign else 1.0

    def init(params):
        return ScaleByScheduleState(count=torch.zeros((), dtype=torch.int32, device=_device_of(params)))

    def update(grads, state, params=None):
        step_lr = schedule(state.count) * sign
        updates = {k: g * step_lr.to(g.dtype) for k, g in grads.items()}
        return updates, ScaleByScheduleState(count=state.count + 1)

    return GradientTransformation(init, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        return ScaleByAdamState(
            count=torch.zeros((), dtype=torch.int32, device=_device_of(params)),
            mu=zeros(),
            nu=zeros(),
        )

    def update(grads, state, params=None):
        count = state.count + 1
        mu = {k: b1 * state.mu[k] + (1 - b1) * g.float() for k, g in grads.items()}
        nu = {k: b2 * state.nu[k] + (1 - b2) * torch.square(g.float()) for k, g in grads.items()}
        cf = count.to(torch.float32)
        mu_hat_scale = 1.0 / (1 - torch.pow(b1, cf))
        nu_hat_scale = 1.0 / (1 - torch.pow(b2, cf))
        updates = {
            k: ((mu[k] * mu_hat_scale) / (torch.sqrt(nu[k] * nu_hat_scale) + eps)).to(g.dtype)
            for k, g in grads.items()
        }
        return updates, ScaleByAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def sgd(lr: ScalarOrSchedule) -> GradientTransformation:
    """Plain SGD — what the paper uses ("we do not use momentum")."""
    return scale_by_learning_rate(lr)


def adam(lr: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(lr))
