"""Optax-style gradient transformations over trees of stacked tensors.

Port of ``repro.optim.transforms`` (``sgd``, ``momentum``, ``adam``,
``chain``, ``trace``, ``scale_by_learning_rate``, ``apply_updates``),
written functionally:

    opt = sgd(lr)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Parameters, gradients and updates are trees (``repro_torch.tree``) of
(N, ...) tensors with the client axis first, so each client carries its own slice of any
per-parameter optimizer state. The schedule count is one shared scalar for
all clients, as in the JAX package (``transforms.py:96``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

from repro_torch.optim.schedule import constant
from repro_torch.tree import Tree, first_leaf, tree_map

Params = Tree
Schedule = Callable[[torch.Tensor], torch.Tensor]
ScalarOrSchedule = Union[float, Schedule]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params=None) -> (updates, state)


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor


class TraceState(NamedTuple):
    trace: Params


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: Params
    nu: Params


def _device_of(params: Params) -> torch.device:
    return first_leaf(params).device


def apply_updates(params: Params, updates: Params) -> Params:
    """Add ``updates`` to ``params`` in place and return ``params``.

    In place where the JAX package returns new arrays: the training loop
    owns its state the way a donated JAX buffer is owned, so the stacked
    parameters are updated without a second allocation."""
    tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
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
        updates = tree_map(lambda g: g * step_lr.to(g.dtype), grads)
        return updates, ScaleByScheduleState(count=state.count + 1)

    return GradientTransformation(init, update)


def trace(decay: float, *, nesterov: bool = False) -> GradientTransformation:
    """Momentum accumulator (a la ``optax.trace``): ``t = g + decay * t``.
    The trace rows take the parameters' dtype (bf16 client state keeps a
    bf16 trace, as in the JAX package)."""

    def init(params):
        return TraceState(trace=tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        new_trace = tree_map(lambda g, t: g + decay * t, grads, state.trace)
        if nesterov:
            updates = tree_map(lambda g, t: g + decay * t, grads, new_trace)
        else:
            updates = new_trace
        return updates, TraceState(trace=new_trace)

    return GradientTransformation(init, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        zeros = lambda: tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return ScaleByAdamState(
            count=torch.zeros((), dtype=torch.int32, device=_device_of(params)),
            mu=zeros(),
            nu=zeros(),
        )

    def update(grads, state, params=None):
        count = state.count + 1
        mu = tree_map(lambda g, m: b1 * m + (1 - b1) * g.float(), grads, state.mu)
        nu = tree_map(lambda g, v: b2 * v + (1 - b2) * torch.square(g.float()), grads, state.nu)
        cf = count.to(torch.float32)
        mu_hat_scale = 1.0 / (1 - torch.pow(b1, cf))
        nu_hat_scale = 1.0 / (1 - torch.pow(b2, cf))
        updates = tree_map(
            lambda g, m, v: ((m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale) + eps)).to(g.dtype), grads, mu, nu
        )
        return updates, ScaleByAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def sgd(lr: ScalarOrSchedule) -> GradientTransformation:
    """Plain SGD — what the paper uses ("we do not use momentum")."""
    return scale_by_learning_rate(lr)


def momentum(lr: ScalarOrSchedule, decay: float = 0.9, *, nesterov: bool = False) -> GradientTransformation:
    return chain(trace(decay, nesterov=nesterov), scale_by_learning_rate(lr))


def adam(lr: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(lr))
