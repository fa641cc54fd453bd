"""Optax-style gradient transformations over trees of stacked tensors.

Port of ``repro.optim.transforms`` (``sgd``, ``momentum``, ``adam`` with
optional decoupled-in-chain weight decay, ``chain``, ``identity``,
``scale``, ``trace``, ``clip_by_global_norm``, ``add_decayed_weights``,
``scale_by_adam``, ``scale_by_learning_rate``, ``apply_updates``), written
functionally:

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
from repro_torch.tree import Tree, first_leaf, leaves, tree_map

Params = Tree
Schedule = Callable[[torch.Tensor], torch.Tensor]
ScalarOrSchedule = Union[float, Schedule]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params=None) -> (updates, state)


class EmptyState(NamedTuple):
    pass


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


def identity() -> GradientTransformation:
    return GradientTransformation(lambda params: EmptyState(), lambda grads, state, params=None: (grads, state))


def scale(factor: float) -> GradientTransformation:
    def update(grads, state, params=None):
        return tree_map(lambda g: g * factor, grads), state

    return GradientTransformation(lambda params: EmptyState(), update)


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


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale every gradient by min(1, max_norm / (||g|| + 1e-12)), with one
    norm over the whole tree (every client's rows together, as JAX's over
    its stacked leaves)."""

    def update(grads, state, params=None):
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves(grads)))
        factor = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
        return tree_map(lambda g: g * factor.to(g.dtype), grads), state

    return GradientTransformation(lambda params: EmptyState(), update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(grads, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights requires params")
        return tree_map(lambda g, p: g + weight_decay * p.to(g.dtype), grads, params), state

    return GradientTransformation(lambda params: EmptyState(), update)


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


def adam(lr: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> GradientTransformation:
    """Adam; a nonzero ``weight_decay`` adds ``weight_decay * params`` to
    the Adam direction before the learning rate, as JAX chains it (so the
    state is a 3-tuple then, a 2-tuple without)."""
    parts = [scale_by_adam(b1, b2, eps)]
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay))
    parts.append(scale_by_learning_rate(lr))
    return chain(*parts)
