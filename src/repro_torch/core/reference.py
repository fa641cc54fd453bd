"""Literal numpy implementation of Algorithm 1 (HierFAVG) — the test oracle.

Copy-port of ``repro.core.reference`` (numpy): the port keeps its own copy
so that it imports nothing of the JAX package.

This mirrors the paper's pseudocode line by line: explicit python loops over
clients and edges, per-client weight vectors, aggregation exactly at
k | kappa1 == 0 and k | kappa1*kappa2 == 0. It is deliberately slow and
simple; tests compare the port's engine against it.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np


def hierfavg_reference(
    w0: np.ndarray,
    grad_fns: Sequence[Callable[[np.ndarray], np.ndarray]],
    data_sizes: Sequence[float],
    num_edges: int,
    kappa1: int,
    kappa2: int,
    num_steps: int,
    lr: Callable[[int], float] | float,
) -> List[np.ndarray]:
    """Run HierFAVG on a quadratic/arbitrary problem with full-batch gradients.

    grad_fns[i](w) -> gradient of client i's local loss F_i at w.
    Returns the per-client weight list after num_steps local updates.
    """
    n = len(grad_fns)
    if n % num_edges:
        raise ValueError("clients must divide evenly across edges")
    c = n // num_edges
    sizes = np.asarray(data_sizes, dtype=np.float64)
    w = [np.array(w0, dtype=np.float64) for _ in range(n)]

    def lr_at(k):
        return lr(k) if callable(lr) else lr

    for k in range(1, num_steps + 1):
        # line 4-5: parallel local gradient steps
        eta = lr_at(k - 1)
        for i in range(n):
            w[i] = w[i] - eta * grad_fns[i](w[i])
        if k % kappa1 == 0:
            # lines 7-9: edge aggregation
            edge_models = []
            for l in range(num_edges):
                idx = range(l * c, (l + 1) * c)
                tot = sizes[list(idx)].sum()
                agg = sum(sizes[i] * w[i] for i in idx) / tot
                edge_models.append(agg)
            if k % (kappa1 * kappa2) != 0:
                # lines 10-13: redistribute edge model to members
                for l in range(num_edges):
                    for i in range(l * c, (l + 1) * c):
                        w[i] = edge_models[l].copy()
            else:
                # lines 17-21: cloud aggregation of edge models, broadcast all
                edge_sizes = np.array([sizes[l * c : (l + 1) * c].sum() for l in range(num_edges)])
                cloud = sum(edge_sizes[l] * edge_models[l] for l in range(num_edges)) / edge_sizes.sum()
                for i in range(n):
                    w[i] = cloud.copy()
    return w


def fedavg_reference(w0, grad_fns, data_sizes, kappa, num_steps, lr):
    """Two-layer FAVG (Section II-B) == HierFAVG with kappa2 = 1, one edge."""
    return hierfavg_reference(w0, grad_fns, data_sizes, 1, kappa, 1, num_steps, lr)


def centralized_gd_reference(w0, grad_fns, data_sizes, num_steps, lr):
    """Centralized gradient descent on the global loss F(w) (Eq. 1)."""
    sizes = np.asarray(data_sizes, dtype=np.float64)
    tot = sizes.sum()
    w = np.array(w0, dtype=np.float64)
    for k in range(num_steps):
        eta = lr(k) if callable(lr) else lr
        g = sum(s * f(w) for s, f in zip(sizes, grad_fns)) / tot
        w = w - eta * g
    return w
