"""Empirical gradient-divergence probes (Definition 1).

delta_i^l = sup_w ||grad F_i(w) - grad F^l(w)||   (client-edge divergence)
Delta^l   = sup_w ||grad F^l(w) - grad F(w)||     (edge-cloud divergence)

Port of ``repro.core.divergence``. The suprema are estimated by maximizing
over a set of probe points (e.g. the parameter trajectory of a training
run, or random perturbations of w0). The weighted aggregates delta and
Delta feed the convergence bounds (``core.convergence``) and let
experiments *quantify* edge-IID vs edge-NIID partitions.

Gradients are trees (``repro_torch.tree``) of tensors on the device the
caller's ``grad_fn`` returns them on; the probe takes the N client
gradients one call at a time, as JAX's loop does (a client's full batch is
one call, so the paper's 50 clients of 1000 CIFAR images never sit in one
vmapped call), and forms the edge and global means and the norms in f32,
in JAX's order: clients in index order, leaves in ``jax.tree_util``'s
sorted-key order. The per-client, per-edge maxima and the aggregates are
float64 on the host.

``estimate_beta_smoothness`` draws its perturbations from a
``torch.Generator`` where JAX splits a key, so the draws differ from JAX's;
on a loss whose gradient is linear with one eigenvalue (a quadratic
``beta / 2 ||w||^2``) every draw gives beta exactly.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch

from repro_torch.tree import Tree, leaves, tree_map, unflatten


def _tree_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)))


def _tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(lambda x, y: x.to(torch.float32) - y.to(torch.float32), a, b)


def _weighted_tree_mean(trees: Sequence[Tree], weights: np.ndarray) -> Tree:
    """sum_i trees[i] * (w_i / sum w), accumulated in f32 in index order;
    each factor is the float64 ratio rounded to f32, as JAX's canonicalized
    numpy scalar is."""
    total = float(np.sum(weights))
    factor = lambda w: float(np.float32(w / total))
    out = tree_map(lambda x: x.to(torch.float32) * factor(weights[0]), trees[0])
    for t, w in zip(trees[1:], weights[1:]):
        out = tree_map(lambda a, x: a + x.to(torch.float32) * factor(w), out, t)
    return out


def measure_divergence(
    grad_fn: Callable[[Tree, int], Tree],
    params_probes: Sequence[Tree],
    data_sizes: np.ndarray,
    num_edges: int,
) -> Dict[str, object]:
    """Estimate (delta_i^l, Delta^l, delta, Delta) over probe points.

    grad_fn(w, i) -> client i's full-batch gradient of F_i at w (a tree of
    tensors). data_sizes: (N,) |D_i|, clients edge-major. Returns a dict
    with the per-client / per-edge bounds (max over probes, float64 numpy)
    and the weighted aggregates (floats)."""
    sizes = np.asarray(data_sizes, dtype=np.float64)
    n = sizes.shape[0]
    if n % num_edges:
        raise ValueError(f"{n} clients do not divide evenly across {num_edges} edges")
    c = n // num_edges
    delta_il = np.zeros(n)
    Delta_l = np.zeros(num_edges)
    edge_sizes = sizes.reshape(num_edges, c).sum(axis=1)

    for w in params_probes:
        grads = [grad_fn(w, i) for i in range(n)]
        edge_grads = [_weighted_tree_mean(grads[l * c:(l + 1) * c], sizes[l * c:(l + 1) * c])
                      for l in range(num_edges)]
        global_grad = _weighted_tree_mean(edge_grads, edge_sizes)
        for i in range(n):
            delta_il[i] = max(delta_il[i], float(_tree_norm(_tree_sub(grads[i], edge_grads[i // c]))))
        for l in range(num_edges):
            Delta_l[l] = max(Delta_l[l], float(_tree_norm(_tree_sub(edge_grads[l], global_grad))))
        del grads, edge_grads, global_grad

    delta = float(np.sum(sizes * delta_il) / sizes.sum())
    Delta = float(np.sum(edge_sizes * Delta_l) / sizes.sum())
    return {
        "delta_client_edge": delta_il,
        "Delta_edge_cloud": Delta_l,
        "delta": delta,
        "Delta": Delta,
    }


def estimate_beta_smoothness(
    grad_fn: Callable[[Tree], Tree],
    w0: Tree,
    rng: torch.Generator,
    *,
    num_probes: int = 8,
    radius: float = 1e-2,
) -> float:
    """Crude beta estimate: max ||g(w+e) - g(w)|| / ||e|| over random e,
    e ~ radius * N(0, 1) per leaf, drawn from ``rng`` (on the leaves'
    device) leaf by leaf in ``tree.leaves`` order."""
    g0 = grad_fn(w0)
    beta = 0.0
    for _ in range(num_probes):
        eps = unflatten(w0, [radius * torch.randn(x.shape, generator=rng, device=x.device, dtype=torch.float32)
                             for x in leaves(w0)])
        w1 = tree_map(lambda x, e: x + e.to(x.dtype), w0, eps)
        g1 = grad_fn(w1)
        beta = max(beta, float(_tree_norm(_tree_sub(g1, g0)) / _tree_norm(eps)))
    return beta
