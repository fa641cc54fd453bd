"""Elastic re-topology: map a HierFAVG checkpoint onto a different cluster.

Port of ``repro.checkpoint.reshard`` (92 lines). Two elastic moves, both
defined by the algorithm's own aggregation operator:

* ``reshard_clients`` — change (L, C) -> (L', C'). Shrinking merges client
  models by |D_i|-weighted mean (exactly an edge aggregation over the
  merged set); growing replicates the group model to the new members
  (exactly a broadcast). Data sizes re-partition accordingly.
* ``to_mesh`` — this rank's part of a tree on a client mesh: each leaf
  through its ``dist.sharding.RowSharding`` (``fed_state_shardings``), the
  counterpart of JAX's ``device_put`` with ``NamedSharding``s. A resumed
  sharded run reads the whole checkpoint on every rank and keeps its rows.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map

Tree = Any


def _group_reduce(stack: torch.Tensor, weights: np.ndarray, groups: int) -> torch.Tensor:
    """(N, ...) -> (groups, ...) weighted mean over contiguous blocks, in f32
    (plain PyTorch, as JAX's ``jnp``)."""
    n = stack.shape[0]
    size = n // groups
    w = torch.as_tensor(np.asarray(weights, np.float32), device=stack.device).reshape(groups, size)
    xg = stack.reshape((groups, size) + tuple(stack.shape[1:])).to(torch.float32)
    wb = w.reshape((groups, size) + (1,) * (stack.dim() - 1))
    num = torch.sum(xg * wb, dim=1)
    den = torch.sum(wb, dim=1)
    return (num / den).to(stack.dtype)


def reshard_clients(params: Tree, data_sizes: np.ndarray, new_num_clients: int) -> Tuple[Tree, np.ndarray]:
    """Map stacked (N, ...) client params onto N' clients.

    N' < N: N must be divisible by N'; contiguous groups of N/N' clients are
    merged by weighted mean (edge-aggregation semantics) and the merged
    client inherits the group's total |D|.
    N' > N: N' must be divisible by N; each client's model is replicated to
    N'/N new clients (broadcast semantics) and its data size is split.
    """
    sizes = np.asarray(data_sizes, np.float64)
    n = sizes.shape[0]
    if new_num_clients == n:
        return params, sizes
    if new_num_clients < n:
        if n % new_num_clients:
            raise ValueError(f"cannot merge {n} clients into {new_num_clients}")
        g = new_num_clients
        merged = tree_map(lambda x: _group_reduce(x, sizes, g), params)
        return merged, sizes.reshape(g, -1).sum(axis=1)
    if new_num_clients % n:
        raise ValueError(f"cannot grow {n} clients into {new_num_clients}")
    rep = new_num_clients // n
    grown = tree_map(lambda x: torch.repeat_interleave(x, rep, dim=0), params)
    return grown, np.repeat(sizes / rep, rep)


def to_mesh(tree: Tree, shardings: Tree) -> Tree:
    """This rank's part of ``tree``: each leaf through the matching
    ``RowSharding`` of ``shardings`` (a tree of the same structure; None
    where the tree holds None)."""
    return tree_map(lambda x, s: x if s is None else s(x), tree, shardings)


def merge_opt_state(opt_state: Tree, data_sizes: np.ndarray, new_num_clients: int) -> Tree:
    """Reshard stacked per-client optimizer state the same way as params.

    Scalar leaves (step counters) pass through unchanged; stacked leaves
    (first dim == N) are merged/grown like parameters.
    """
    n = len(np.asarray(data_sizes))

    def leaf(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] == n:
            out, _ = reshard_clients(x, data_sizes, new_num_clients)
            return out
        return x

    return tree_map(leaf, opt_state)
