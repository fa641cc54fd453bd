"""Host-side store for the persistent per-client slice of federated state:
the port of ``repro.fed.client_store``.

The cohort engine keeps only the C sampled clients on the device; what is
*sticky* per client — optimizer-state rows (momentum trace, Adam moments)
and error-feedback residuals — lives here, in host memory, indexed by
original client id. Model parameters and transport anchors are not
stored: the engine hands control back only after a cloud sync, where every
stacked params / anchor row equals the broadcast global model.

Memory: the backing arrays are ``np.zeros((N,) + row_shape)``, whose pages
the kernel hands out lazily (calloc), so physical memory grows with the
clients actually *written*, not with N. They are not pinned: pinning
commits every page. Zero rows are what ``optimizer.init`` produces for
every in-repo transform (trace / mu / nu start at zeros, EF residuals at
zeros), so "never sampled" and "freshly initialized" are the same rows.

Trees are walked with ``repro_torch.tree`` (``leaves`` in JAX's sorted-key
order), so the store's leaves line up with the JAX store's one for one.
bfloat16 rows are kept as their 16-bit patterns (numpy has no bfloat16).
``state()`` / ``load()`` expose the store as a checkpointable tree.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.tree import leaves, tree_map, unflatten

Tree = Any

__all__ = ["ClientStateStore", "sticky_rows", "replace_sticky_rows"]


def _is_row(x, cohort_size: int) -> bool:
    """A leaf is per-client iff it has a leading axis of the cohort's size
    (scalar counts and schedules are shared)."""
    return getattr(x, "ndim", 0) >= 1 and x.shape[0] == cohort_size


def sticky_rows(state, cohort_size: int) -> Dict[str, Any]:
    """The per-client rows of a stacked ``FedState``: ``{"opt": [stacked
    opt leaves...]}`` plus ``"res"`` when the state carries an EF residual.
    The leaves are the state's own tensors, not copies."""
    rows: Dict[str, Any] = {"opt": [x for x in leaves(state.opt_state) if _is_row(x, cohort_size)]}
    if state.residual is not None:
        rows["res"] = state.residual
    return rows


def replace_sticky_rows(state, rows: Dict[str, Any], cohort_size: int):
    """Inverse of :func:`sticky_rows`: a ``FedState`` with fresh rows."""
    fresh = iter(rows["opt"])
    new = [next(fresh) if _is_row(x, cohort_size) else x for x in leaves(state.opt_state)]
    out = state._replace(opt_state=unflatten(state.opt_state, new))
    if "res" in rows:
        out = out._replace(residual=rows["res"])
    return out


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


class ClientStateStore:
    """(N, ...) host arrays with gather / scatter by original client id."""

    def __init__(self, num_clients: int, row_template: Tree):
        """``row_template`` leaves (numpy arrays or tensors) give the
        per-client row shape and dtype (no client axis)."""
        self.num_clients = int(num_clients)
        self._template = tree_map(lambda _: 0, row_template)
        self._arrays: List[np.ndarray] = [
            np.zeros((self.num_clients,) + tuple(leaf.shape), dtype=_to_host(leaf).dtype)
            for leaf in leaves(row_template)
        ]
        self._touched = np.zeros(self.num_clients, np.bool_)

    @classmethod
    def from_rows(cls, num_clients: int, rows: Tree) -> "ClientStateStore":
        """Build from a cohort-stacked rows tree (leaves have a leading
        cohort axis): the template is a row of each leaf."""
        return cls(num_clients, tree_map(lambda x: _to_host(x[0] if getattr(x, "ndim", 0) >= 1 else x), rows))

    @property
    def is_empty(self) -> bool:
        """True when there is no sticky per-client state (plain SGD, no EF)."""
        return not self._arrays

    @property
    def num_touched(self) -> int:
        """Clients that have participated at least once (rows ever written)."""
        return int(self._touched.sum())

    @property
    def nbytes(self) -> int:
        """Logical size; physical residency is page-lazy (module docstring)."""
        return sum(a.nbytes for a in self._arrays) + self._touched.nbytes

    # -- the cohort swap -----------------------------------------------------

    def gather(self, ids: Sequence[int]) -> Tree:
        """Rows for a sampled cohort, zero (= fresh init) where never written."""
        idx = np.asarray(ids, np.int64)
        return unflatten(self._template, [a[idx] for a in self._arrays])

    def gather_into(self, ids: Sequence[int], out: Sequence[np.ndarray]) -> None:
        """``gather`` into preallocated (C, ...) arrays, one per leaf in
        ``leaves`` order (the engine's pinned staging buffers)."""
        idx = np.asarray(ids, np.int64)
        for arr, o in zip(self._arrays, out):
            np.take(arr, idx, axis=0, out=o)

    def scatter(self, ids: Sequence[int], rows: Tree) -> None:
        """Write a cohort's rows back after its cloud interval (any tree
        whose leaves, in ``leaves`` order, are the store's)."""
        idx = np.asarray(ids, np.int64)
        flat = list(leaves(rows))
        if len(flat) != len(self._arrays):
            raise ValueError(f"expected {len(self._arrays)} row leaves, got {len(flat)}")
        for arr, leaf in zip(self._arrays, flat):
            host = _to_host(leaf)
            if host.shape != (idx.shape[0],) + arr.shape[1:]:
                raise ValueError(f"row shape {host.shape} incompatible with store leaf {arr.shape}")
            arr[idx] = host.astype(arr.dtype, copy=False)
        self._touched[idx] = True

    # -- the sharded cohort swap ---------------------------------------------

    def gather_placed(self, ids: Sequence[int], placement, rows: slice = slice(None)) -> Tree:
        """Rows for a sampled cohort in *slot placement order*: gathered by
        original client id and permuted / padded by
        ``placement.gather_index()``, so leaves lead with
        ``placement.padded_clients`` positions (``rows``: only those
        positions, a rank's). Phantom slots read slot 0's client; their
        weight is zero and ``scatter_placed`` drops them."""
        idx = np.asarray(ids, np.int64)[placement.gather_index()[rows]]
        return unflatten(self._template, [a[idx] for a in self._arrays])

    def scatter_placed(self, ids: Sequence[int], placement, rows: Tree, positions: slice = slice(None)) -> None:
        """Inverse of :func:`gather_placed`: the padded rows (or a rank's
        ``positions`` of them) back by original client id, phantoms
        dropped. A rank writes only the clients placed on it: stratified
        quotas fix slots to edges and edges to ranks, so a client's rows
        always live on one rank's store."""
        gather = placement.gather_index()[positions]
        real = placement.valid()[positions]
        sel = np.flatnonzero(real)
        idx = np.asarray(ids, np.int64)[gather[sel]]
        self.scatter(idx, tree_map(lambda x: _to_host(x)[sel], rows))

    # -- checkpointing -------------------------------------------------------

    def state(self) -> Dict[str, Any]:
        """Checkpointable tree view (shares buffers; do not mutate)."""
        return {"leaves": list(self._arrays), "touched": self._touched}

    def load(self, state: Dict[str, Any]) -> None:
        new = list(state["leaves"])
        if len(new) != len(self._arrays):
            raise ValueError(f"expected {len(self._arrays)} store leaves, got {len(new)}")
        for i, (arr, leaf) in enumerate(zip(self._arrays, new)):
            host = np.asarray(leaf)
            if host.shape != arr.shape:
                raise ValueError(f"store leaf {i}: shape {host.shape} != {arr.shape}")
            self._arrays[i] = host.astype(arr.dtype, copy=False)
        self._touched = np.asarray(state["touched"], np.bool_).copy()
