"""numpy <-> torch tree helpers and one tolerance-reporting comparison.

The port's tests feed the JAX package and the port the same numpy inputs
and compare their outputs here. Nothing in this module imports ``jax``:
callers hand in numpy (``jax.device_get``/``np.asarray`` on their side).
Trees are nested dicts, lists and tuples with arrays or tensors at the
leaves.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

Tree = Any


def _map(fn, tree: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _to_tensor(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as jax hands it out
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def to_torch(tree: Tree, device="cpu") -> Tree:
    """numpy leaves -> tensors on ``device`` (bfloat16 kept as bfloat16)."""
    return _map(lambda x: _to_tensor(x, device), tree)


def to_numpy(tree: Tree) -> Tree:
    """Tensor leaves -> numpy; bfloat16 widens to float32 (exactly), since
    numpy has no bfloat16 of its own."""

    def leaf(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            if x.dtype == torch.bfloat16:
                x = x.float()
            return x.numpy()
        return np.asarray(x)

    return _map(leaf, tree)


def _leaves(tree: Tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1] or "value", tree


def _as_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = to_numpy(x)
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr.astype(np.float64)


def assert_close(a: Tree, b: Tree, *, rtol: float, atol: float, what: str) -> float:
    """Assert ``|a - b| <= atol + rtol * |b|`` leaf by leaf (numpy or torch
    leaves, same tree structure). Returns the largest absolute error; the
    failure message names ``what``, the leaf, and the tolerance used."""
    la, lb = list(_leaves(a)), list(_leaves(b))
    if [n for n, _ in la] != [n for n, _ in lb]:
        raise AssertionError(
            f"{what}: tree structure differs: {[n for n, _ in la]} vs {[n for n, _ in lb]}"
        )
    worst = 0.0
    for (name, x), (_, y) in zip(la, lb):
        xa, ya = _as_f64(x), _as_f64(y)
        if xa.shape != ya.shape:
            raise AssertionError(f"{what}[{name}]: shape {xa.shape} vs {ya.shape}")
        err = np.abs(xa - ya)
        bad = err > atol + rtol * np.abs(ya)
        if bad.any():
            i = np.unravel_index(int(np.argmax(err - rtol * np.abs(ya))), err.shape)
            raise AssertionError(
                f"{what}[{name}]: {int(bad.sum())} of {err.size} values outside "
                f"rtol={rtol:g}, atol={atol:g}; worst at {i}: {xa[i]!r} vs {ya[i]!r} "
                f"(max abs err {float(err.max()):.3e})"
            )
        worst = max(worst, float(err.max()) if err.size else 0.0)
    return worst
