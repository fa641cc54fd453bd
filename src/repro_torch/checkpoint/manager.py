"""Atomic checkpointing with keep-k retention and full-state restore: the
port of ``repro.checkpoint.manager``, with its on-disk layout.

    <root>/step_000001200/
        payload.npz       - the state's leaves as ``leaf_i`` (numpy arrays)
        meta.json         - leaf count, shapes, dtypes, user metadata
    <root>/step_000001200.COMMITTED   - marker written LAST

Writes go to a tmp dir and ``os.replace``; the COMMITTED marker is created
only after the rename, so a crash mid-write never leaves a checkpoint that
restore picks up. ``restore_latest`` scans markers newest first and skips
entries that fail to load or do not fit the template (leaf count, shapes).

Leaves are taken in ``repro_torch.tree.leaves`` order (JAX's), with
``None`` (an absent anchor or residual) holding no leaf, as in
``jax.tree_util``: a template whose anchor is None does not fit a
checkpoint that holds one, and the older entry is tried. A
``torch.Generator`` (``FedState.rng``) is stored as its ``get_state()``
bytes and restored into a new generator on the template generator's
device; tensors are restored in the template leaf's dtype, on its device.
bfloat16 leaves are stored as their 16-bit patterns (numpy has no
bfloat16), under the dtype name ``bfloat16``.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves, unflatten

Tree = Any


def _stored(tree: Tree) -> List[Any]:
    """The leaves a checkpoint holds: ``leaves`` without the Nones."""
    return [x for x in leaves(tree) if x is not None]


def _to_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _from_array(a: np.ndarray, t):
    """Checkpoint array ``a`` as a leaf like template leaf ``t``."""
    if isinstance(t, torch.Generator):
        state = torch.from_numpy(np.array(a, np.uint8, order="C"))
        if tuple(state.shape) != tuple(t.get_state().shape):
            raise ValueError(f"generator state shape mismatch: ckpt {a.shape} vs template {tuple(t.get_state().shape)}")
        g = torch.Generator(device=t.device)
        g.set_state(state)
        return g
    if isinstance(t, torch.Tensor):
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"leaf shape mismatch: ckpt {a.shape} vs template {tuple(t.shape)}")
        if t.dtype == torch.bfloat16:
            x = torch.from_numpy(np.array(a, order="C").view(np.int16)).view(torch.bfloat16)
        else:
            x = torch.from_numpy(np.array(a, order="C")).to(t.dtype)
        return x.to(t.device)
    if tuple(a.shape) != tuple(np.shape(t)):
        raise ValueError(f"leaf shape mismatch: ckpt {a.shape} vs template {np.shape(t)}")
    return a.astype(np.asarray(t).dtype) if hasattr(t, "dtype") else a


class CheckpointManager:
    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:012d}")

    def _marker(self, step: int) -> str:
        return self._step_dir(step) + ".COMMITTED"

    def committed_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            if name.endswith(".COMMITTED"):
                try:
                    out.append(int(name[len("step_") : -len(".COMMITTED")]))
                except ValueError:
                    continue
        return sorted(out)

    def save(self, step: int, state: Tree, metadata: Optional[Dict] = None) -> str:
        tree_leaves = _stored(state)
        arrays = [_to_array(x) for x in tree_leaves]
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "payload.npz"), **{f"leaf_{i}": a for i, a in enumerate(arrays)})
        meta = {
            "step": step,
            "num_leaves": len(arrays),
            "shapes": [list(a.shape) for a in arrays],
            "dtypes": [_dtype_name(x, a) for x, a in zip(tree_leaves, arrays)],
            "user": _jsonable(metadata or {}),
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        with open(self._marker(step), "w") as f:  # commit marker LAST
            f.write("ok")
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.committed_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            try:
                os.remove(self._marker(s))
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
            except OSError:
                pass

    def restore(self, step: int, template: Tree) -> Tuple[Tree, Dict]:
        d = self._step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        payload = np.load(os.path.join(d, "payload.npz"))
        arrays = [payload[f"leaf_{i}"] for i in range(meta["num_leaves"])]
        n_template = len(_stored(template))
        if n_template != len(arrays):
            raise ValueError(f"checkpoint step {step}: {len(arrays)} leaves, template has {n_template}")
        it = iter(arrays)
        restored = [None if t is None else _from_array(next(it), t) for t in leaves(template)]
        return unflatten(template, restored), _unjsonable(meta.get("user", {}))

    def restore_latest(self, template: Tree) -> Optional[Tuple[Tree, Dict]]:
        for step in reversed(self.committed_steps()):
            try:
                return self.restore(step, template)
            except (ValueError, OSError, KeyError):
                continue  # corrupt or incompatible: try the older one
        return None


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return {"__ndarray__": obj.tolist(), "dtype": str(obj.dtype)}
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj


def _unjsonable(obj):
    """Inverse of ``_jsonable`` for the ndarray encoding (other values
    round-trip through JSON natively)."""
    if isinstance(obj, dict):
        if "__ndarray__" in obj:
            return np.asarray(obj["__ndarray__"], dtype=obj["dtype"])
        return {k: _unjsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unjsonable(v) for v in obj]
    return obj
