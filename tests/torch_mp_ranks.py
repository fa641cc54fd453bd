"""What the ranks of the model-parallel and launch-cell tests run
(``tests/test_torch_model_parallel.py``, ``tests/test_torch_launch_cells.py``).

``dist.launch.spawn`` hands the ranks the tests' ``sys.path``, so they
import this module from beside the tests; it imports only ``repro_torch``.
Inputs and results travel as numpy.
"""
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get_smoke
from repro_torch.dist import sharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps
from repro_torch.models import layers, params_from_numpy
from repro_torch.tree import leaves


def moe_ep(rank: int, world: int, arch: str, np_moe: Dict[str, np.ndarray], x: np.ndarray,
           swap: bool = False) -> Dict[str, Any]:
    """``moe_apply`` on this rank's group of ``x`` under a ("data",) hint mesh
    of ``world`` ranks, holding this rank's experts (``swap``: the next
    rank's, the control); the counted collectives of the call."""
    mesh = tmesh.make_host_mesh((world,), ("data",), device="cpu")
    cfg = get_smoke(arch)
    owner = (rank + 1) % world if swap else rank
    e = cfg.moe.num_experts // world
    moe = {k: torch.as_tensor(v) for k, v in np_moe.items() if k not in ("w1", "w3", "w2", "shared")}
    for k in ("w1", "w3", "w2"):
        moe[k] = torch.as_tensor(np_moe[k][owner * e:(owner + 1) * e])
    moe["shared"] = {k: torch.as_tensor(v) for k, v in np_moe["shared"].items()}
    tg = x.shape[0] // world
    sharding.reset_counts()
    with sharding.using_hint_mesh(mesh):
        assert sharding.moe_ep_mode(cfg.moe.num_experts) == "ep_data"
        y, aux = layers.moe_apply(moe, torch.as_tensor(x[rank * tg:(rank + 1) * tg]), cfg)
    return {"y": y.numpy(), "aux": float(aux), "counts": dict(sharding.COUNTS)}


def train_cell(rank: int, world: int, arch: str, shape: tuple, np_params, batches: List[Dict[str, np.ndarray]],
               lr: float) -> Dict[str, Any]:
    """The train cell on this rank's clients over ``batches`` (global
    arrays): per step the rank's per-client losses; at the end its rows of
    every params leaf and the collectives made."""
    mesh = tmesh.make_host_mesh((world,), ("data",), device="cpu")
    cfg = get_smoke(arch)
    cell = steps.build_train_cell(cfg, ShapeSpec(*shape), mesh, lr=lr)
    params = params_from_numpy(np_params, "cpu")
    state = steps.init_train_state(cfg, mesh, params, torch.Generator().manual_seed(0), lr=lr)
    state, _ = steps.shard_args(cell, (state, {k: v for k, v in batches[0].items()}), mesh)
    sharding.reset_counts()
    losses, gsqs = [], []
    for b in batches:
        _, batch = steps.shard_args(cell, (None, {k: torch.as_tensor(v) for k, v in b.items()}), mesh)
        state, m = cell.fn(state, batch)
        losses.append(m["loss"].numpy())
        gsqs.append(m["gsq"].numpy())
    return {"params": [x.numpy() for x in leaves(state.params)], "losses": losses, "gsq": gsqs,
            "counts": dict(sharding.COUNTS), "meta": {k: v for k, v in cell.meta.items()}}


def serve_cells(rank: int, world: int, arch: str, np_params, prompts: np.ndarray, tokens: np.ndarray,
                max_len: int) -> Dict[str, Any]:
    """The prefill cell on this rank's requests, then one decode step per
    column of ``tokens`` (B, steps), under a ("data",) mesh; this rank's
    logits and the all-to-alls of each call."""
    mesh = tmesh.make_host_mesh((world,), ("data",), device="cpu")
    cfg = get_smoke(arch)
    b, s = prompts.shape
    pre = steps.build_prefill_cell(cfg, ShapeSpec("prefill", max_len, b, "prefill"), mesh)
    dec = steps.build_decode_cell(cfg, ShapeSpec("decode", max_len, b, "decode"), mesh)
    params = params_from_numpy(np_params, "cpu", mesh=mesh if pre.meta["ep_mode"] == "ep_data" else None)
    held = sum(x.numel() for x in leaves(params))
    _, inputs = steps.shard_args(pre, (None, torch.as_tensor(prompts)), mesh)
    sharding.reset_counts()
    logits, caches = pre.fn(params, inputs)
    out = {"prefill": logits.numpy(), "prefill_counts": dict(sharding.COUNTS), "decode": [],
           "ep_mode": pre.meta["ep_mode"], "held": held}
    for j in range(tokens.shape[1]):
        _, _, tok, pos = steps.shard_args(dec, (None, None, torch.as_tensor(tokens[:, j]),
                                                torch.full((b,), s + j, dtype=torch.int32)), mesh)
        sharding.reset_counts()
        logits, caches = dec.fn(params, caches, tok, pos)
        out["decode"].append(logits.numpy())
    out["decode_counts"] = dict(sharding.COUNTS)
    return out
