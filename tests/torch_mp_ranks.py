"""What the ranks of the model-parallel, launch-cell, tensor-parallel and
dry-run tests run (``tests/test_torch_model_parallel.py``,
``tests/test_torch_launch_cells.py``, ``tests/test_torch_dryrun.py``,
``tests/test_torch_tensor_parallel.py``,
``tests/test_torch_tensor_parallel_families.py``).

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
    params = params_from_numpy(np_params, "cpu", mesh=mesh, cfg=cfg)
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


# ---------------------------------------------------------------------------
# Tensor parallelism over a "model" axis (tests/test_torch_tensor_parallel.py)
# ---------------------------------------------------------------------------


def tp_config(fields: Dict[str, Any], arch: str = "granite-3-2b"):
    """The smoke config of a tensor-parallel test: ``arch``'s smoke (the
    dense tests' granite-3-2b by default) with ``fields`` replaced; a
    ``"fed"`` entry is a dict of the ``FedPlan``'s fields to replace."""
    import dataclasses

    cfg = get_smoke(arch)
    fields = dict(fields)
    if "fed" in fields:
        fields["fed"] = dataclasses.replace(cfg.fed, **fields["fed"])
    return dataclasses.replace(cfg, **fields)


def _placed(x: torch.Tensor, spec, struct, mesh):
    """(this rank's block, the flat indices of its values in the global
    array): the spec applied to the global array's index grid."""
    grid = np.arange(int(np.prod(struct.shape))).reshape(tuple(struct.shape))
    return x.numpy(), np.asarray(spec.shard(grid, mesh))


def _tp_train(mesh, cfg, shape, np_params, batches, lr):
    cell = steps.build_train_cell(cfg, ShapeSpec(*shape), mesh, lr=lr)
    state = steps.init_train_state(cfg, mesh, params_from_numpy(np_params, "cpu"), torch.Generator().manual_seed(0),
                                   lr=lr)
    state, _ = steps.shard_args(cell, (state, None), mesh)
    metrics, counts = [], []
    for b in batches:
        _, batch = steps.shard_args(cell, (None, {k: torch.as_tensor(v) for k, v in b.items()}), mesh)
        sharding.reset_counts()
        state, m = cell.fn(state, batch)
        counts.append(dict(sharding.COUNTS))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    blocks = [_placed(x, spec, struct, mesh) for x, spec, struct in
              zip(leaves(state.params), leaves(cell.arg_specs[0].params), leaves(cell.arg_structs[0].params))]
    return {"metrics": metrics, "counts": counts, "blocks": blocks, "meta": dict(cell.meta)}


class _NextModelRank:
    """``mesh`` seen from the next rank of its "model" axis: a spec's slice
    under it is that rank's."""

    def __init__(self, mesh):
        self.mesh, self.axis_names, self.shape = mesh, mesh.axis_names, mesh.shape

    def axis_index(self, name):
        i = self.mesh.axis_index(name)
        return (i + 1) % int(self.shape[name]) if name == "model" else i


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _shapes(tree, prefix=""):
    """{"blocks/b0/k": shape, ...}: every tensor leaf's shape by its path."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _shapes(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _shapes(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tuple(tree.shape)}


def _tp_serve(mesh, cfg, np_params, prompts, tokens, max_len, swap=None):
    b, s = prompts.shape
    pre = steps.build_prefill_cell(cfg, ShapeSpec("prefill", max_len, b, "prefill"), mesh)
    dec = steps.build_decode_cell(cfg, ShapeSpec("decode", max_len, b, "decode"), mesh)
    params = params_from_numpy(np_params, "cpu", mesh=mesh, cfg=cfg)
    if swap is not None:  # the control: the next model rank's slice of the leaf at path ``swap``
        spec = _at(pre.arg_specs[0], swap)
        _at(params, swap[:-1])[swap[-1]] = torch.as_tensor(np.ascontiguousarray(
            spec.shard(_at(np_params, swap), _NextModelRank(mesh))))
    held = sum(x.numel() for x in leaves(params))
    _, inputs = steps.shard_args(pre, (None, torch.as_tensor(prompts)), mesh)
    sharding.reset_counts()
    logits, caches = pre.fn(params, inputs)
    out = {"prefill": logits.numpy(), "prefill_counts": dict(sharding.COUNTS), "decode": [], "held": held,
           "cache_shapes": _shapes(caches), "meta": dict(pre.meta)}
    for j in range(tokens.shape[1]):
        _, _, tok, pos = steps.shard_args(dec, (None, None, torch.as_tensor(tokens[:, j]),
                                                torch.full((b,), s + j, dtype=torch.int32)), mesh)
        sharding.reset_counts()
        logits, caches = dec.fn(params, caches, tok, pos)
        out["decode"].append(logits.numpy())
    out["decode_counts"] = dict(sharding.COUNTS)
    return out


def _tp_cross_entropy(mesh, logits, targets, mask):
    """The vocab-parallel loss on this rank's logit columns, and its
    gradient there (plain autograd)."""
    m, r = int(mesh.shape["model"]), mesh.axis_index("model")
    v = logits.shape[-1] // m
    local = torch.tensor(logits[..., r * v:(r + 1) * v], requires_grad=True)
    from repro_torch.models import transformer

    sharding.reset_counts()
    with sharding.using_hint_mesh(mesh):
        loss = transformer.cross_entropy(local, torch.as_tensor(targets), torch.as_tensor(mask))
        loss.backward()
    return {"loss": float(loss), "grad": local.grad.numpy(), "counts": dict(sharding.COUNTS)}


def tp_world(rank: int, world: int, jobs: List[Dict[str, Any]]) -> List[Any]:
    """Every job of a tensor-parallel test file on this rank of one gloo
    world, in order: "train" (the train cell over the job's batches),
    "serve" (the prefill cell, then a decode step per column of
    ``tokens``; ``swap``, a params path, takes the next model rank's slice
    of that leaf), "cross_entropy" (the vocab-parallel loss). Each job
    names its ("data", "model") mesh shape, the config's fields and its
    smoke ``arch`` (granite-3-2b by default)."""
    torch.set_num_threads(1)
    out = []
    for job in jobs:
        mesh = tmesh.make_host_mesh(job["mesh"], ("data", "model"), device="cpu")
        kind = job["kind"]
        if kind == "cross_entropy":
            out.append(_tp_cross_entropy(mesh, job["logits"], job["targets"], job["mask"]))
            continue
        cfg = tp_config(job["cfg"], job.get("arch", "granite-3-2b"))
        if kind == "train":
            out.append(_tp_train(mesh, cfg, job["shape"], job["params"], job["batches"], job["lr"]))
        else:
            out.append(_tp_serve(mesh, cfg, job["params"], job["prompts"], job["tokens"], job["max_len"],
                                 job.get("swap")))
    return out


def span_train_cell(rank: int, world: int, arch: str, shape: tuple, np_params, batches: List[Dict[str, np.ndarray]],
                    lr: float) -> Dict[str, Any]:
    """The train cell on a ("data", "model") mesh of (``world``, 1) whose
    edges span ranks (one client a rank, each edge over world / E ranks):
    after each call this rank's rows of every params leaf, its per-client
    losses, and the collectives ``analysis.opcount`` recorded (opcode, mesh
    axes, group size); the counted collectives of the whole run."""
    from repro_torch.analysis import opcount

    mesh = tmesh.make_host_mesh((world, 1), ("data", "model"), device="cpu")
    cfg = get_smoke(arch)
    cell = steps.build_train_cell(cfg, ShapeSpec(*shape), mesh, lr=lr)
    state = steps.init_train_state(cfg, mesh, params_from_numpy(np_params, "cpu"), torch.Generator().manual_seed(0),
                                   lr=lr)
    state, _ = steps.shard_args(cell, (state, None), mesh)
    sharding.reset_counts()
    params, losses, records = [], [], []
    for b in batches:
        _, batch = steps.shard_args(cell, (None, {k: torch.as_tensor(v) for k, v in b.items()}), mesh)
        (state, m), summary = opcount.count(cell.fn, state, batch, mesh=mesh, device="cpu")
        params.append([x.numpy().copy() for x in leaves(state.params)])
        losses.append(m["loss"].numpy())
        records.append([(c.opcode, c.axes, c.group_size) for c in summary.collectives])
    return {"params": params, "losses": losses, "records": records, "counts": dict(sharding.COUNTS),
            "meta": dict(cell.meta)}
