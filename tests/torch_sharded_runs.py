"""Runs of the client-sharded superround on a small problem, for the CPU
tests ``test_torch_sharded.py`` and ``test_torch_sharded_cohort.py``; a
module of its own so that the ranks ``dist.launch.spawn`` starts can import
its entry points by name.

A case is a plain dict (picklable, so ``dist.launch.spawn`` can hand it to
the ranks): the tree (``fanouts`` in the ``parse_fanouts`` grammar), the
schedule (``kappas``), optional ``transport`` / ``aggregators`` specs,
``sync_opt_state``, the optimizer (``"sgd"`` or ``"momentum"``), an
optional list of per-round survival masks and the number of cloud
intervals. The problem is the JAX package's own sharded test problem
(``tests/test_sharded.py``'s ``_quad``): client i pulls ``w`` toward a
centre c_i, with |D_i| in 1..3, both drawn from ``seed``.

``drive(case, mesh)`` runs it through ``build_sharded_super_round`` on this
rank's rows (``mesh`` a ``dist.sharding.ClientMesh``) or, with ``mesh``
None, through the single-device ``build_super_round``, and returns numpy:
the canonical final state's leaves, the per-interval loss and grad norm
reduced as the engine reduces them, the step counts, and the all-reduces
the run made. ``run_cases(rank, world, cases)`` is the ``spawn`` entry.
Nothing here imports ``jax``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

DIM = 3


def quad_problem(n: int, seed: int):
    """(centres (n, DIM) f32, sizes (n,) f64), drawn as the JAX test draws."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n, DIM))
    sizes = rng.integers(1, 4, size=n).astype(np.float64)
    return centers.astype(np.float32), sizes


def quad_loss(params, batch, _rng):
    return 0.5 * torch.sum((params["w"] - batch["c"]) ** 2)


def build_config(case: Dict[str, Any]):
    from repro_torch.core.aggregation import AggregatorSpec
    from repro_torch.core.hierfavg import HierFAVGConfig
    from repro_torch.fed.transport import TransportSpec

    kw = {}
    if case.get("transport"):
        kw["transport"] = TransportSpec.parse(case["transport"])
    if case.get("aggregators"):
        kw["aggregators"] = AggregatorSpec.parse(case["aggregators"])
    return HierFAVGConfig.multi_level(case["kappas"], sync_opt_state=bool(case.get("sync_opt_state")), **kw)


def build_optimizer(name: str):
    from repro_torch.optim import momentum, sgd

    return momentum(0.1, 0.9) if name == "momentum" else sgd(0.1)


def state_numpy(state) -> Dict[str, Any]:
    """A canonical ``FedState``'s stacked leaves as numpy (scalar optimizer
    counts left out)."""
    from repro_torch.tree import leaves

    arr = lambda t: [] if t is None else [x.detach().cpu().numpy() for x in leaves(t)
                                          if isinstance(x, torch.Tensor) and x.dim() >= 1]
    return {"params": arr(state.params), "opt": arr(state.opt_state), "anchor": arr(state.anchor),
            "residual": arr(state.residual), "step": int(state.step)}


def drive(case: Dict[str, Any], mesh=None) -> Dict[str, Any]:
    from repro_torch.core.hierarchy import parse_fanouts, plan_shard_placement
    from repro_torch.core.hierfavg import build_sharded_super_round, build_super_round, init_state
    from repro_torch.dist import sharding
    from repro_torch.fed.engine import _MeshLayout

    spec = parse_fanouts(case["fanouts"])
    n = spec.num_clients
    cfg = build_config(case)
    opt = build_optimizer(case.get("opt", "sgd"))
    centers, sizes = quad_problem(n, case.get("seed", 0))
    w = torch.as_tensor(sizes, dtype=torch.float32)
    k1, k2 = cfg.kappa1, cfg.kappa2_effective
    state = init_state(torch.Generator().manual_seed(0), {"w": torch.zeros(DIM)}, opt, spec, cfg)
    block = np.broadcast_to(centers, (k2, k1, n, DIM))
    masks: Optional[List[np.ndarray]] = case.get("masks")
    layout = None
    if mesh is None:
        fn = build_super_round(quad_loss, opt, spec, cfg, w)
    else:
        placement = plan_shard_placement(spec, mesh.size)
        fn = build_sharded_super_round(quad_loss, opt, spec, cfg, w, mesh=mesh, placement=placement)
        layout = _MeshLayout(mesh, placement, n)
        state = layout.shard(state)
        block = layout.block(np.ascontiguousarray(block))
    before = sharding.COUNTS["all_reduce"]
    loss, gnorm, steps = [], [], []
    for q in range(case.get("intervals", 2)):
        stack = None if masks is None else np.stack(masks[q * k2:(q + 1) * k2]).astype(np.float32)
        batch = {"c": torch.as_tensor(np.ascontiguousarray(block))}
        if layout is None:
            state, m = fn(state, batch, None if stack is None else torch.as_tensor(stack))
            loss.append(m["loss"].numpy())
            gnorm.append(m["grad_norm"].numpy())
            steps.append(m["step"].tolist())
        else:
            state, m = fn(state, batch, layout.masks(stack))
            ls, gs, st = layout.reduce_metrics(m)
            loss.append(ls)
            gnorm.append(gs)
            steps.append(st)
    all_reduces = sharding.COUNTS["all_reduce"] - before
    if layout is not None:
        state = layout.unshard(state)
    return {**state_numpy(state), "loss": np.stack(loss), "grad_norm": np.stack(gnorm), "steps": steps,
            "all_reduce": all_reduces}


def run_cases(rank: int, world: int, cases: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """``dist.launch.spawn`` entry: every case on a ``world``-rank client
    mesh on the CPU (``sync_once`` for cases with a ``level``, else
    ``drive``)."""
    from repro_torch.dist.sharding import client_mesh

    mesh = client_mesh(world, device="cpu")
    return [sync_once(case, mesh) if "level" in case else drive(case, mesh) for case in cases]


def run_spec(overrides: List[str], *, device: str = "cpu", resume: bool = False) -> Dict[str, Any]:
    """``ExperimentSpec.parse(overrides).run_experiment(device=...)``, as
    numpy: the history, the final state's stacked leaves, whether the
    sharded engine ran (and the runner's ``_mesh_reason``), the collectives
    made and, under sampled participation, the client store."""
    from repro_torch.dist import sharding
    from repro_torch.fed.api import ExperimentSpec

    before = dict(sharding.COUNTS)
    runner, state = ExperimentSpec.parse(list(overrides)).run_experiment(device=device, resume=resume)
    engine = runner._engine
    out = {**state_numpy(state), "history": runner.records_to_dict(),
           "sharded": engine is not None and getattr(engine, "mesh", None) is not None,
           "engine_built": engine is not None, "mesh_reason": runner._mesh_reason,
           **{k: sharding.COUNTS[k] - before[k] for k in ("all_reduce", "eval_all_reduce", "gather")}}
    if runner.client_store is not None:
        store = runner.client_store.state()
        out["store"] = {"leaves": [np.array(a) for a in store["leaves"]], "touched": np.array(store["touched"])}
    return out


def run_specs(rank: int, world: int, jobs: List[Any]) -> List[Dict[str, Any]]:
    """``dist.launch.spawn`` entry: each ``(overrides, kwargs)`` job through
    ``run_spec`` with ``topology.mesh_axes=clients:<world>``."""
    return [run_spec(list(ov) + [f"topology.mesh_axes=clients:{world}"], **kw) for ov, kw in jobs]


def sync_once(case: Dict[str, Any], mesh=None) -> Dict[str, Any]:
    """One level-``case["level"]`` sync (``build_level_sync``, with
    ``shard=`` on a mesh) of random params (from ``seed``) under
    ``case["mask"]``: the canonical params and anchors as numpy. With
    ``case["span"]`` the clients lie on the ranks in order, each edge over
    that many ranks (the train cell's layout on the production meshes)."""
    from repro_torch.core.hierarchy import ShardPlacement, parse_fanouts, plan_shard_placement
    from repro_torch.core.hierfavg import ClientSharding, build_level_sync, init_state
    from repro_torch.dist.sharding import span_mesh
    from repro_torch.fed.engine import _MeshLayout

    spec = parse_fanouts(case["fanouts"])
    n = spec.num_clients
    cfg = build_config(case)
    opt = build_optimizer(case.get("opt", "sgd"))
    rng = np.random.default_rng(case.get("seed", 0))
    w = torch.as_tensor(rng.integers(1, 4, size=n).astype(np.float32))
    state = init_state(torch.Generator().manual_seed(0), {"w": torch.zeros(DIM)}, opt, spec, cfg)
    state = state._replace(params={"w": torch.as_tensor(rng.normal(size=(n, DIM)).astype(np.float32))})
    mask = case.get("mask")
    if mesh is None:
        out = build_level_sync(spec, cfg, w, case["level"])(state, None if mask is None else torch.as_tensor(mask))
    else:
        if case.get("span"):
            placement = ShardPlacement(num_shards=mesh.size, capacity=n // mesh.size, perm=tuple(range(n)),
                                       spec=spec)
            shard = ClientSharding.build("clients", placement, w, mesh=mesh,
                                         edge=span_mesh(mesh, mesh.axis_names, case["span"]))
        else:
            placement = plan_shard_placement(spec, mesh.size)
            shard = ClientSharding.build("clients", placement, w, mesh=mesh)
        layout = _MeshLayout(mesh, placement, n)
        sync = build_level_sync(spec, cfg, w, case["level"], shard=shard)
        local_mask = None if mask is None else layout.masks(np.asarray(mask, np.float32)[None])[0]
        out = layout.unshard(sync(layout.shard(state), local_mask))
    return state_numpy(out)


def run_all(rank: int, world: int, cases: List[Dict[str, Any]], jobs: List[Any]):
    """``run_cases`` then ``run_specs`` in one world: (their results)."""
    return run_cases(rank, world, cases), run_specs(rank, world, jobs)


def drive_cohort(case: Dict[str, Any], mesh=None) -> Dict[str, Any]:
    """``drive`` for sampled participation: ``case["cohorts"]`` holds each
    interval's sorted stratified cohort ids (of size ``cohort_size``), run
    through ``build_sharded_cohort_super_round`` on this rank's slots or,
    with ``mesh`` None, through ``build_cohort_super_round``. The state's C
    rows carry over from interval to interval (no store)."""
    from repro_torch.core.hierarchy import parse_fanouts, plan_cohort_placement
    from repro_torch.core.hierfavg import (
        _cohort_quotas,
        build_cohort_super_round,
        build_sharded_cohort_super_round,
        init_cohort_state,
    )
    from repro_torch.dist import sharding
    from repro_torch.fed.engine import _MeshLayout

    spec = parse_fanouts(case["fanouts"])
    c = int(case["cohort_size"])
    cfg = build_config(case)
    opt = build_optimizer(case.get("opt", "sgd"))
    centers, sizes = quad_problem(spec.num_clients, case.get("seed", 0))
    k1, k2 = cfg.kappa1, cfg.kappa2_effective
    state = init_cohort_state(torch.Generator().manual_seed(0), {"w": torch.zeros(DIM)}, opt, cfg, c)
    segments = np.stack([spec.segments(l) for l in range(1, spec.depth)]) if spec.depth > 1 else np.zeros((0, spec.num_clients))
    masks: Optional[List[np.ndarray]] = case.get("masks")
    layout = None
    if mesh is None:
        fn = build_cohort_super_round(quad_loss, opt, spec, cfg, cohort_size=c)
    else:
        placement = plan_cohort_placement(spec, _cohort_quotas(spec, c), mesh.size)
        fn = build_sharded_cohort_super_round(quad_loss, opt, spec, cfg, cohort_size=c, mesh=mesh,
                                              placement=placement)
        layout = _MeshLayout(mesh, placement, c)
        state = layout.shard(state)
    before = sharding.COUNTS["all_reduce"]
    loss, gnorm = [], []
    for q, ids in enumerate(case["cohorts"]):
        ids = np.asarray(ids, np.int64)
        block = np.ascontiguousarray(np.broadcast_to(centers[ids], (k2, k1, c, DIM)))
        stack = None if masks is None else np.stack(masks[q * k2:(q + 1) * k2]).astype(np.float32)
        w = sizes[ids].astype(np.float32)
        if layout is None:
            cohort = {"segments": segments[:, ids], "weights": w}
            state, m = fn(state, {"c": torch.as_tensor(block)}, cohort,
                          None if stack is None else torch.as_tensor(stack))
            loss.append(m["loss"].numpy())
            gnorm.append(m["grad_norm"].numpy())
        else:
            w_local = torch.as_tensor(layout.weights(w))
            state, m = fn(state, {"c": torch.as_tensor(layout.block(block))}, w_local, layout.masks(stack))
            ls, gs, _ = layout.reduce_metrics(m)
            loss.append(ls)
            gnorm.append(gs)
    all_reduces = sharding.COUNTS["all_reduce"] - before
    if layout is not None:
        state = layout.unshard(state)
    return {**state_numpy(state), "loss": np.stack(loss), "grad_norm": np.stack(gnorm), "all_reduce": all_reduces}
