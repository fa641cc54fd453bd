"""Cell builders: (arch x shape x mesh) -> the step a rank runs, with the
stand-ins and specs of its arguments: the port of ``repro.launch.steps``
(``:31-223``).

train cell  : ``core.hierfavg.build_train_step`` (a local update, then the
              due level sync) over stacked client params, the microbatch
              accumulation from the shape's specs.
prefill cell: the full-prompt forward building decode caches (serving).
decode cell : one decode step against the caches.

JAX's cell is one jitted program over the whole mesh. Here ``Cell.fn`` runs
on every rank of a ``dist.sharding.RankMesh`` with that rank's shards
(``shard_args``): the train cell's state holds the rank's clients (a
contiguous block of its "data" line: whole edges, or, on the production
meshes, part of one edge whose sync then all-reduces over the edge's
ranks) and its cloud sync is one all-reduce over the client axes; the serving cells take the rank's
requests, and under an "ep_data" mesh the rank holds its E/P experts' rows
and MoE's exchange runs one all-to-all each way. Over a "model" axis
larger than 1 a rank holds its tensor-parallel slices
(``dist.sharding.ShardingRules``) and every cell runs under the model
axis's hint, so the layers place their collectives, for every block
family; a head count or width that does not split is refused by name
(``dist.sharding.refuse_model_axis``). On a ("data", "model") mesh the
serving cells' MoE exchanges over "data" with each rank holding its
experts' f / M columns. ``mesh=None`` is the single-device cell.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.hierarchy import ShardPlacement, as_hierarchy
from repro_torch.core.hierfavg import (
    ClientSharding,
    build_cloud_sync,
    build_edge_sync,
    build_train_step,
    init_state,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist import sharding
from repro_torch.launch import specs as specs_mod
from repro_torch.models import transformer
from repro_torch.optim import sgd
from repro_torch.tree import tree_map

PyTree = Any


class Cell(NamedTuple):
    fn: Any  # runs on each rank with the rank's shards of the arguments
    arg_structs: Tuple  # meta stand-ins of the global arguments
    arg_specs: Tuple  # a PartitionSpec (or None: whole) per leaf of each argument
    meta: dict


class _NoMesh:
    """The single-device cell's mesh: no axes, every spec replicated."""

    axis_names: Tuple[str, ...] = ()
    shape: dict = {}


def _mesh_or_none(mesh, cfg: ArchConfig):
    if mesh is None:
        return _NoMesh()
    sharding.refuse_model_axis(mesh, cfg)
    return mesh


def _model_line(mesh):
    """The train cell's hint: this rank's line along a "model" axis larger
    than 1 (no "data" axis, so MoE keeps one token group as in training
    off-mesh), else None."""
    if isinstance(mesh, _NoMesh) or sharding.model_size(mesh) <= 1:
        return None
    return mesh.over(("model",))


def structs(fn) -> PyTree:
    """``fn()``'s output as meta stand-ins, computed under
    ``FakeTensorMode``: shapes and dtypes, no storage (JAX's
    ``eval_shape``). Non-tensor leaves pass through."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        out = fn()
    return tree_map(lambda x: specs_mod.meta(x.shape, x.dtype) if isinstance(x, torch.Tensor) else x, out)


def _init_params(cfg: ArchConfig):
    return transformer.init_params(torch.Generator().manual_seed(0), cfg)


def _same_structure(a, b) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same_structure(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same_structure(x, y) for x, y in zip(a, b))
    return not isinstance(a, (dict, list, tuple)) and not isinstance(b, (dict, list, tuple))


def _state_specs(state, params_specs):
    """FedState specs: params by the rules; optimizer subtrees that mirror
    the params tree take its specs; everything else whole."""

    def like(node):
        if _same_structure(node, state.params):
            return params_specs
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(like(c) for c in node))
        if isinstance(node, (list, tuple)):
            return type(node)(like(c) for c in node)
        if isinstance(node, dict):
            return {k: like(v) for k, v in node.items()}
        return None

    return type(state)(step=None, params=params_specs, opt_state=like(state.opt_state), rng=None,
                       anchor=None if state.anchor is None else params_specs,
                       residual=None if state.residual is None else params_specs)


def shard_args(cell: Cell, args: Tuple, mesh, device=None) -> Tuple:
    """This rank's part of a cell's concrete arguments, on ``device``
    (default: the mesh's): each leaf by its spec (a model rank's
    tensor-parallel slices among them); under an "ep_data" serving mesh the
    params keep only this rank's experts (``expert_rows``).
    ``mesh=None`` moves the arguments whole (to ``device`` when given)."""
    if mesh is None:
        move = (lambda x: x) if device is None else (lambda x: x.to(device) if isinstance(x, torch.Tensor) else x)
        return tuple(tree_map(move, a) for a in args)
    args = list(args)
    if cell.meta.get("ep_mode") == "ep_data":
        args[0] = sharding.expert_rows(args[0], mesh)
    return tuple(sharding.shard_tree(a, tree_map(lambda _: None, a) if s is None else s, mesh, device)
                 for a, s in zip(args, cell.arg_specs))


# ---------------------------------------------------------------------------
# Train cell
# ---------------------------------------------------------------------------


def _client_sharding(topo, mesh, weights: torch.Tensor) -> Optional[ClientSharding]:
    """The train cell's rank view: the rules' specs give each rank of the
    client axes ("data", and "pod") a contiguous block of clients (JAX's
    ``P(("pod", "data"))``), so the placement is the identity. Two layouts
    run: whole edges on each rank (every edge sync stays on its rank), or,
    on a two-level tree, each edge over k / E consecutive ranks with every
    rank's clients inside one edge (the production meshes: 4 edges of 4
    clients on 16 data ranks), whose edge sync all-reduces over the edge's
    ranks (``ClientSharding.edge``, ``dist.sharding.span_mesh``). Any other
    placement is refused by name; a client count that does not divide the
    client axes is refused with JAX's words (``ShardingRules``). The model
    ranks of one block hold the same clients; the sharding's mesh is the
    client axes' line, whose group the cloud sync's all-reduce runs on."""
    if isinstance(mesh, _NoMesh):
        return None
    rules = sharding.fed_rules(None, mesh)
    axes = rules.client_axes
    k = math.prod(int(mesh.shape[a]) for a in axes)
    if k == 1:
        return None
    spec = as_hierarchy(topo)
    n = spec.num_clients
    rules._client_member(n)  # JAX's refusal of a count the client axes do not divide
    clients = mesh.over(axes)
    placement = ShardPlacement(num_shards=k, capacity=n // k, perm=tuple(range(n)), spec=spec)
    edges = (spec.segments(1) if spec.depth >= 2 else np.arange(n)).reshape(k, n // k)
    top = (spec.segments(spec.depth - 1) if spec.depth >= 2 else np.arange(n)).reshape(k, n // k)
    if sum(len(set(row.tolist())) for row in top) == len(set(top.ravel().tolist())):
        return ClientSharding.build(sharding.client_axis_of(clients), placement, weights, mesh=clients)
    num_edges = len(set(edges.ravel().tolist()))
    span = k // num_edges
    if (spec.depth == 2 and k % num_edges == 0 and all(len(set(row.tolist())) == 1 for row in edges)
            and all(len(set(edges[j * span:(j + 1) * span, 0].tolist())) == 1 for j in range(num_edges))):
        edge = sharding.span_mesh(mesh, axes, span)
        return ClientSharding.build(sharding.client_axis_of(clients), placement, weights, mesh=clients, edge=edge)
    raise ValueError(f"the train cell needs whole edges on each rank, or each edge of a two-level tree over whole "
                     f"ranks: {n} clients in {k} contiguous blocks over {num_edges} edge(s) of "
                     f"{spec.describe()} fit neither")


def init_train_state(cfg: ArchConfig, mesh, params, rng: torch.Generator, *, lr: float = 1e-3):
    """The whole (N-row) initial state the train cell steps, from unstacked
    ``params``: ``init_state`` under the cell's topology, schedule and
    ``sgd(lr)``; ``shard_args`` cuts a rank's rows (and slices)."""
    m = _mesh_or_none(mesh, cfg)
    topo = sharding.topology_for(cfg, m)
    return init_state(rng, params, sgd(lr), topo, cfg.fed.schedule())


def build_train_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, *, lr: float = 1e-3,
                     device: DeviceLike = None) -> Cell:
    """``fn(state, batch) -> (state, metrics)``: one ``build_train_step`` on
    the rank's clients, ``grad_accum`` from the shape's specs, ``sgd(lr)``,
    equal client weights. Over a "data" axis of several ranks the metrics
    are per client (``build_train_step(shard=)``); over a "model" axis the
    rank steps its tensor-parallel slices under the model line's hint, and
    its grad norms are global over the model ranks
    (``build_train_step(model=)``). ``device`` places the single-device
    cell (``mesh=None``; default ``cuda``); a mesh's rank runs on the
    mesh's device."""
    m = _mesh_or_none(mesh, cfg)
    rules = sharding.fed_rules(cfg, m)
    topo = sharding.topology_for(cfg, m)
    n = topo.num_clients
    hier = cfg.fed.schedule()
    dev = resolve_device(device) if isinstance(m, _NoMesh) else m.device
    weights = torch.ones((n,), dtype=torch.float32)
    shard = _client_sharding(topo, m, weights)
    opt = sgd(lr)
    batch_structs, batch_specs, accum = specs_mod.train_batch_specs(cfg, shape, m)
    state_struct = structs(lambda: init_state(torch.Generator(), _init_params(cfg), opt, topo, hier))
    params_specs = rules.params_shardings(state_struct.params, scanned=cfg.scan_layers)
    state_specs = _state_specs(state_struct, params_specs)
    line = _model_line(m)
    model = None if line is None else sharding.ModelShards(line, rules.model_replicas(state_struct.params))
    step_fn = build_train_step(transformer.make_loss_fn(cfg), opt, topo, hier, weights.to(dev),
                               grad_accum=accum, shard=shard, model=model)
    return Cell(
        fn=_hinted(line, lambda state, batch: step_fn(state, batch)),
        arg_structs=(state_struct, batch_structs),
        arg_specs=(state_specs, batch_specs),
        meta={"kind": "train", "num_clients": n, "grad_accum": accum, "kappa1": hier.kappa1,
              "kappa2": hier.kappa2, "layout": cfg.fed.layout, "sharded": shard is not None,
              "edge_span": None if shard is None or shard.edge is None else shard.edge.size,
              "model": sharding.model_size(m)},
    )


# ---------------------------------------------------------------------------
# Serving cells
# ---------------------------------------------------------------------------


def _serve_params(cfg: ArchConfig, mesh) -> Tuple[PyTree, PyTree]:
    rules = sharding.serve_rules(cfg, mesh)
    p_struct = structs(lambda: _init_params(cfg))
    return p_struct, rules.params_shardings(p_struct, scanned=cfg.scan_layers)


def _ep_mode(cfg: ArchConfig, mesh, requests: int, req_spec) -> str:
    """The cell's MoE exchange mode; refuses requests that the data axis
    cannot split under "ep_data" (each rank's tokens must be its own)."""
    mode = sharding.ep_mode_for(None if isinstance(mesh, _NoMesh) else mesh, cfg.moe.num_experts) if (
        cfg.moe is not None) else "none"
    if mode == "ep_data" and req_spec[0] is None:
        raise ValueError(
            f"the expert-parallel MoE takes each rank's own tokens, but {requests} request(s) do not split "
            f"over the data axis of {mesh.shape['data']} (request_spec replicates them); send a multiple "
            f"of {mesh.shape['data']} requests"
        )
    return mode


def _hinted(mesh, fn):
    if mesh is None or isinstance(mesh, _NoMesh):
        return fn

    def run(*args):
        with sharding.using_hint_mesh(mesh):
            return fn(*args)

    return run


def build_prefill_cell(cfg: ArchConfig, shape: ShapeSpec, mesh) -> Cell:
    """``fn(params, inputs) -> (last-position logits, caches)`` of the rank's
    requests, under the hint mesh; over a "model" axis the logits are
    gathered (B, V) and the caches hold the rank's KV heads."""
    m = _mesh_or_none(mesh, cfg)
    params_struct, params_specs = _serve_params(cfg, m)
    req_struct, req_spec = specs_mod.prefill_request_specs(cfg, shape, m)
    mode = _ep_mode(cfg, m, shape.global_batch, req_spec)
    max_len = shape.seq_len
    return Cell(
        fn=_hinted(m, lambda params, inputs: transformer.prefill(params, cfg, inputs, max_len)),
        arg_structs=(params_struct, req_struct),
        arg_specs=(params_specs, req_spec),
        meta={"kind": "prefill", "max_len": max_len, "ep_mode": mode, "model": sharding.model_size(m)},
    )


def build_decode_cell(cfg: ArchConfig, shape: ShapeSpec, mesh) -> Cell:
    """``fn(params, caches, tokens, position) -> (logits, caches)``: one
    decode step of the rank's requests. The caches' specs are JAX's
    (``caches_shardings``); a rank's caches are those its prefill cell
    returned, already its own requests' and KV heads'."""
    m = _mesh_or_none(mesh, cfg)
    rules = sharding.serve_rules(cfg, m)
    params_struct, params_specs = _serve_params(cfg, m)
    req_structs, req_specs = specs_mod.decode_request_specs(cfg, shape, m)
    mode = _ep_mode(cfg, m, shape.global_batch, req_specs["tokens"])
    B, L = shape.global_batch, shape.seq_len
    cache_struct = structs(lambda: transformer.init_decode_caches(_init_params(cfg), cfg, B, L))
    cache_specs = rules.caches_shardings(cache_struct, scanned=cfg.scan_layers)

    def serve_step(params, caches, tokens, position):
        return transformer.decode_step(params, cfg, caches, tokens, position)

    return Cell(
        fn=_hinted(m, serve_step),
        arg_structs=(params_struct, cache_struct, req_structs["tokens"], req_structs["position"]),
        arg_specs=(params_specs, cache_specs, req_specs["tokens"], req_specs["position"]),
        meta={"kind": "decode", "cache_len": L, "ep_mode": mode, "model": sharding.model_size(m)},
    )


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh) -> Cell:
    if shape.kind == "train":
        return build_train_cell(cfg, shape, mesh)
    if shape.kind == "prefill":
        return build_prefill_cell(cfg, shape, mesh)
    if shape.kind == "decode":
        return build_decode_cell(cfg, shape, mesh)
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# Aggregation-phase cells
# ---------------------------------------------------------------------------


def build_aggregation_cells(cfg: ArchConfig, mesh, *, device: DeviceLike = None) -> Tuple[Cell, Cell]:
    """(edge_sync, cloud_sync) as cells of their own over the fed state's
    stacked params (``fn(state) -> state``), so each HierFAVG hop can be
    timed apart; on a mesh of several ranks the edge sync is rank-local and
    the cloud sync one all-reduce."""
    m = _mesh_or_none(mesh, cfg)
    rules = sharding.fed_rules(cfg, m)
    topo = sharding.topology_for(cfg, m)
    n = topo.num_clients
    hier = cfg.fed.schedule()
    dev = resolve_device(device) if isinstance(m, _NoMesh) else m.device
    weights = torch.ones((n,), dtype=torch.float32)
    shard = _client_sharding(topo, m, weights)
    state_struct = structs(lambda: init_state(torch.Generator(), _init_params(cfg), sgd(1e-3), topo, hier))
    state_specs = _state_specs(state_struct, rules.params_shardings(state_struct.params, scanned=cfg.scan_layers))
    edge = build_edge_sync(topo, hier, weights.to(dev), shard=shard)
    cloud = build_cloud_sync(topo, hier, weights.to(dev), shard=shard)
    cells = []
    for kind, sync in (("edge_sync", edge), ("cloud_sync", cloud)):
        cells.append(Cell(fn=(lambda f: lambda s: f(s))(sync), arg_structs=(state_struct,),
                          arg_specs=(state_specs,), meta={"kind": kind, "num_clients": n}))
    return cells[0], cells[1]
