"""Mesh sharding over ``torch.distributed`` ranks: the port of
``repro.dist.sharding``.

JAX runs one program over a ``Mesh`` of devices and lets GSPMD and
``shard_map`` place the pieces. The port runs one process per rank: a
``RankMesh`` lays named axes (``("clients",)``, ``("data", "model")``,
``("pod", "data", "model")``) over the ranks of an initialised process
group, row-major, with a sub-group for each axis, and every tensor a rank
holds already is its shard. NCCL with one rank per GPU is how PyTorch
reaches several cards; gloo runs the same code on the CPU, and for several
ranks that share one card (PyTorch's gloo takes CUDA tensors for
``all_reduce`` and ``broadcast`` only, so the gathers and all-to-alls below
go through host tensors under gloo).

Four jobs, as in JAX:

* **The client-sharded superround** (``repro/dist/sharding.py:256-303``): a
  1-D mesh (``client_mesh``) shards the stacked client axis, each rank
  holds the rows of the clients placed on it
  (``core.hierarchy.ShardPlacement``), and the one ``lax.psum`` per cloud
  interval becomes one ``dist.all_reduce`` (``all_reduce_sum``). The slice
  helpers (``batch_block_sharding``, ``mask_stack_sharding``,
  ``fed_state_shardings``) stand where JAX has ``NamedSharding``s: each is
  a ``RowSharding`` that takes this rank's rows of a placement-ordered
  (kappa2, kappa1, padded_N, ...) block, (kappa2, padded_N) mask stack or
  (padded_N, ...) state leaf and puts them on the rank's device; given the
  rank's ``index``, of the canonical (N-row) ones.
* **Hints** (``set_hint_mesh`` / ``hint`` / ``hint_data_groups``, ``:44-81``):
  the mesh the model code consults. ``hint`` is the identity: JAX's
  ``with_sharding_constraint`` asks GSPMD to place a global array, and a
  rank's tensor already is its shard. MoE's expert-parallel exchange
  (``moe_ep_mode`` / ``moe_dispatch_exchange`` / ``moe_combine_exchange``,
  ``:84-164``) is one ``dist.all_to_all_single`` each way over the "data"
  sub-group, where JAX has ``lax.all_to_all`` under ``shard_map``.
* **Rules** (``ShardingRules`` via ``fed_rules`` / ``serve_rules``,
  ``:177-248``, ``:304-328``): JAX's ``PartitionSpec`` members for
  parameter, batch, request and cache trees, and each spec's slice of a
  tensor for this rank, with the tensor-parallel layout the port runs
  (below) where it differs from JAX's.
* **Tensor parallelism over "model"** (ROADMAP.md Queue 1 items 16 and
  16b: every block family). GSPMD places JAX's collectives inside the
  layers; here they are Megatron's four, written as
  ``torch.autograd.Function``s over the
  hint mesh's "model" sub-group: ``model_copy`` (identity forward,
  all-reduce backward: a column-parallel product's input), ``model_reduce``
  (all-reduce forward, identity backward: a row-parallel product's
  output), ``model_gather`` (all-gather of the last dim: the embedding's
  and the served logits' columns) and ``model_max`` (all-reduce max: the
  vocab-parallel cross-entropy's shift). Each has a ``vmap`` rule: the
  engine's local step is ``grad(vmap(loss))``, where a plain
  ``dist.all_reduce`` cannot run, and a sum over ranks commutes with the
  client axis, so the rule reduces the batched tensor once. Off a model
  axis larger than 1 each is the identity. The layout: ``wq``, ``wk``,
  ``wv``, ``w1``, ``w3``, ``lm_head`` and ``embed`` split their last dim
  (JAX's spec); ``wo`` and ``w2`` split dim -2 (row-parallel, where JAX
  splits the last); the RMSNorm scales stay whole (JAX splits a stacked
  one's last dim); with fewer KV heads than model ranks a rank keeps the
  KV head its query heads read (``HeadShare``), and the ranks that share
  it sum its gradient (``model_kv``). The other families split by channel
  or head (``_role``): the RG-LRU's channels (its 1-D ``a_r``, ``a_i`` and
  ``lambda`` too, which JAX keeps whole); MLA's heads (``wq_b``,
  ``wkv_b``), its latent projections and norms whole; the experts' f
  columns (``w2`` row-parallel), the router whole; the mLSTM's heads
  (``w_up`` whole, ``a_i`` / ``a_f`` by the heads' columns); the sLSTM's
  heads (``r_*`` by their head dim, the bias ``b`` by the rank's columns
  of each of its four gates: ``BlockSplit``). A count that does not split
  is refused by name (``refuse_model_axis``).

Every collective goes through one of the counted wrappers here
(``COUNTS``), so tests and ``chip_smoke.py`` can hold each path to its
collectives: one all-reduce per cloud interval, one all-to-all each way
per MoE call, 4L + 2 tensor-parallel all-reduces per loss and gradient of
an L-layer model.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike

LAUNCH_RECIPE = (
    "start one process per rank and initialise torch.distributed first: "
    "repro_torch.dist.launch.spawn(fn, world_size=K, backend='gloo'|'nccl'), or "
    "torchrun --nproc-per-node K with dist.init_process_group in the script"
)

# collectives made through the counted wrappers below, since the last reset:
# "all_reduce" the cloud syncs' (one per cloud interval), "edge_all_reduce"
# the edge syncs' of a train cell whose edges span ranks, "eval_all_reduce"
# the evals' cloud model (``aggregation.psum_cloud_model``), "all_to_all"
# MoE's expert-parallel exchanges (one dispatch and one combine per MoE
# call), "moe_aux_all_reduce" the MoE aux loss's router statistics; over
# the "model" axis "tp_all_reduce" the layers' and the loss's sums (forward
# and backward), "tp_all_reduce_max" the loss's shift, "tp_all_gather" the
# embedding's and the served logits' gathers, "tp_grad_norm" the grad-norm
# metric's sum, and "tp_bytes" the bytes every one of those sent in
COUNTS: Dict[str, int] = {"all_reduce": 0, "edge_all_reduce": 0, "eval_all_reduce": 0, "gather": 0, "broadcast": 0,
                          "all_to_all": 0, "moe_aux_all_reduce": 0, "tp_all_reduce": 0, "tp_all_reduce_max": 0,
                          "tp_all_gather": 0, "tp_grad_norm": 0, "tp_bytes": 0}


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


@dataclasses.dataclass(frozen=True, eq=False)
class RankMesh:
    """Named axes of the given sizes over ``size`` ranks of an initialised
    process group, row-major: this process's ``rank`` in the mesh, the
    mesh's process ``group`` (None: the default group), one sub-group per
    axis of size > 1 (``axis_group``), the ``device`` this rank's tensors
    live on and the group's ``backend``. A 1-D mesh is the client mesh of
    the sharded superround (``client_mesh``)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int
    group: Any
    device: torch.device
    backend: str
    axis_groups: Dict[Any, Any] = dataclasses.field(default_factory=dict, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The mesh's rank count."""
        return math.prod(self.sizes)

    @property
    def axis(self) -> str:
        """The first axis: a client mesh's one axis."""
        return self.axis_names[0]

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along ``name`` (JAX's ``lax.axis_index``)."""
        i = self.axis_names.index(name)
        return (self.rank // math.prod(self.sizes[i + 1:])) % self.sizes[i]

    def axis_group(self, name: str):
        """The process group of the ranks that differ from this one along
        ``name`` only."""
        if self.shape[name] == self.size:
            return self.group
        return self.axis_groups[name]

    def rows(self, capacity: int) -> slice:
        """This rank's positions of a placement-ordered client axis."""
        return slice(self.rank * capacity, (self.rank + 1) * capacity)

    def over(self, axes: Sequence[str]) -> "RankMesh":
        """The mesh of this rank's line along ``axes`` (those present, in
        the mesh's order): their sizes, this rank's row-major place among
        them, and the process group of that line. The line must be the
        whole mesh, one axis longer than 1, or two such axes (the groups
        ``rank_mesh`` made)."""
        names = tuple(a for a in self.axis_names if a in axes)
        sizes = tuple(self.shape[a] for a in names)
        n = math.prod(sizes)
        longer = tuple(a for a in names if self.shape[a] > 1)
        if n == self.size:
            group = self.group
        elif len(longer) == 1:
            group = self.axis_group(longer[0])
        elif longer in self.axis_groups:
            group = self.axis_groups[longer]
        else:
            raise ValueError(f"no process group spans the axes {names} of a {self.shape} mesh")
        rank = 0
        for a in names:
            rank = rank * self.shape[a] + self.axis_index(a)
        return RankMesh(axis_names=names, sizes=sizes, rank=rank, group=group, device=self.device,
                        backend=self.backend,
                        axis_groups={a: g for a, g in self.axis_groups.items()
                                     if (a in names if isinstance(a, str) else set(a) <= set(names))})


def ClientMesh(axis: str, size: int, rank: int, group, device: torch.device, backend: str) -> RankMesh:
    """The client-sharded superround's mesh: a ``RankMesh`` with the one
    axis ``axis`` of ``size`` ranks (``client_mesh`` builds it from the
    process group)."""
    return RankMesh(axis_names=(axis,), sizes=(int(size),), rank=rank, group=group, device=device, backend=backend)


# ---------------------------------------------------------------------------
# Hints and MoE's expert-parallel exchange
# ---------------------------------------------------------------------------

_HINT_MESH = None


def model_size(mesh) -> int:
    """The size of ``mesh``'s "model" axis (1 without a mesh or the axis)."""
    if mesh is None or "model" not in tuple(mesh.axis_names):
        return 1
    return int(mesh.shape["model"])


def refuse_model_axis(mesh, cfg) -> None:
    """Raise (ValueError, naming the count) when ``cfg`` cannot run
    tensor-parallel on ``mesh``'s "model" axis larger than 1: query heads,
    the RG-LRU width ``d_rnn``, the xLSTM heads, the MLP width ``d_ff`` or
    an expert's width ``d_ff_expert`` (and so the shared experts') that do
    not split, or GQA KV heads that divide neither way. Running such a block
    replicated instead would be silent. A vocabulary or model width that
    does not split keeps its leaf whole, as JAX's rule does."""
    m = model_size(mesh)
    if m <= 1:
        return
    kinds = set(cfg.block_pattern)
    attn = bool({"attn", "local_attn"} & kinds)
    counts = [("query heads", cfg.num_heads, attn),
              ("RG-LRU width d_rnn", cfg.d_rnn_resolved, "rglru" in kinds),
              ("xLSTM heads", cfg.num_heads, bool({"mlstm", "slstm"} & kinds)),
              ("MLP width d_ff", cfg.d_ff, True)]
    if cfg.moe is not None:  # the shared experts' width, a multiple of it, then splits too
        counts.append(("expert width d_ff_expert", cfg.moe.d_ff_expert, True))
    for what, n, present in counts:
        if present and n % m:
            raise ValueError(f'{cfg.name}: {what} {n} do not split over a "model" axis of {m}')
    hkv = cfg.num_kv_heads
    if attn and cfg.mla is None and hkv % m and m % hkv:
        raise ValueError(f'{cfg.name}: {hkv} KV heads and a "model" axis of {m} divide neither way; '
                         f"a rank could keep neither whole KV heads nor the one its query heads read")


def set_hint_mesh(mesh) -> None:
    """Install (or clear, with None) the mesh the model code consults: its
    "data" axis sets MoE's token groups and expert-parallel exchange, its
    "model" axis the layers' tensor-parallel collectives."""
    global _HINT_MESH
    _HINT_MESH = mesh


def hint_mesh():
    return _HINT_MESH


@contextlib.contextmanager
def using_hint_mesh(mesh):
    """``set_hint_mesh(mesh)`` for the body of a ``with``, then the mesh that
    was installed before (JAX's dry run installs its mesh around tracing)."""
    before = _HINT_MESH
    set_hint_mesh(mesh)
    try:
        yield mesh
    finally:
        set_hint_mesh(before)


def hint(x, *members):
    """The identity. JAX constrains a global array to ``P(*members)`` under
    the hint mesh; on a rank of a ``RankMesh`` the tensor already is this
    rank's shard, and there is nothing to place."""
    del members
    return x


def hint_data_groups() -> int:
    """MoE token groups = data-axis size of the hint mesh (1 off-mesh)."""
    mesh = _HINT_MESH
    if mesh is None or "data" not in mesh.axis_names:
        return 1
    return int(mesh.shape["data"])


def ep_mode_for(mesh, num_experts: int) -> str:
    """``moe_ep_mode`` on ``mesh`` (JAX's table): "ep_data" on a data axis
    of size > 1 that divides the expert count, else "none"."""
    if mesh is None or "data" not in mesh.axis_names:
        return "none"
    ndev = int(mesh.shape["data"])
    if ndev <= 1 or num_experts % ndev:
        return "none"
    return "ep_data"


def moe_ep_mode(num_experts: int) -> str:
    """Expert-parallel exchange mode of the MoE block under the hint mesh.

    "none" keeps the per-group dispatch on the rank (the only mode
    off-mesh). "ep_data" exchanges the group-major dispatch buffers with
    one all-to-all each way over the data axis; a rank then holds only its
    E/P experts' rows (``expert_rows``) and the tokens of its group."""
    return ep_mode_for(_HINT_MESH, num_experts)


def _ep_mesh(name: str, mode: str):
    if mode != "ep_data":
        raise ValueError(f"unknown ep mode: {mode}")
    if _HINT_MESH is None:
        raise RuntimeError(f"{name} needs a hint mesh")
    return _HINT_MESH


def moe_dispatch_exchange(buf_g: torch.Tensor, mode: str) -> torch.Tensor:
    """(G/P, E, C, d) this rank's group-major dispatch buffers -> (E/P,
    G*C, d) expert-major for its E/P experts: expert block p goes to rank p
    of the data axis, and what arrives is concatenated over the groups in
    rank order (``lax.all_to_all(split_axis=1, concat_axis=0, tiled=True)``).
    One ``all_to_all_single``, counted."""
    mesh = _ep_mesh("moe_dispatch_exchange", mode)
    p = int(mesh.shape["data"])
    gl, e, c, d = buf_g.shape
    send = buf_g.reshape(gl, p, e // p, c, d).transpose(0, 1)  # (P, G/P, E/P, C, d): block p for rank p
    recv = exchange_blocks(send, mesh, "data")  # recv[q]: rank q's groups for this rank's experts
    return recv.reshape(p * gl, e // p, c, d).transpose(0, 1).reshape(e // p, p * gl * c, d)


def moe_combine_exchange(out_buf: torch.Tensor, flat_e_g, ranks_g, gates, mode: str, capacity: int):
    """The inverse of ``moe_dispatch_exchange`` and the weighted combine:
    (E/P, G*C, d) expert outputs -> (G/P, Tg, d) f32 for this rank's
    groups. Slots past the capacity read 0 (JAX's gather with
    ``mode="fill"``). One ``all_to_all_single``, counted."""
    from repro_torch.models.layers import moe_combine

    mesh = _ep_mesh("moe_combine_exchange", mode)
    p = int(mesh.shape["data"])
    el, gc, d = out_buf.shape
    g = gc // capacity
    back = out_buf.reshape(el, g, capacity, d).transpose(0, 1)  # (G, E/P, C, d): groups of rank q in block q
    recv = exchange_blocks(back.reshape(p, g // p, el, capacity, d), mesh, "data")
    out_g = recv.transpose(0, 1).reshape(g // p, p * el, capacity, d)  # (G/P, E, C, d)
    return torch.stack([moe_combine(out_g[i], flat_e_g[i], ranks_g[i], gates[i]) for i in range(g // p)])


def expert_rows(params, mesh, axis: str = "data"):
    """``params`` with every MoE block's expert weights (``w1``, ``w3``,
    ``w2`` under a ``"moe"`` key; the expert dim is third from last, after
    any stacked superblock dims) cut to this rank's E/P experts along
    ``axis``: the rows the expert-parallel exchange delivers tokens to.
    Numpy leaves are sliced, tensors sliced and copied (the full leaf is
    not kept alive). Other leaves pass through."""
    p, r = int(mesh.shape[axis]), mesh.axis_index(axis)

    def cut(x):
        e = x.shape[-3]
        if e % p:
            raise ValueError(f"{e} experts do not divide the {axis!r} axis of {p}")
        part = x[..., r * (e // p):(r + 1) * (e // p), :, :]
        return part.clone() if isinstance(part, torch.Tensor) else part

    def walk(t, in_moe=False):
        if isinstance(t, dict):
            return {k: (cut(v) if in_moe and k in ("w1", "w3", "w2") else walk(v, k == "moe")) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return t

    return walk(params)


# ---------------------------------------------------------------------------
# Tensor parallelism over the hint mesh's "model" axis
# ---------------------------------------------------------------------------


def hint_model_mesh():
    """The hint mesh when its "model" axis is larger than 1, else None: the
    one place the layers ask whether they hold a slice."""
    return _HINT_MESH if model_size(_HINT_MESH) > 1 else None


def model_kv_heads(num_kv_heads: int) -> int:
    """The KV heads a rank holds under the hint mesh: Hkv / M of them, or
    the one its query heads read when Hkv < M (every head off a model
    axis)."""
    m = model_size(_HINT_MESH)
    return num_kv_heads // m if num_kv_heads % m == 0 else 1


def _count(counter: str, x: torch.Tensor) -> None:
    COUNTS[counter] += 1
    COUNTS["tp_bytes"] += x.numel() * x.element_size()


def _model_all_reduce(x: torch.Tensor, mesh: RankMesh, op=dist.ReduceOp.SUM, counter: str = "tp_all_reduce"
                      ) -> torch.Tensor:
    """``x`` reduced over the "model" sub-group into a fresh tensor (never
    in place: autograd may hold ``x``). Counted with its bytes."""
    _count(counter, x)
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=mesh.axis_group("model"))
    return out


def _model_all_gather(x: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """(..., w) -> (..., M w): the model ranks' last dims side by side in
    rank order. NCCL gathers; gloo (whose CUDA tensors take only all-reduce
    and broadcast) sums zero-padded copies, exact since each place has one
    non-zero addend."""
    _count("tp_all_gather", x)
    m, r, w = int(mesh.shape["model"]), mesh.axis_index("model"), x.shape[-1]
    group = mesh.axis_group("model")
    if mesh.backend == "nccl":
        parts = torch.empty((m,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(parts, x.contiguous(), group=group)
        return parts.movedim(0, -2).reshape(*x.shape[:-1], m * w)
    out = x.new_zeros(*x.shape[:-1], m * w)
    out[..., r * w:(r + 1) * w] = x
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _batched(fn, x, bdim):
    """A ``vmap`` rule's result for a function whose last dim is the
    feature dim: the batch dim moved to the front, the ``Function`` applied
    once to the physical tensor."""
    if bdim is None:
        return fn(x), None
    return fn(x.movedim(bdim, 0)), 0


class _ModelCopy(torch.autograd.Function):
    """Identity forward, all-reduce backward over "model" (Megatron's f):
    the input of column-parallel products, whose gradient each rank holds
    only its slice's share of."""

    @staticmethod
    def forward(x, mesh):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _model_all_reduce(g, ctx.mesh), None

    @staticmethod
    def vmap(info, in_dims, x, mesh):
        return _batched(lambda t: _ModelCopy.apply(t, mesh), x, in_dims[0])


class _ModelReduce(torch.autograd.Function):
    """All-reduce forward, identity backward over "model" (Megatron's g):
    the partial sums of row-parallel products and of the vocab-parallel
    loss. Every rank's replica of what follows is whole, so its gradient
    already is the sum's."""

    @staticmethod
    def forward(x, mesh):
        return _model_all_reduce(x, mesh)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def vmap(info, in_dims, x, mesh):
        return _batched(lambda t: _ModelReduce.apply(t, mesh), x, in_dims[0])


class _ModelGather(torch.autograd.Function):
    """All-gather of the last dim over "model" forward; backward this rank's
    columns of the (whole, replicated) gradient."""

    @staticmethod
    def forward(x, mesh):
        return _model_all_gather(x, mesh)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, mesh = inputs
        ctx.mesh, ctx.width = mesh, x.shape[-1]

    @staticmethod
    def backward(ctx, g):
        r, w = ctx.mesh.axis_index("model"), ctx.width
        return g[..., r * w:(r + 1) * w].contiguous(), None

    @staticmethod
    def vmap(info, in_dims, x, mesh):
        return _batched(lambda t: _ModelGather.apply(t, mesh), x, in_dims[0])


class _ModelMax(torch.autograd.Function):
    """All-reduce max over "model", not differentiated: the loss's shift,
    on which the log-sum-exp's value does not depend."""

    @staticmethod
    def forward(x, mesh):
        return _model_all_reduce(x, mesh, dist.ReduceOp.MAX, "tp_all_reduce_max")

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh):
        return _batched(lambda t: _ModelMax.apply(t, mesh), x, in_dims[0])


class _ModelKV(torch.autograd.Function):
    """Identity forward on a KV projection that M / Hkv model ranks share
    (one head each); backward the sum of their gradients, from one
    all-reduce of a buffer with a slot per head: each rank writes its
    head's slot, so the ranks of one head sum and the others add zeros."""

    @staticmethod
    def forward(w, mesh, heads):
        return w.view_as(w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.heads = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        mesh, heads = ctx.mesh, ctx.heads
        slot = mesh.axis_index("model") * heads // int(mesh.shape["model"])
        buf = g.new_zeros((heads,) + tuple(g.shape))
        buf[slot] = g
        return _model_all_reduce(buf, mesh)[slot], None, None

    @staticmethod
    def vmap(info, in_dims, w, mesh, heads):
        return _batched(lambda t: _ModelKV.apply(t, mesh, heads), w, in_dims[0])


def model_copy(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel product (identity off a model axis)."""
    mesh = hint_model_mesh()
    return x if mesh is None else _ModelCopy.apply(x, mesh)


def model_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model ranks of a row-parallel product's partial
    output (identity off a model axis)."""
    mesh = hint_model_mesh()
    return x if mesh is None else _ModelReduce.apply(x, mesh)


def model_gather(x: torch.Tensor) -> torch.Tensor:
    """The model ranks' last dims side by side (identity off a model axis)."""
    mesh = hint_model_mesh()
    return x if mesh is None else _ModelGather.apply(x, mesh)


def model_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the model ranks, not differentiated (``x``
    detached off a model axis)."""
    mesh = hint_model_mesh()
    return x.detach() if mesh is None else _ModelMax.apply(x.detach(), mesh)


def model_kv(w: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    """A KV projection whose gradient the model ranks sharing its head sum
    (Hkv < M); ``w`` itself otherwise."""
    mesh = hint_model_mesh()
    if mesh is None or num_kv_heads >= int(mesh.shape["model"]):
        return w
    return _ModelKV.apply(w, mesh, num_kv_heads)


def model_offset(local: int) -> int:
    """Where this rank's ``local`` columns of a last-dim split start (0 off
    a model axis): the first vocabulary id of its logits."""
    mesh = hint_model_mesh()
    return 0 if mesh is None else mesh.axis_index("model") * local


@dataclasses.dataclass(frozen=True, eq=False)
class ModelShards:
    """What a train step needs to report a global grad norm from a model
    rank's slices: the mesh whose "model" sub-group sums, and for each
    params leaf (``tree.leaves`` order) how many model ranks hold the same
    values (1: a slice of its own; M: whole, as the norms; M / Hkv: a
    shared KV head), so that each value counts once."""

    mesh: RankMesh
    replicas: Tuple[int, ...]

    def sum_sq(self, sq: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global sum of the leaves' squared sums ``sq`` (scalars, or
        (C,) per client): one counted all-reduce."""
        local = sum(s if r == 1 else s / r for s, r in zip(sq, self.replicas))
        return _model_all_reduce(local, self.mesh, counter="tp_grad_norm")


# ---------------------------------------------------------------------------
# The mesh and its counted collectives
# ---------------------------------------------------------------------------


def client_axis_of(mesh) -> str:
    """The mesh axis the stacked client dim shards over: ``"clients"`` when
    present, else the mesh's first axis."""
    names = tuple(mesh.axis_names)
    return "clients" if "clients" in names else names[0]


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def _rank_device(device: DeviceLike, rank: int) -> torch.device:
    """``cuda`` (or None) is ``cuda:(local_rank % device_count)``; any other
    name is taken as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run the ranks on the CPU")
        dev = torch.device("cuda", _local_rank(rank) % torch.cuda.device_count())
    return dev


def _fake_world() -> bool:
    """Whether the process group is ``torch.testing``'s "fake" backend (no
    collective moves a byte): the dry run's world of 256 or 512 ranks."""
    return str(dist.get_backend()) == "fake"


def _check_backend(backend: str, dev: torch.device, k: int) -> None:
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the NCCL backend needs CUDA devices, got {dev}; use backend='gloo' on the CPU")
        local = int(os.environ.get("LOCAL_WORLD_SIZE", k))
        if local > torch.cuda.device_count():
            raise ValueError(
                f"NCCL refuses two ranks on one GPU: {local} ranks on this node share "
                f"{torch.cuda.device_count()} device(s); use backend='gloo' for ranks that share a card"
            )


def _world() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"a rank mesh needs an initialised torch.distributed process group; {LAUNCH_RECIPE}")
    return dist.get_world_size()


def rank_mesh(shape: Sequence[int], axes: Sequence[str], *, device: DeviceLike = None,
              present_as: Optional[str] = None) -> RankMesh:
    """A ``RankMesh`` of ``shape`` named ``axes`` over every rank of the
    initialised process group, row-major; the world must have exactly
    prod(shape) ranks (``launch.mesh`` words the error as JAX does). Every
    rank makes every axis sub-group, and the groups of the lines along two
    axes (the multi-pod mesh's ("pod", "data") client line), in one order,
    as ``dist.new_group`` needs.

    A "fake" world (the dry run's) presents itself as ``present_as``
    (default "nccl"), so the ranks take that backend's program, and its
    device is ``device`` as given (default ``cuda:0``), asking the CUDA
    runtime nothing: its tensors are fake."""
    sizes = tuple(int(n) for n in shape)
    axes = tuple(axes)
    if len(sizes) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {sizes} and axes {axes} do not match")
    n = math.prod(sizes)
    world = _world()
    if n != world:
        raise ValueError(f"a {sizes} mesh needs {n} ranks, the process group has {world}; {LAUNCH_RECIPE}")
    rank = dist.get_rank()
    groups = {}
    grid = np.arange(n).reshape(sizes)
    for i, name in enumerate(axes):
        if sizes[i] in (1, n):
            continue  # a one-rank axis needs no group; a whole-mesh axis uses the mesh's
        lines = np.moveaxis(grid, i, -1).reshape(-1, sizes[i])
        for line in lines:  # every rank makes every group, in this order
            g = dist.new_group([int(x) for x in line])
            if rank in line:
                groups[name] = g
    # the lines along two axes longer than 1 that are not the whole mesh:
    # ("pod", "data"), the client axes of the multi-pod mesh
    longer = [i for i in range(len(axes)) if sizes[i] > 1]
    for j, i in enumerate(longer):
        for k in longer[j + 1:]:
            if sizes[i] * sizes[k] == n:
                continue
            lines = np.moveaxis(grid, (i, k), (-2, -1)).reshape(-1, sizes[i] * sizes[k])
            for line in lines:
                g = dist.new_group([int(x) for x in line])
                if rank in line:
                    groups[(axes[i], axes[k])] = g
    if _fake_world():
        dev = torch.device("cuda", 0) if device is None else torch.device(device)
        return RankMesh(axis_names=axes, sizes=sizes, rank=rank, group=None, device=dev,
                        backend=present_as or "nccl", axis_groups=groups)
    backend = str(dist.get_backend())
    dev = _rank_device(device, rank)
    _check_backend(backend, dev, n)
    return RankMesh(axis_names=axes, sizes=sizes, rank=rank, group=None, device=dev, backend=backend,
                    axis_groups=groups)


def span_mesh(mesh: RankMesh, axes: Sequence[str], span: int) -> RankMesh:
    """This rank's block of ``span`` consecutive ranks along its line of
    ``axes`` (those present, row-major, as ``RankMesh.over``): a 1-D mesh
    over the block's process group, the ranks that share one edge of a
    train cell whose edges span ranks. ``mesh`` lies over the whole world
    (``rank_mesh``); every rank makes every block's group of every line, in
    one order, as ``dist.new_group`` needs."""
    names = tuple(a for a in mesh.axis_names if a in axes)
    k = math.prod(mesh.shape[a] for a in names)
    if span < 1 or k % span:
        raise ValueError(f"blocks of {span} ranks do not tile a line of {k} along {names}")
    dims = [mesh.axis_names.index(a) for a in names]
    grid = np.arange(mesh.size).reshape(mesh.sizes)
    lines = np.moveaxis(grid, dims, list(range(grid.ndim - len(dims), grid.ndim))).reshape(-1, k)
    mine, pos = None, 0
    for line in lines:
        for j in range(k // span):
            block = [int(x) for x in line[j * span:(j + 1) * span]]
            g = dist.new_group(block)
            if mesh.rank in block:
                mine, pos = g, block.index(mesh.rank)
    return RankMesh(axis_names=(names[-1],), sizes=(span,), rank=pos, group=mine, device=mesh.device,
                    backend=mesh.backend)


def client_mesh(num_devices: int = 0, axis: str = "clients", *, device: DeviceLike = None) -> RankMesh:
    """A 1-D ``RankMesh`` over the first ``num_devices`` ranks of the
    initialised process group (0 or None: every rank). Needs the group: it
    raises when there is none, and when K exceeds the world; it never runs
    single-device instead. Each rank's device is ``cuda:(local_rank %
    device_count)`` unless ``device`` names another (``"cpu"``)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"a client mesh needs an initialised torch.distributed process group; {LAUNCH_RECIPE}")
    world = dist.get_world_size()
    k = world if not num_devices else int(num_devices)
    if k < 1:
        raise ValueError(f"client mesh needs a positive rank count, got {k}")
    if k > world:
        raise ValueError(
            f"requested a {k}-rank client mesh but the process group has only {world} rank(s); "
            f"{LAUNCH_RECIPE}"
        )
    rank = dist.get_rank()
    group = None if k == world else dist.new_group(list(range(k)))
    if rank >= k:
        raise ValueError(f"rank {rank} is outside the {k}-rank client mesh (world of {world})")
    backend = str(dist.get_backend(group))
    dev = _rank_device(device, rank)
    _check_backend(backend, dev, k)
    return ClientMesh(axis, k, rank, group, dev, backend)


# ---------------------------------------------------------------------------
# Counted collectives
# ---------------------------------------------------------------------------


def all_reduce_sum(vec: torch.Tensor, mesh: RankMesh, counter: str = "all_reduce", axis: Optional[str] = None
                   ) -> torch.Tensor:
    """Sum ``vec`` over the mesh's ranks (or over ``axis``'s sub-group) in
    place (one ``dist.all_reduce``, counted under ``counter``) and return
    it: the port's ``lax.psum``."""
    COUNTS[counter] += 1
    group = mesh.group if axis is None else mesh.axis_group(axis)
    dist.all_reduce(vec, op=dist.ReduceOp.SUM, group=group)
    return vec


def exchange_blocks(x: torch.Tensor, mesh: RankMesh, axis: str) -> torch.Tensor:
    """(P, ...) -> (P, ...) over ``axis``'s P ranks: block p goes to rank
    p, and block q of the result came from rank q. One
    ``dist.all_to_all_single``, counted as ``"all_to_all"``; under gloo the
    bytes travel through host tensors, and the result comes back to ``x``'s
    device. A failed exchange raises."""
    COUNTS["all_to_all"] += 1
    group = mesh.axis_group(axis)
    if mesh.backend == "nccl":
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out
    host = x.contiguous().cpu()
    out = torch.empty_like(host)
    dist.all_to_all_single(out, host, group=group)
    return out.to(x.device)


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def gather_rows(x: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """Every rank's (c, ...) rows concatenated in rank order, (K*c, ...), on
    ``x``'s device. Under gloo the bytes travel through host tensors."""
    COUNTS["gather"] += 1
    if mesh.size == 1:
        return x
    if mesh.backend == "nccl":
        out = torch.empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.group)
        return out
    host = _bytes(x.cpu())
    parts = [torch.empty_like(host) for _ in range(mesh.size)]
    dist.all_gather(parts, host, group=mesh.group)
    # each part straight into its rows (no host concatenation); this
    # rank's own rows from ``x``
    out = torch.empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    for r, part in enumerate(parts):
        rows = out[r * x.shape[0]:(r + 1) * x.shape[0]]
        rows.copy_(x if r == mesh.rank else part.view(x.dtype).reshape(x.shape))
    return out


def broadcast_object(obj: Any, src: int, mesh: RankMesh) -> Any:
    """``obj`` from rank ``src`` (pickled), on every rank."""
    COUNTS["broadcast"] += 1
    box = [obj if mesh.rank == src else None]
    dist.broadcast_object_list(box, src=src, group=mesh.group,
                               device=mesh.device if mesh.backend == "nccl" else None)
    return box[0]


def barrier(mesh: RankMesh) -> None:
    if mesh.size > 1:
        dist.barrier(group=mesh.group)


# ---------------------------------------------------------------------------
# Slice helpers (the NamedShardings of the JAX engine)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class RowSharding:
    """This rank's part of an array whose dim ``dim`` is a client axis
    (``dim`` None: the whole array, replicated), on the mesh's device: the
    one answer to "which rows are this rank's".

    Without ``index`` the axis is placement-ordered (padded_N positions) and
    the rank takes its block of ``capacity`` positions (``RankMesh.rows``).
    With ``index`` (this rank's canonical rows in placement order:
    ``ShardPlacement.gather_index()`` at its positions, phantoms reading row
    0) the axis is canonical (N rows) and the rank takes those rows, the
    permute and the slice in one. ``take`` slices where the array lies
    (numpy or torch); a call also moves the part to the mesh's device.
    Applied to a non-tensor (the generator) a call passes it through."""

    mesh: RankMesh
    dim: Optional[int]
    index: Optional[np.ndarray] = None

    def take(self, x):
        if self.dim is None:
            return x
        if self.index is not None:
            if isinstance(x, np.ndarray):
                return np.take(x, self.index, axis=self.dim)
            return x.index_select(self.dim, torch.as_tensor(self.index, dtype=torch.long, device=x.device))
        return x[(slice(None),) * self.dim + (self.mesh.rows(x.shape[self.dim] // self.mesh.size),)]

    def __call__(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if not isinstance(x, torch.Tensor):
            return x
        if self.index is not None:  # a canonical state already lies on the device: gather there
            return self.take(x.to(self.mesh.device))
        return self.take(x).to(self.mesh.device)


def batch_block_sharding(mesh: RankMesh, axis: str = "clients", *, index=None) -> RowSharding:
    """Superround batch blocks (kappa2, kappa1, N, b, ...): this rank's
    clients of dim 2."""
    return RowSharding(mesh, 2, index)


def mask_stack_sharding(mesh: RankMesh, axis: str = "clients", *, index=None) -> RowSharding:
    """Survival mask stacks (kappa2, N): this rank's columns."""
    return RowSharding(mesh, 1, index)


def fed_state_shardings(mesh: RankMesh, axis: str, state, stacked_dim: int, *, index=None):
    """A ``FedState`` of ``RowSharding``s for a stacked state whose leaves
    carry the leading ``stacked_dim`` client axis: those take this rank's
    rows, everything else (step, rng, scalar optimizer leaves) is
    replicated. ``checkpoint.reshard.to_mesh`` applies it."""
    from repro_torch.core.hierfavg import fed_state_partition_specs

    specs = fed_state_partition_specs(state, axis, stacked_dim)
    return type(specs)(*(_spec_tree(mesh, f, index) for f in specs))


def _spec_tree(mesh: RankMesh, tree, index):
    """Specs (the axis name: rows; "": replicated; None: an absent field)
    to ``RowSharding``s."""
    from repro_torch.tree import tree_map

    return tree_map(lambda s: None if s is None else RowSharding(mesh, 0 if s else None, index if s else None),
                    tree)


# ---------------------------------------------------------------------------
# Tree sharding rules
# ---------------------------------------------------------------------------


class PartitionSpec:
    """One member per dim, as JAX's ``PartitionSpec``: an axis name, a tuple
    of axis names (the dim splits over their product, the first major), or
    None (replicated). Compares equal to the tuple of its members. A leaf,
    not a sequence, for ``tree.tree_map``. ``shard(x, mesh)`` is this
    rank's slice of ``x`` (a view)."""

    __slots__ = ("members",)

    def __init__(self, *members):
        self.members = tuple(members)

    def __iter__(self):
        return iter(self.members)

    def __len__(self) -> int:
        return len(self.members)

    def __getitem__(self, i):
        return self.members[i]

    def __eq__(self, other) -> bool:
        return tuple(self) == tuple(other) if isinstance(other, (tuple, PartitionSpec)) else NotImplemented

    def __hash__(self) -> int:
        return hash(self.members)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.members!r}"

    def shard(self, x, mesh):
        """This rank's block of each sharded dim of ``x`` (numpy or torch)."""
        index = []
        for dim, member in enumerate(self.members):
            if member is None:
                index.append(slice(None))
                continue
            if isinstance(member, HeadShare):
                size = x.shape[dim] // member.heads
                head = member.head(mesh)
                index.append(slice(head * size, (head + 1) * size))
                continue
            if isinstance(member, BlockSplit):
                pos = member.positions(x.shape[dim], mesh)
                index.append(pos if isinstance(x, np.ndarray) else torch.as_tensor(pos, device=x.device))
                continue
            names = member if isinstance(member, tuple) else (member,)
            count, block = 1, 0
            for name in names:
                count *= int(mesh.shape[name])
                block = block * int(mesh.shape[name]) + mesh.axis_index(name)
            if x.shape[dim] % count:
                raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split {count} ways over {names}")
            size = x.shape[dim] // count
            index.append(slice(block * size, (block + 1) * size))
        return x[tuple(index)]


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class HeadShare:
    """A spec member for a dim of ``heads`` KV heads over an ``axis`` of
    more ranks: each rank keeps the one head its query heads read, head
    ``axis_index * heads // size`` (``size / heads`` ranks a head)."""

    axis: str
    heads: int

    def head(self, mesh) -> int:
        return mesh.axis_index(self.axis) * self.heads // int(mesh.shape[self.axis])


@dataclasses.dataclass(frozen=True)
class BlockSplit:
    """A spec member for a dim of ``blocks`` equal blocks side by side (the
    sLSTM bias: its i, f, z and o gates), each split over ``axis``: a rank
    keeps its part of every block, in block order (a strided cut; the
    slice is a copy, not a view)."""

    axis: str
    blocks: int

    def positions(self, n: int, mesh) -> np.ndarray:
        m, r = int(mesh.shape[self.axis]), mesh.axis_index(self.axis)
        width = n // self.blocks
        if n % self.blocks or width % m:
            raise ValueError(f"{self.blocks} blocks of a dim of {n} do not split {m} ways over {self.axis!r}")
        part = width // m
        return np.concatenate([np.arange(b * width + r * part, b * width + (r + 1) * part)
                               for b in range(self.blocks)])


def _last_dim_member(mesh, shape, axis: str):
    if len(shape) < 2 or axis not in mesh.axis_names:
        return None
    return axis if shape[-1] % mesh.shape[axis] == 0 else None


# the tensor-parallel roles of leaves (``ShardingRules.params_shardings``):
# "whole" (RMSNorm scales, MLA's latent projections and norms, the MoE
# router, the mLSTM's ``w_up``), "row" (split dim -2: the row-parallel
# outputs ``wo``, ``w2``, ``w_out``, ``w_down``), "kv" (a GQA attention's
# ``wk`` / ``wv``: whole KV heads), "channel" (the last dim split whatever
# the rank: the RG-LRU's and the mLSTM's 1-D gate parameters), "heads"
# (dim -3: the sLSTM's recurrent (H, dh, dh) blocks), "quarters" (the sLSTM
# bias, ``BlockSplit``); every other leaf splits its last dim, as JAX's rule
NORMS = ("norm1", "norm2", "final_norm")
GQA_KEYS = frozenset(("wq", "wk", "wv", "wo"))
MLP_PARENTS = ("mlp", "shared", "dense", "moe")  # a dense MLP, the MoE's shared / dense branches and its experts
SLSTM_RECURRENT = ("r_i", "r_f", "r_z", "r_o")


def _role(key, parent, siblings) -> str:
    if key in NORMS:
        return "whole"
    if parent == "attn" and GQA_KEYS <= siblings:
        return {"wo": "row", "wk": "kv", "wv": "kv"}.get(key, "last")
    if parent == "attn" and "wq_a" in siblings:  # MLA: the latent whole, the heads split
        return {"wo": "row", "wq_b": "last", "wkv_b": "last"}.get(key, "whole")
    if parent in MLP_PARENTS and key == "w2":
        return "row"
    if parent == "moe" and key == "router":
        return "whole"
    if parent == "rnn":
        return {"w_out": "row", "a_r": "channel", "a_i": "channel", "lambda": "channel"}.get(key, "last")
    if parent == "cell" and "w_up" in siblings:  # mLSTM
        return {"w_up": "whole", "w_down": "row", "a_i": "channel", "a_f": "channel"}.get(key, "last")
    if parent == "cell" and "r_i" in siblings:  # sLSTM
        return "row" if key == "w_out" else "quarters" if key == "b" else "heads" if key in SLSTM_RECURRENT else "last"
    return "last"


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """``PartitionSpec`` factory for one (config, mesh) pair
    (``repro/dist/sharding.py:177-248``).

    client_axes: mesh axes the leading stacked client dim is sharded over
    (empty for serving: params then carry no client axis). The rules give
    JAX's members on any mesh (a ``RankMesh`` or anything with
    ``axis_names`` and a ``shape`` dict); they degrade to replication
    where an axis is absent or a non-client dim does not divide, and raise
    for a client count that does not divide the client axes."""

    mesh: Any
    client_axes: Tuple[str, ...] = ()
    model_axis: str = "model"
    data_axis: str = "data"
    kv_heads: int = 0  # the config's KV heads (0: unknown, wk / wv split as JAX's)

    def _client_member(self, dim_size: int):
        axes = tuple(a for a in self.client_axes if a in self.mesh.axis_names)
        if not axes:
            return None
        total = 1
        for a in axes:
            total *= self.mesh.shape[a]
        if dim_size % total:
            # an indivisible client count is a topology mistake, not a hint:
            # replicating would hide an N-fold memory and compute blow-up
            raise ValueError(
                f"stacked client axis of size {dim_size} is not divisible by the "
                f"mesh's client axes {axes} ({total} ways); choose a client count "
                f"that divides the mesh (or drop the client axes from the "
                f"sharding rules) instead of silently replicating the state"
            )
        return axes if len(axes) > 1 else axes[0]

    def batch_spec(self, shape, *, has_accum: bool = False) -> PartitionSpec:
        """Training batch (accum?, N, micro/b, ...): client dim over the
        federated axes, everything else replicated."""
        members = [None] * len(shape)
        client_dim = 1 if has_accum else 0
        members[client_dim] = self._client_member(shape[client_dim])
        return P(*members)

    def request_spec(self, shape) -> PartitionSpec:
        """Serving request (B, ...): batch dim over "data" when it divides."""
        members = [None] * len(shape)
        if shape and self.data_axis in self.mesh.axis_names and shape[0] % self.mesh.shape[self.data_axis] == 0:
            members[0] = self.data_axis
        return P(*members)

    def _param_spec(self, shape, role: str = "last") -> PartitionSpec:
        """JAX's spec (client dim first, the last dim over "model" where it
        divides) for a leaf of ``role`` "last"; a "row" leaf splits dim -2
        instead, a "heads" leaf dim -3, a "channel" leaf its last dim even
        at rank 1, a "quarters" leaf each quarter of its last dim, a
        "whole" leaf stays whole, and a "kv" leaf over a model axis longer
        than its KV heads keeps one head a rank."""
        members = [None] * len(shape)
        if self.client_axes and shape:
            members[0] = self._client_member(shape[0])
        if role == "whole":
            return P(*members)
        m = int(self.mesh.shape[self.model_axis]) if self.model_axis in self.mesh.axis_names else 0
        if role in ("row", "heads", "channel"):
            dim = len(shape) - {"row": 2, "heads": 3, "channel": 1}[role]
            if m and dim >= 0 and members[dim] is None and shape[dim] % m == 0:
                members[dim] = self.model_axis
            return P(*members)
        if role == "quarters":
            if m and members[-1] is None and shape[-1] % (4 * m) == 0:
                members[-1] = BlockSplit(self.model_axis, 4)
            return P(*members)
        if role == "kv" and 0 < self.kv_heads < m:
            members[-1] = HeadShare(self.model_axis, self.kv_heads)
            return P(*members)
        tp = _last_dim_member(self.mesh, shape, self.model_axis)
        if tp is not None and (not members or members[-1] is None) and len(shape) >= 2:
            members[-1] = tp
        return P(*members)

    def params_shardings(self, params, *, scanned: bool = True):
        """A spec per parameter leaf: the stacked client dim first, then the
        tensor-parallel layout (``_role``): JAX's last-dim split except the
        row-parallel outputs, the whole norms, latents, router and
        ``w_up``, the KV heads and the recurrent cells' heads and channels."""
        del scanned  # specs are rank-generic; a scanned stack only adds a replicated dim

        def walk(t, parent=None, key=None, siblings=frozenset()):
            if isinstance(t, dict):
                keys = frozenset(t)
                return {k: walk(v, key, k, keys) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return type(t)(walk(v, parent, key, siblings) for v in t)
            return self._param_spec(tuple(t.shape), _role(key, parent, siblings))

        return walk(params)

    def model_replicas(self, params) -> Tuple[int, ...]:
        """For each params leaf (``tree.leaves`` order), how many ranks of
        the model axis hold the same values: 1 for a leaf split over it, M
        for a whole one, M / Hkv for a shared KV head."""
        from repro_torch.tree import leaves

        m = int(self.mesh.shape[self.model_axis]) if self.model_axis in self.mesh.axis_names else 1

        def count(spec):
            members = tuple(spec)
            if any(isinstance(x, HeadShare) for x in members):
                return m // self.kv_heads
            if any(isinstance(x, BlockSplit) for x in members):
                return 1
            named = [n for x in members if x is not None for n in (x if isinstance(x, tuple) else (x,))]
            return 1 if self.model_axis in named else m

        return tuple(count(spec) for spec in leaves(self.params_shardings(params)))

    def caches_shardings(self, caches, *, scanned: bool = True):
        """A spec per decode-cache leaf: the leading dim over "data" where it
        divides."""
        from repro_torch.tree import tree_map

        del scanned

        def spec(leaf):
            members = [None] * len(leaf.shape)
            if leaf.shape and self.data_axis in self.mesh.axis_names and (
                    leaf.shape[0] % self.mesh.shape[self.data_axis] == 0):
                members[0] = self.data_axis
            return P(*members)

        return tree_map(spec, caches)


def shard_tree(tree, specs, mesh, device: DeviceLike = None):
    """This rank's part of every leaf of ``tree`` by the matching spec of
    ``specs`` (None: the leaf whole), moved to ``device`` (default: the
    mesh's). A part is a copy, so the whole leaf is not kept alive behind
    it. Non-tensor leaves pass through."""
    from repro_torch.tree import tree_map

    dev = mesh.device if device is None else torch.device(device)

    def one(x, spec):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if not isinstance(x, torch.Tensor):
            return x
        if spec is None:
            return x.to(dev)
        part = spec.shard(x, mesh).to(dev)
        return part.clone() if part.untyped_storage().data_ptr() == x.untyped_storage().data_ptr() else part

    return tree_map(one, tree, specs)


def fed_rules(cfg, mesh) -> ShardingRules:
    """Federated training: stacked client axis over ("pod", "data"), the
    tensor-parallel layout over "model"."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return ShardingRules(mesh=mesh, client_axes=axes, kv_heads=0 if cfg is None else cfg.num_kv_heads)


def serve_rules(cfg, mesh) -> ShardingRules:
    """Serving: no client axis; requests over "data", the tensor-parallel
    layout over "model"."""
    return ShardingRules(mesh=mesh, client_axes=(), kv_heads=0 if cfg is None else cfg.num_kv_heads)


def rank_params(params, mesh, cfg):
    """This rank's part of an unstacked parameter tree (numpy or torch
    leaves), or of a subtree with its parent keys (``{"blocks": {"b0":
    block}}``): its tensor-parallel slices under ``serve_rules`` when the
    mesh's "model" axis is larger than 1, then, where the MoE exchanges
    over "data" (``ep_mode_for``), its experts' rows of those slices
    (``expert_rows``): tensor and expert parallelism compose on a (data,
    model) mesh. Numpy leaves are sliced without copies, but for the
    strided sLSTM bias."""
    if model_size(mesh) > 1:
        from repro_torch.tree import tree_map

        params = tree_map(lambda x, spec: spec.shard(x, mesh), params,
                          serve_rules(cfg, mesh).params_shardings(params))
    if cfg.moe is not None and ep_mode_for(mesh, cfg.moe.num_experts) == "ep_data":
        params = expert_rows(params, mesh)
    return params


def topology_for(cfg, mesh):
    """The federated tree this config trains on this mesh: the uniform
    two-level ``FedTopology``, or the ``FedPlan``'s ragged
    ``HierarchySpec`` when set."""
    num_pods = mesh.shape["pod"] if "pod" in mesh.axis_names else 1
    if cfg.fed.fanouts is not None:
        return cfg.fed.hierarchy(num_pods)
    from repro_torch.core.hierfavg import FedTopology

    return FedTopology(num_edges=num_pods * cfg.fed.edges_per_pod, clients_per_edge=cfg.fed.clients_per_edge)
