"""The client mesh: the client-sharded half of ``repro.dist.sharding``
(``repro/dist/sharding.py:256-303``) over ``torch.distributed``.

JAX runs one program over a ``Mesh`` of devices and shards the stacked
client axis with ``shard_map``. The port runs one process per shard: a
``ClientMesh`` over K ranks of an initialised process group stands where
JAX has its 1-D ``Mesh``, each rank holds the rows of the clients placed on
it (``core.hierarchy.ShardPlacement``), and the one ``lax.psum`` per cloud
interval becomes one ``dist.all_reduce`` (``all_reduce_sum``). NCCL with one
rank per GPU is how PyTorch reaches several cards; gloo runs the same code
on the CPU, and for several ranks that share one card (PyTorch's gloo takes
CUDA tensors for ``all_reduce`` and ``broadcast`` only, so the row gathers
below go through host tensors under gloo).

The slice helpers (``batch_block_sharding``, ``mask_stack_sharding``,
``fed_state_shardings``) stand where JAX has ``NamedSharding``s: each is a
``RowSharding`` that takes this rank's rows of a placement-ordered
(kappa2, kappa1, padded_N, ...) block, (kappa2, padded_N) mask stack or
(padded_N, ...) state leaf and puts them on the rank's device; given the
rank's ``index``, of the canonical (N-row) ones, which is how the engines
shard what the host pipeline and the caller hand them.

Every collective the sharded path makes goes through one of the counted
wrappers here (``COUNTS``), so tests and ``chip_smoke.py`` can hold the
path to one all-reduce per cloud interval. The model-parallel half of the
JAX module (the hint mesh, ``ShardingRules``, MoE's expert-parallel
exchange) is not ported yet: ``set_hint_mesh`` and
``moe_dispatch_exchange`` refuse by name (ROADMAP.md Queue 1 item 12,
second half), and ``moe_ep_mode`` is "none", as JAX's is without a hint
mesh, so the MoE dispatch stays on one device.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike
from repro_torch.errors import unported

LAUNCH_RECIPE = (
    "start one process per rank and initialise torch.distributed first: "
    "repro_torch.dist.launch.spawn(fn, world_size=K, backend='gloo'|'nccl'), or "
    "torchrun --nproc-per-node K with dist.init_process_group in the script"
)

# collectives made through the counted wrappers below, since the last reset:
# "all_reduce" the cloud syncs' (one per cloud interval), "eval_all_reduce"
# the evals' cloud model (``aggregation.psum_cloud_model``)
COUNTS: Dict[str, int] = {"all_reduce": 0, "eval_all_reduce": 0, "gather": 0, "broadcast": 0}


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


@dataclasses.dataclass(frozen=True, eq=False)
class ClientMesh:
    """K ranks along one client axis: this process's ``rank`` of ``size``,
    its process ``group`` (None: the default group), the ``device`` its
    client rows live on and the group's ``backend``."""

    axis: str
    size: int
    rank: int
    group: Any
    device: torch.device
    backend: str

    @property
    def axis_names(self):
        return (self.axis,)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: self.size}

    def rows(self, capacity: int) -> slice:
        """This rank's positions of a placement-ordered client axis."""
        return slice(self.rank * capacity, (self.rank + 1) * capacity)


def set_hint_mesh(mesh) -> None:
    """Install the mesh that model sharding hints constrain to: not ported
    (None, the off-mesh default, is accepted)."""
    if mesh is not None:
        raise unported("model-parallel sharding hints (set_hint_mesh)", 12)


def moe_ep_mode(num_experts: int) -> str:
    """MoE's expert-parallel exchange mode: "none" (the dispatch stays on one
    device), what JAX returns without a hint mesh."""
    return "none"


def moe_dispatch_exchange(buf_g, mode: str):
    """MoE's expert-parallel all-to-all: not ported."""
    raise unported(f"MoE's expert-parallel exchange (moe_dispatch_exchange, mode {mode!r})", 12)


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


def client_mesh(num_devices: int = 0, axis: str = "clients", *, device: DeviceLike = None) -> ClientMesh:
    """A ``ClientMesh`` over the first ``num_devices`` ranks of the
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
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the NCCL backend needs CUDA devices, got {dev}; use backend='gloo' on the CPU")
        local = int(os.environ.get("LOCAL_WORLD_SIZE", k))
        if local > torch.cuda.device_count():
            raise ValueError(
                f"NCCL refuses two ranks on one GPU: {local} ranks on this node share "
                f"{torch.cuda.device_count()} device(s); use backend='gloo' for ranks that share a card"
            )
    return ClientMesh(axis=axis, size=k, rank=rank, group=group, device=dev, backend=backend)


# ---------------------------------------------------------------------------
# Counted collectives
# ---------------------------------------------------------------------------


def all_reduce_sum(vec: torch.Tensor, mesh: ClientMesh, counter: str = "all_reduce") -> torch.Tensor:
    """Sum ``vec`` over the mesh's ranks in place (one ``dist.all_reduce``,
    counted under ``counter``) and return it: the port's ``lax.psum``."""
    COUNTS[counter] += 1
    dist.all_reduce(vec, op=dist.ReduceOp.SUM, group=mesh.group)
    return vec


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def gather_rows(x: torch.Tensor, mesh: ClientMesh) -> torch.Tensor:
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


def broadcast_object(obj: Any, src: int, mesh: ClientMesh) -> Any:
    """``obj`` from rank ``src`` (pickled), on every rank."""
    COUNTS["broadcast"] += 1
    box = [obj if mesh.rank == src else None]
    dist.broadcast_object_list(box, src=src, group=mesh.group,
                               device=mesh.device if mesh.backend == "nccl" else None)
    return box[0]


def barrier(mesh: ClientMesh) -> None:
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
    the rank takes its block of ``capacity`` positions (``ClientMesh.rows``).
    With ``index`` (this rank's canonical rows in placement order:
    ``ShardPlacement.gather_index()`` at its positions, phantoms reading row
    0) the axis is canonical (N rows) and the rank takes those rows, the
    permute and the slice in one. ``take`` slices where the array lies
    (numpy or torch); a call also moves the part to the mesh's device.
    Applied to a non-tensor (the generator) a call passes it through."""

    mesh: ClientMesh
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


def batch_block_sharding(mesh: ClientMesh, axis: str = "clients", *, index=None) -> RowSharding:
    """Superround batch blocks (kappa2, kappa1, N, b, ...): this rank's
    clients of dim 2."""
    return RowSharding(mesh, 2, index)


def mask_stack_sharding(mesh: ClientMesh, axis: str = "clients", *, index=None) -> RowSharding:
    """Survival mask stacks (kappa2, N): this rank's columns."""
    return RowSharding(mesh, 1, index)


def fed_state_shardings(mesh: ClientMesh, axis: str, state, stacked_dim: int, *, index=None):
    """A ``FedState`` of ``RowSharding``s for a stacked state whose leaves
    carry the leading ``stacked_dim`` client axis: those take this rank's
    rows, everything else (step, rng, scalar optimizer leaves) is
    replicated. ``checkpoint.reshard.to_mesh`` applies it."""
    from repro_torch.core.hierfavg import fed_state_partition_specs

    specs = fed_state_partition_specs(state, axis, stacked_dim)
    return type(specs)(*(_spec_tree(mesh, f, index) for f in specs))


def _spec_tree(mesh: ClientMesh, tree, index):
    """Specs (the axis name: rows; "": replicated; None: an absent field)
    to ``RowSharding``s."""
    from repro_torch.tree import tree_map

    return tree_map(lambda s: None if s is None else RowSharding(mesh, 0 if s else None, index if s else None),
                    tree)
