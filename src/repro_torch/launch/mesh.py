"""Production and host meshes over ``torch.distributed`` ranks: the port of
``repro.launch.mesh``.

JAX lays its meshes over devices: single-pod (16, 16) ("data", "model") =
256 chips, multi-pod (2, 16, 16) ("pod", "data", "model") = 512, the "pod"
axis the cross-DCN dimension HierFAVG's cloud hop amortizes. Here a mesh
lies over the ranks of the initialised process group, one process a
rank (``dist.sharding.RankMesh``), so the world must have exactly as many
ranks as the mesh has places (the dry run's world is ``torch.testing``'s
"fake" one, presented as NCCL: ``launch.dryrun``). Functions, not module
constants: importing touches no process group.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch.distributed as dist

from repro_torch.device import DeviceLike
from repro_torch.dist.sharding import RankMesh, rank_mesh


def _world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None) -> RankMesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = _world_size()
    if have != n:
        raise ValueError(f"need {n} devices for mesh {shape}, got {have}")
    return rank_mesh(shape, axes, device=device)


def make_host_mesh(shape: Sequence[int], axes: Sequence[str], *, device: DeviceLike = None,
                   present_as: Optional[str] = None) -> RankMesh:
    """A small mesh over the world's ranks (tests, probes, one card's gloo
    ranks). A "fake" world presents itself as ``present_as`` (default
    NCCL; ``rank_mesh``)."""
    n = math.prod(int(s) for s in shape)
    have = _world_size()
    if have != n:
        raise ValueError(f"need {n} devices, have {have}")
    return rank_mesh(shape, axes, device=device, present_as=present_as)
