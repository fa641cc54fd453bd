"""Weighted model-aggregation operators (the paper's EdgeAggregation /
CloudAggregation, Algorithm 1 lines 25-31) over dicts of stacked tensors.

Port of the weighted-mean part of ``repro.core.aggregation``. Every leaf
carries a leading client axis of size N, with the clients of one group
contiguous. ``grouped_weighted_mean`` reduces equal contiguous blocks;
``segment_weighted_mean`` reduces groups given by sorted segment ids and
dispatches to the grouped operator when the ids form equal blocks. Every
operator takes an optional (N,) survival mask and renormalizes over the
survivors; a group with no survivors keeps its members' parameters.

Where the work runs. The JAX package computes these operators in plain
``jnp`` (``repro/core/aggregation.py:98-179``); its Pallas kernels
``grouped_mean_pallas`` / ``segment_mean_pallas`` compute exactly the same
function on one leaf reshaped to (N, D) with the mask folded into the
weights, and exist to be "the paper's aggregation operator"
(``repro/kernels/hier_aggregate.py:1-8``), but nothing on the JAX main
path calls them. The port lowers the operator to those kernels: on a CUDA
tensor every grouped / segment mean launches K1 / K2
(``kernels.hier_aggregate``) once per leaf, and on a CPU tensor it runs
their plain PyTorch versions. That is a lowering of the same operator, not
a new feature; the tests hold both against the JAX operator.
``cloud_model`` (the eval reduction) stays plain PyTorch, as in JAX.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops

Tree = Dict[str, torch.Tensor]


def _masked_weights(weights: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    w = weights.to(torch.float32)
    if mask is not None:
        w = w * mask.to(torch.float32)
    return w


def _bcast(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Reshape (N,) weights to broadcast against a (N, *param) leaf."""
    return w.reshape(w.shape + (1,) * (x.dim() - w.dim()))


def weighted_mean(tree: Tree, weights: torch.Tensor, mask: Optional[torch.Tensor] = None) -> Tree:
    """Weighted mean over the full client axis, broadcast back; no
    survivors anywhere keeps the current parameters."""
    w = _masked_weights(weights, mask)
    denom = torch.sum(w)
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))

    def leaf(x):
        num = torch.sum(x.to(torch.float32) * _bcast(w, x), dim=0, keepdim=True)
        mean = (num / safe).expand(x.shape)
        return torch.where(denom > 0, mean, x.to(torch.float32)).to(x.dtype)

    return {k: leaf(x) for k, x in tree.items()}


def cloud_model(tree: Tree, weights: torch.Tensor, mask: Optional[torch.Tensor] = None) -> Tree:
    """The single cloud model (the eval path): the weighted mean over the
    client axis without broadcasting back, leaves shaped (*param). No
    survivors keeps client 0's parameters."""
    w = _masked_weights(weights, mask)
    denom = torch.sum(w)
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))

    def leaf(x):
        mean = torch.sum(x.to(torch.float32) * _bcast(w, x), dim=0) / safe
        return torch.where(denom > 0, mean, x[0].to(torch.float32)).to(x.dtype)

    return {k: leaf(x) for k, x in tree.items()}


def grouped_weighted_mean(
    tree: Tree,
    weights: torch.Tensor,
    num_groups: int,
    mask: Optional[torch.Tensor] = None,
) -> Tree:
    """Per-group weighted mean over ``num_groups`` equal contiguous client
    blocks, broadcast back (K1 on CUDA: one launch per leaf)."""
    n = weights.shape[0]
    if n % num_groups:
        raise ValueError(f"N={n} not divisible by num_groups={num_groups}")
    w = _masked_weights(weights, mask)
    return {k: ops.grouped_mean(x.reshape(n, -1), w, num_groups).reshape(x.shape) for k, x in tree.items()}


def _static_uniform_groups(segment_ids, num_segments: int) -> Optional[int]:
    """The block count if the host-side segment ids form equal contiguous
    blocks (the uniform path), else None."""
    ids = np.asarray(segment_ids)
    n = ids.shape[0]
    if num_segments <= 0 or n % num_segments:
        return None
    uniform = np.repeat(np.arange(num_segments, dtype=ids.dtype), n // num_segments)
    return num_segments if np.array_equal(ids, uniform) else None


class Stage(NamedTuple):
    """One segment mean of a staged aggregation, decided on the host once:
    sorted (N,) int64 segment ids, their count, and whether they form equal
    contiguous blocks (K1) or ragged segments (K2)."""

    ids: np.ndarray
    num_segments: int
    uniform: bool


def _stage(segment_ids, num_segments: int) -> Stage:
    ids = np.asarray(segment_ids, np.int64)
    return Stage(ids, int(num_segments), _static_uniform_groups(ids, num_segments) is not None)


def level_stages(spec, level: Optional[int] = None) -> Tuple[Stage, ...]:
    """The stages of ``hierarchical_segment_mean`` at ``level`` (None: the
    cloud level) of a ``core.hierarchy.HierarchySpec``, bottom-up. The
    ids are static per spec, so a level sync builds these once."""
    lvl = spec.depth if level is None else level
    return tuple(_stage(spec.segments(t), spec.num_nodes(t)) for t in range(1, lvl + 1))


def _stage_mean(tree: Tree, w: torch.Tensor, st: Stage) -> Tree:
    """One stage over every leaf, with masked weights ``w``: K1 per leaf
    for equal blocks, K2 per leaf for ragged segments (on CUDA)."""
    n = w.shape[0]
    if st.uniform:
        return {k: ops.grouped_mean(x.reshape(n, -1), w, st.num_segments).reshape(x.shape) for k, x in tree.items()}
    return {
        k: ops.segment_mean(x.reshape(n, -1), w, st.ids, st.num_segments).reshape(x.shape)
        for k, x in tree.items()
    }


def segment_weighted_mean(
    tree: Tree,
    weights: torch.Tensor,
    segment_ids,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> Tree:
    """Per-segment weighted mean, broadcast back to the members.

    ``segment_ids``: host-side (N,) sorted ints in [0, num_segments) (a
    level of ``HierarchySpec.segments``). Equal contiguous blocks take the
    grouped operator (K1); ragged ones ``ops.segment_mean`` (K2 on CUDA).
    """
    return _stage_mean(tree, _masked_weights(weights, mask), _stage(segment_ids, num_segments))


def segment_weights(
    weights: torch.Tensor,
    segment_ids,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """|D^g| per segment: sum of member dataset sizes (masked)."""
    w = _masked_weights(weights, mask)
    seg = torch.as_tensor(np.asarray(segment_ids), dtype=torch.long).to(w.device)
    return torch.zeros(num_segments, dtype=torch.float32, device=w.device).index_add_(0, seg, w)


def hierarchical_segment_mean(
    tree: Tree,
    weights: torch.Tensor,
    spec,  # core.hierarchy.HierarchySpec
    level: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,
) -> Tree:
    """Level-``level`` aggregation as the staged bottom-up composition (edge
    means, then region means of edge means, ...). Staged, as the JAX
    package computes it, so the numbers match; the cloud sync of a
    two-level tree is therefore two grouped means per leaf. ``level=None``
    means the top (cloud) level."""
    return staged_mean(tree, weights, level_stages(spec, level), mask)


def staged_mean(
    tree: Tree,
    weights: torch.Tensor,
    stages: Sequence[Stage],
    mask: Optional[torch.Tensor] = None,
) -> Tree:
    """``hierarchical_segment_mean`` over stages built beforehand by
    ``level_stages``."""
    w = _masked_weights(weights, mask)
    out = tree
    for st in stages:
        out = _stage_mean(out, w, st)
    return out


def group_weights(weights: torch.Tensor, num_groups: int, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """|D^l| per edge: sum of member dataset sizes (masked)."""
    return _masked_weights(weights, mask).reshape(num_groups, -1).sum(dim=1)


def delta_weighted_mean(
    tree: Tree, anchor: Tree, weights: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> Tree:
    """Cloud aggregation in delta form: anchor + mean(tree - anchor), over
    the full client axis. Equal to ``weighted_mean`` when every client
    survives (the anchor is the last broadcast, common to all clients); the
    deltas are what a compressed uplink carries. Plain PyTorch, as
    ``weighted_mean``."""
    deltas = {k: x - anchor[k].to(x.dtype) for k, x in tree.items()}
    mean_delta = weighted_mean(deltas, weights, mask)
    return {
        k: (a.to(torch.float32) + mean_delta[k].to(torch.float32)).to(a.dtype) for k, a in anchor.items()
    }
