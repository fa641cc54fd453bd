"""Weighted model-aggregation operators (the paper's EdgeAggregation /
CloudAggregation, Algorithm 1 lines 25-31) over trees of stacked tensors
(``repro_torch.tree``: the MLP's flat dict, the LM's nested tree).

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

``psum_weighted_mean`` is the cloud mean of the client-sharded superround
(``repro/core/aggregation.py:245-298``): each rank's partial weighted sums,
plain PyTorch as JAX's per-shard ``jnp`` sums, packed into one vector and
summed over the client mesh by one ``dist.all_reduce``.

The robust statistics (``segment_trimmed_mean``,
``segment_coordinate_median``) and the per-level ``AggregatorSpec``
registry port ``repro/core/aggregation.py:333-572``. JAX computes them with
``jnp.sort`` outside any Pallas call, so they are ``torch.sort`` /
gathers here, on either device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.hier_aggregate import segment_table
from repro_torch.tree import Tree, leaves, tree_map, unflatten


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

    return tree_map(leaf, tree)


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

    return tree_map(leaf, tree)


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
    return tree_map(lambda x: ops.grouped_mean(x.reshape(n, -1), w, num_groups).reshape(x.shape), tree)


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
    contiguous blocks (K1) or ragged segments (K2). A cohort's stages
    (``cohort_stages``) may also carry K2's int32 ``segment_table`` (the
    offsets, and the work items of a segment too tall for one block) and
    the ids as a device tensor, uploaded ahead of the sync."""

    ids: np.ndarray
    num_segments: int
    uniform: bool
    offsets: Optional[torch.Tensor] = None
    device_ids: Optional[torch.Tensor] = None


def _stage(segment_ids, num_segments: int) -> Stage:
    ids = np.asarray(segment_ids, np.int64)
    return Stage(ids, int(num_segments), _static_uniform_groups(ids, num_segments) is not None)


def cohort_stages(segments: np.ndarray, cohort_size: int) -> Tuple[Stage, ...]:
    """The stages of a sampled cohort's staged mean, bottom-up, one per
    tree level: ``segments`` is the (depth-1, C) table of the members'
    ORIGINAL node ids below the root (``CohortEngine._segments_table``
    columned at the cohort's ids), and the top stage maps every member to
    the root. Each stage is compacted to the nodes the cohort holds (ids
    renumbered 0..G'-1 in order): a node with no member writes no row, so
    the means are those over the original ids, and K2 runs over at most C
    segments, not over every node of the level (1000 edges at n1m, where
    the cohort holds 4 or 5 clients of each), so its table and its grid
    stay as small as the cohort. Compacted ids that form equal blocks take
    K1, as the top stage (G' = 1) always does; ragged ones take K2.
    Host-side only: ``stages_to_device`` uploads the tables."""
    out = []
    for col in np.asarray(segments).reshape(-1, int(cohort_size)):
        present, compact = np.unique(np.asarray(col, np.int64), return_inverse=True)
        out.append(_stage(compact.reshape(-1), present.shape[0]))
    out.append(Stage(np.zeros(int(cohort_size), np.int64), 1, True))
    return tuple(out)


def stage_host_tables(st: Stage) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """(K2's ``segment_table`` or None for a K1 stage, the ids): what
    ``stages_to_device`` uploads."""
    return (None if st.uniform else segment_table(st.ids, st.num_segments)), st.ids


def stages_to_device(stages: Sequence[Stage], tables, device: torch.device, non_blocking: bool = False):
    """``stages`` with their host ``tables`` (``stage_host_tables``, as
    tensors, pinned for a non-blocking copy) on ``device``."""
    return tuple(
        st._replace(offsets=None if off is None else off.to(device, non_blocking=non_blocking),
                    device_ids=ids.to(device, non_blocking=non_blocking))
        for st, (off, ids) in zip(stages, tables)
    )


def level_stages(spec, level: Optional[int] = None) -> Tuple[Stage, ...]:
    """The stages of ``hierarchical_segment_mean`` at ``level`` (None: the
    cloud level) of a ``core.hierarchy.HierarchySpec``, bottom-up. The
    ids are static per spec, so a level sync builds these once."""
    lvl = spec.depth if level is None else level
    return tuple(_stage(spec.segments(t), spec.num_nodes(t)) for t in range(1, lvl + 1))


def _stage_mean(tree: Tree, w: torch.Tensor, st: Stage) -> Tree:
    """One stage over every leaf, with masked weights ``w``: K1 per leaf
    for equal blocks, K2 per leaf for ragged segments (on CUDA)."""
    # each leaf flattens to (N, D); the largest on any path, lm-100m's
    # stacked MLP weight (8 clients x 12 layers x 768 x 2048 = 151M
    # elements), stays far below the kernels' 2^31-element limit
    n = w.shape[0]
    if st.uniform:
        return tree_map(lambda x: ops.grouped_mean(x.reshape(n, -1), w, st.num_segments).reshape(x.shape), tree)
    return tree_map(
        lambda x: ops.segment_mean(x.reshape(n, -1), w, st.ids, st.num_segments, offsets=st.offsets).reshape(x.shape),
        tree,
    )


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


def hierarchical_mean(
    tree: Tree,
    weights: torch.Tensor,
    num_groups: int,
    mask: Optional[torch.Tensor] = None,
) -> Tree:
    """Cloud aggregation as edge-then-cloud composition
    (``repro/core/aggregation.py:300-315``): the per-edge means, then the
    weighted mean of those over every client, which weighs each edge mean by
    |D^l|. Equal to ``weighted_mean``; both stages are ``grouped_weighted_mean``
    (the second over one group), so on CUDA each leaf takes K1 twice, as the
    two-level cloud sync's stages do."""
    edge = grouped_weighted_mean(tree, weights, num_groups, mask)
    return grouped_weighted_mean(edge, weights, 1, mask)


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
    deltas = tree_map(lambda x, a: x - a.to(x.dtype), tree, anchor)
    mean_delta = weighted_mean(deltas, weights, mask)
    return tree_map(lambda a, d: (a.to(torch.float32) + d.to(torch.float32)).to(a.dtype), anchor, mean_delta)


def _psum_means(flat, w: torch.Tensor, mesh, anchors, counter: str):
    """The global weighted means of the rank's (C, ...) leaves ``flat``,
    each (*param) f32, and the () bool "the global denominator is
    positive", from ONE packed ``dist.all_reduce`` of the f32 partial sums
    (in ``leaves`` order, JAX's) and the weight total. ``anchors``: the
    means of ``x - anchor`` (the anchor is common to every row)."""
    from repro_torch.dist.sharding import all_reduce_sum

    partials = []
    for i, x in enumerate(flat):
        xf = x.to(torch.float32)
        if anchors is not None:
            xf = xf - anchors[i].to(torch.float32)
        partials.append(torch.sum(xf * _bcast(w, xf), dim=0).reshape(-1))
    total = all_reduce_sum(torch.cat(partials + [torch.sum(w).reshape(1)]), mesh, counter=counter)
    denom = total[-1]
    alive = denom > 0
    safe = torch.where(alive, denom, torch.ones_like(denom))
    means, offset = [], 0
    for x in flat:
        size = math.prod(x.shape[1:])
        means.append((total[offset:offset + size] / safe).reshape(x.shape[1:]))
        offset += size
    return means, alive


def psum_weighted_mean(
    tree: Tree,
    weights: torch.Tensor,
    mesh,  # dist.sharding.RankMesh
    mask: Optional[torch.Tensor] = None,
    *,
    anchor: Optional[Tree] = None,
    counter: str = "all_reduce",
) -> Tuple[Tree, torch.Tensor]:
    """Global weighted mean over a client axis sharded over ``mesh`` with
    exactly ONE collective: the port of JAX's ``psum_weighted_mean``
    (counted under ``counter``).

    Every leaf is this rank's (C, ...) rows and ``weights`` / ``mask`` the
    matching (C,) slices. Each leaf's partial weighted sum is taken in f32
    (in ``leaves`` order, JAX's), the partials and the masked weight total
    are packed into one vector and summed over the ranks by one
    ``dist.all_reduce`` (``dist.sharding.all_reduce_sum``, counted), and the
    unpacked means are broadcast back to every local row. With ``anchor``
    the mean is taken in delta form, anchor + mean(tree - anchor). No
    survivor anywhere keeps the current rows. Returns ``(tree', alive)``,
    ``alive`` the () bool "the global denominator is positive", which the
    transport's keep-dead logic reuses without a second collective."""
    flat = list(leaves(tree))
    anchors = list(leaves(anchor)) if anchor is not None else None
    means, alive = _psum_means(flat, _masked_weights(weights, mask), mesh, anchors, counter)
    out = []
    for i, (x, mean) in enumerate(zip(flat, means)):
        full = mean.expand(x.shape)
        if anchors is not None:
            full = anchors[i].to(torch.float32) + full
        out.append(torch.where(alive, full, x.to(torch.float32)).to(x.dtype))
    return unflatten(tree, out), alive


def psum_cloud_model(
    tree: Tree,
    weights: torch.Tensor,
    mesh,  # dist.sharding.RankMesh
    mask: Optional[torch.Tensor] = None,
) -> Tuple[Tree, torch.Tensor]:
    """``cloud_model`` over a client axis sharded over ``mesh``: the
    (*param) weighted means, in each leaf's dtype, from the same one packed
    all-reduce as ``psum_weighted_mean`` (counted apart, as
    ``eval_all_reduce``), without the broadcast back. Returns ``(means,
    alive)``; where no client anywhere survived the means are not
    defined and the caller scores its fallback."""
    flat = list(leaves(tree))
    means, alive = _psum_means(flat, _masked_weights(weights, mask), mesh, None, "eval_all_reduce")
    return unflatten(tree, [m.to(x.dtype) for x, m in zip(flat, means)]), alive


# ---------------------------------------------------------------------------
# Robust per-segment aggregators (the per-level AggregatorSpec axis)
# ---------------------------------------------------------------------------
#
# Coordinate-wise trimmed mean and median (Yin et al., ICML'18) over the
# surviving members of each segment: unweighted order statistics, so they
# use the survival mask but not the dataset-size weights. A group with zero
# survivors keeps its members' current parameters, as the weighted means do.


def _segment_members(segment_ids, num_segments: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static (G, Cmax) member-index matrix and validity mask for sorted
    host-side segment ids (``HierarchySpec.segments``)."""
    ids = np.asarray(segment_ids, np.int64)
    sizes = np.bincount(ids, minlength=num_segments)
    cmax = int(sizes.max())
    members = np.zeros((num_segments, cmax), np.int32)
    valid = np.zeros((num_segments, cmax), bool)
    for g in range(num_segments):
        ix = np.where(ids == g)[0]
        members[g, : ix.shape[0]] = ix
        valid[g, : ix.shape[0]] = True
    return members, valid


def _sorted_segment_values(x: torch.Tensor, members: np.ndarray, validb: np.ndarray,
                           mask: Optional[torch.Tensor]):
    """Gather one (N, ...) leaf into (G, Cmax, ...) f32, masked entries at
    +inf, sorted ascending along the member axis. Returns (sorted, m_g),
    m_g (G,) the surviving members per segment."""
    idx = torch.as_tensor(members, dtype=torch.long, device=x.device)
    vals = x.to(torch.float32)[idx]  # (G, Cmax, ...)
    alive = torch.as_tensor(validb, device=x.device)
    if mask is not None:
        alive = alive & (mask.to(torch.float32)[idx] > 0)
    m_g = torch.sum(alive, dim=1).to(torch.int32)
    alive_b = alive.reshape(alive.shape + (1,) * (vals.dim() - 2))
    vals = torch.where(alive_b, vals, torch.full((), float("inf"), device=x.device))
    return torch.sort(vals, dim=1).values, m_g


def _broadcast_back(per_segment: torch.Tensor, x: torch.Tensor, seg: torch.Tensor, m_g: torch.Tensor) -> torch.Tensor:
    """(G, ...) statistic -> (N, ...); zero-survivor groups keep ``x``."""
    back = per_segment[seg]
    keep = (m_g > 0)[seg].reshape((-1,) + (1,) * (back.dim() - 1))
    return torch.where(keep, back, x.to(torch.float32)).to(x.dtype)


def segment_trimmed_mean(tree: Tree, segment_ids, num_segments: int, mask: Optional[torch.Tensor] = None, *,
                         trim: float = 0.1) -> Tree:
    """Coordinate-wise ``trim``-trimmed mean per segment, broadcast back.

    Per segment with m surviving members, each coordinate drops its
    ``floor(trim * m)`` smallest and largest member values and averages the
    rest (unweighted; where floor(trim * m) is 0 this is the plain member
    mean). ``trim`` must be in [0, 0.5).
    """
    if not 0.0 <= trim < 0.5:
        raise ValueError(f"trim must be in [0, 0.5), got {trim}")
    members, validb = _segment_members(segment_ids, num_segments)

    def leaf(x):
        seg = torch.as_tensor(np.asarray(segment_ids), dtype=torch.long, device=x.device)
        svals, m_g = _sorted_segment_values(x, members, validb, mask)
        k_g = torch.floor(trim * m_g.to(torch.float32)).to(torch.int32)
        ranks = torch.arange(svals.shape[1], dtype=torch.int32, device=x.device)
        keep = (ranks[None, :] >= k_g[:, None]) & (ranks[None, :] < (m_g - k_g)[:, None])
        count = torch.clamp(m_g - 2 * k_g, min=1).to(torch.float32)
        keep_b = keep.reshape(keep.shape + (1,) * (svals.dim() - 2))
        sums = torch.sum(torch.where(keep_b, svals, torch.zeros((), device=x.device)), dim=1)
        mean = sums / count.reshape((-1,) + (1,) * (sums.dim() - 1))
        return _broadcast_back(mean, x, seg, m_g)

    return tree_map(leaf, tree)


def segment_coordinate_median(tree: Tree, segment_ids, num_segments: int,
                              mask: Optional[torch.Tensor] = None) -> Tree:
    """Coordinate-wise median per segment over surviving members, broadcast
    back (the midpoint of the two central order statistics for even m)."""
    members, validb = _segment_members(segment_ids, num_segments)

    def leaf(x):
        seg = torch.as_tensor(np.asarray(segment_ids), dtype=torch.long, device=x.device)
        svals, m_g = _sorted_segment_values(x, members, validb, mask)
        # central order statistics: odd m -> both (m-1)//2; even m -> m//2-1, m//2
        lo = torch.clamp((m_g - 1).div(2, rounding_mode="floor"), min=0).long()
        hi = m_g.div(2, rounding_mode="floor").long()
        rows = torch.arange(svals.shape[0], device=x.device)
        med = 0.5 * (svals[rows, lo] + svals[rows, hi])
        return _broadcast_back(med, x, seg, m_g)

    return tree_map(leaf, tree)


# -- aggregator registry ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WeightedMeanAggregator:
    """The paper's |D_i|-weighted mean (staged ``hierarchical_segment_mean``),
    the default at every level; ``build_level_sync`` takes its own path for
    it, so an all-default spec keeps the unchanged numbers."""

    @property
    def name(self) -> str:
        return "weighted_mean"

    @property
    def is_default(self) -> bool:
        return True

    def __call__(self, tree, weights, spec, level, mask=None):
        return hierarchical_segment_mean(tree, weights, spec, level, mask)


@dataclasses.dataclass(frozen=True)
class TrimmedMeanAggregator:
    """Coordinate-wise trimmed mean over each level-l segment's survivors."""

    trim: float = 0.1

    def __post_init__(self):
        if not 0.0 <= self.trim < 0.5:
            raise ValueError(f"trim must be in [0, 0.5), got {self.trim}")

    @property
    def name(self) -> str:
        return f"trimmed_mean:{self.trim:g}"

    @property
    def is_default(self) -> bool:
        return False

    def __call__(self, tree, weights, spec, level, mask=None):
        return self.segment_call(tree, spec.segments(level), spec.num_nodes(level), mask)

    def segment_call(self, tree, segment_ids, num_segments, mask=None):
        return segment_trimmed_mean(tree, segment_ids, num_segments, mask, trim=self.trim)


@dataclasses.dataclass(frozen=True)
class CoordinateMedianAggregator:
    """Coordinate-wise median over each level-l segment's survivors."""

    @property
    def name(self) -> str:
        return "coordinate_median"

    @property
    def is_default(self) -> bool:
        return False

    def __call__(self, tree, weights, spec, level, mask=None):
        return self.segment_call(tree, spec.segments(level), spec.num_nodes(level), mask)

    def segment_call(self, tree, segment_ids, num_segments, mask=None):
        return segment_coordinate_median(tree, segment_ids, num_segments, mask)


_AGGREGATOR_FACTORIES = {
    "weighted_mean": lambda arg: WeightedMeanAggregator(),
    "mean": lambda arg: WeightedMeanAggregator(),
    "trimmed_mean": lambda arg: TrimmedMeanAggregator(trim=float(arg) if arg else 0.1),
    "coordinate_median": lambda arg: CoordinateMedianAggregator(),
    "median": lambda arg: CoordinateMedianAggregator(),
}


def parse_aggregator(text: str):
    """'weighted_mean' | 'trimmed_mean[:trim]' | 'coordinate_median', e.g.
    'trimmed_mean:0.2'."""
    name, _, arg = text.strip().partition(":")
    if name not in _AGGREGATOR_FACTORIES:
        raise ValueError(f"unknown aggregator {name!r}; choose from {sorted(_AGGREGATOR_FACTORIES)}")
    return _AGGREGATOR_FACTORIES[name](arg)


@dataclasses.dataclass(frozen=True)
class AggregatorSpec:
    """One aggregator per tree level, bottom-up: ``aggregators[0]`` at the
    client->edge sync (level 1), ``aggregators[-1]`` at the cloud sync,
    aligned with ``HierFAVGConfig.kappa_vector``."""

    aggregators: Tuple[Any, ...]

    def __post_init__(self):
        object.__setattr__(self, "aggregators", tuple(self.aggregators))
        if not self.aggregators:
            raise ValueError("AggregatorSpec needs at least one level")

    @classmethod
    def default(cls, depth: int) -> "AggregatorSpec":
        return cls(aggregators=tuple(WeightedMeanAggregator() for _ in range(depth)))

    @classmethod
    def uniform(cls, aggregator, depth: int) -> "AggregatorSpec":
        return cls(aggregators=tuple(aggregator for _ in range(depth)))

    @classmethod
    def parse(cls, text: str) -> "AggregatorSpec":
        """'/'-separated aggregator per level, bottom-up:
        'trimmed_mean:0.1/weighted_mean' trims at the edge sync and keeps
        the paper's weighted mean at the cloud."""
        parts = [p for p in text.split("/") if p]
        if not parts:
            raise ValueError(f"empty aggregator spec: {text!r}")
        return cls(aggregators=tuple(parse_aggregator(p) for p in parts))

    @property
    def depth(self) -> int:
        return len(self.aggregators)

    def aggregator(self, level: int):
        if not 1 <= level <= self.depth:
            raise ValueError(f"level must be in 1..{self.depth}, got {level}")
        return self.aggregators[level - 1]

    @property
    def is_trivial(self) -> bool:
        """True iff every level is the default weighted mean."""
        return all(a.is_default for a in self.aggregators)

    def describe(self) -> str:
        return "/".join(a.name for a in self.aggregators)
