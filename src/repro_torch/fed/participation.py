"""Sampled participation: who trains this cloud interval.

A numpy copy of ``repro.fed.participation`` (the port imports nothing of
the JAX package): the spec's ``participation`` section,
:class:`ParticipationSpec`, and the three cohort samplers it builds —

- ``uniform``      — i.i.d. without replacement over the whole population,
- ``round_robin``  — a rotating contiguous window, so every client is
  guaranteed to participate within ceil(N/C) cloud intervals,
- ``stratified``   — per-edge quotas proportional to edge population (each
  alive edge gets at least one seat), so no edge mean ever collapses to its
  stale broadcast value.

Samplers return **sorted** original client ids, so a cohort's per-level
segment ids stay non-decreasing (children of a node contiguous), which is
what the segment means and the K1/K2 kernels assume. The random streams are
the JAX package's, ``np.random.default_rng((seed, 0x5EED))``, so the two
packages draw the same cohorts id for id.

Every sampler is a small host-side state machine with ``state_dict`` /
``load_state_dict`` whose contents survive a JSON round trip: checkpoints
carry them in their metadata, so a resumed run replays the same cohort
sequence.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

__all__ = [
    "ParticipationSpec",
    "CohortSampler",
    "UniformSampler",
    "RoundRobinSampler",
    "StratifiedSampler",
    "stratified_quotas",
    "stratified_slot_edges",
    "build_sampler",
]

SAMPLERS = ("uniform", "round_robin", "stratified")


@dataclasses.dataclass(frozen=True)
class ParticipationSpec:
    """Which clients are device-resident per cloud interval.

    cohort_size=0 (the default) disables sampling: every engine keeps its
    full-population behaviour and this section is inert. A positive cohort
    size routes execution through the cohort engine, which materializes only
    the sampled rows on device.
    """

    cohort_size: int = 0
    sampler: str = "uniform"
    seed: int = 0

    def __post_init__(self):
        if self.cohort_size < 0:
            raise ValueError(f"cohort_size must be >= 0, got {self.cohort_size}")
        if self.sampler not in SAMPLERS:
            raise ValueError(f"sampler must be one of {SAMPLERS}, got {self.sampler!r}")

    @property
    def is_active(self) -> bool:
        return self.cohort_size > 0

    def build_sampler(self, hierarchy) -> "CohortSampler":
        return build_sampler(self, hierarchy)


class CohortSampler:
    """Base: successive ``sample()`` calls yield one cohort per cloud interval."""

    kind = "base"

    def __init__(self, num_clients: int, cohort_size: int):
        num_clients = int(num_clients)
        cohort_size = int(cohort_size)
        if not 1 <= cohort_size <= num_clients:
            raise ValueError(
                f"cohort_size must be in 1..{num_clients} (population), got {cohort_size}"
            )
        self.num_clients = num_clients
        self.cohort_size = cohort_size

    def sample(self) -> np.ndarray:  # pragma: no cover - abstract
        raise NotImplementedError

    def state_dict(self) -> Dict[str, Any]:  # pragma: no cover - abstract
        raise NotImplementedError

    def load_state_dict(self, state: Dict[str, Any]) -> None:  # pragma: no cover
        raise NotImplementedError


class UniformSampler(CohortSampler):
    """I.i.d. cohort without replacement; seed-deterministic and resume-exact."""

    kind = "uniform"

    def __init__(self, num_clients: int, cohort_size: int, seed: int = 0):
        super().__init__(num_clients, cohort_size)
        self._rng = np.random.default_rng((int(seed), 0x5EED))

    def sample(self) -> np.ndarray:
        ids = self._rng.choice(self.num_clients, size=self.cohort_size, replace=False)
        return np.sort(ids).astype(np.int64)

    def state_dict(self) -> Dict[str, Any]:
        # bit_generator.state is a nested dict of strs/ints — JSON-safe
        # (python ints are arbitrary precision, so the 128-bit PCG64 state
        # survives the checkpoint metadata round-trip losslessly).
        return {"kind": self.kind, "rng": self._rng.bit_generator.state}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if state.get("kind") != self.kind:
            raise ValueError(f"sampler kind mismatch: {state.get('kind')!r} != {self.kind!r}")
        self._rng.bit_generator.state = state["rng"]


class RoundRobinSampler(CohortSampler):
    """Rotating window: covers every client within ⌈N/C⌉ consecutive cohorts."""

    kind = "round_robin"

    def __init__(self, num_clients: int, cohort_size: int, seed: int = 0):
        super().__init__(num_clients, cohort_size)
        del seed  # deterministic rotation; accepted for interface symmetry
        self._cursor = 0

    def sample(self) -> np.ndarray:
        ids = (self._cursor + np.arange(self.cohort_size, dtype=np.int64)) % self.num_clients
        self._cursor = int((self._cursor + self.cohort_size) % self.num_clients)
        return np.sort(ids)

    def state_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "cursor": self._cursor}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if state.get("kind") != self.kind:
            raise ValueError(f"sampler kind mismatch: {state.get('kind')!r} != {self.kind!r}")
        self._cursor = int(state["cursor"])


def stratified_quotas(edge_sizes: np.ndarray, cohort_size: int) -> np.ndarray:
    """Per-edge seat counts: proportional to edge population, each edge >= 1.

    Largest-remainder apportionment with a floor of one seat per edge and a
    cap of the edge's population. Deterministic; quotas sum to cohort_size.
    """
    sizes = np.asarray(edge_sizes, np.int64)
    num_edges = sizes.shape[0]
    if np.any(sizes < 1):
        raise ValueError("every edge must have at least one client")
    if cohort_size < num_edges:
        raise ValueError(
            f"stratified sampling needs cohort_size >= num_edges "
            f"({cohort_size} < {num_edges}) so no edge is left cohort-empty"
        )
    if cohort_size > sizes.sum():
        raise ValueError(f"cohort_size {cohort_size} exceeds population {int(sizes.sum())}")
    quota = np.ones(num_edges, np.int64)  # the >=1 floor
    while True:
        remaining = int(cohort_size - quota.sum())
        if remaining == 0:
            return quota
        room = sizes - quota
        open_ix = np.flatnonzero(room > 0)
        share = sizes[open_ix].astype(np.float64)
        ideal = remaining * share / share.sum()
        add = np.minimum(np.floor(ideal).astype(np.int64), room[open_ix])
        if add.sum() == 0:
            # all floors rounded to zero: hand out single seats by largest
            # fractional remainder (stable order breaks exact ties by edge id)
            order = open_ix[np.argsort(-(ideal - np.floor(ideal)), kind="stable")]
            quota[order[:remaining]] += 1
        else:
            quota[open_ix] += add


def stratified_slot_edges(edge_sizes: np.ndarray, cohort_size: int) -> np.ndarray:
    """(cohort_size,) edge id owning each cohort *slot* under stratified
    sampling.

    Because edges are contiguous sorted id ranges and the per-edge quotas
    are fixed, every sorted stratified cohort fills the same slot→edge
    layout: slot j belongs to the edge whose quota block covers j. This is
    the placement-stability contract the sharded cohort lowering builds on —
    the slot layout (and hence the shard placement planned from it) is a
    pure function of (topology, cohort_size), independent of which clients
    the sampler draws each interval.
    """
    quotas = stratified_quotas(edge_sizes, cohort_size)
    return np.repeat(np.arange(quotas.shape[0], dtype=np.int64), quotas)


class StratifiedSampler(CohortSampler):
    """Per-edge proportional quotas; never leaves an alive edge cohort-empty."""

    kind = "stratified"

    def __init__(self, num_clients: int, cohort_size: int, edge_segments: np.ndarray, seed: int = 0):
        super().__init__(num_clients, cohort_size)
        seg = np.asarray(edge_segments, np.int64)
        if seg.shape != (self.num_clients,):
            raise ValueError(f"edge_segments must be ({self.num_clients},), got {seg.shape}")
        sizes = np.bincount(seg)
        self.quotas = stratified_quotas(sizes, self.cohort_size)
        # segments are sorted (children contiguous), so each edge's members
        # are a contiguous id range [offset_e, offset_e + size_e)
        self._offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self._rng = np.random.default_rng((int(seed), 0x5EED))

    def sample(self) -> np.ndarray:
        parts = []
        for e, q in enumerate(self.quotas):
            lo, hi = self._offsets[e], self._offsets[e + 1]
            parts.append(lo + self._rng.choice(hi - lo, size=int(q), replace=False))
        return np.sort(np.concatenate(parts)).astype(np.int64)

    def state_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "rng": self._rng.bit_generator.state}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if state.get("kind") != self.kind:
            raise ValueError(f"sampler kind mismatch: {state.get('kind')!r} != {self.kind!r}")
        self._rng.bit_generator.state = state["rng"]


def build_sampler(spec: ParticipationSpec, hierarchy) -> CohortSampler:
    """Build the sampler a spec describes against a concrete hierarchy.

    ``hierarchy`` is a ``core.hierarchy.HierarchySpec`` (duck-typed here to
    keep this module free of torch and of ``core``): needs ``num_clients`` and, for
    stratified sampling, ``segments(1)``.
    """
    if not spec.is_active:
        raise ValueError("participation is inactive (cohort_size=0); nothing to build")
    n = int(hierarchy.num_clients)
    if spec.sampler == "uniform":
        return UniformSampler(n, spec.cohort_size, spec.seed)
    if spec.sampler == "round_robin":
        return RoundRobinSampler(n, spec.cohort_size, spec.seed)
    if spec.sampler == "stratified":
        return StratifiedSampler(n, spec.cohort_size, hierarchy.segments(1), spec.seed)
    raise ValueError(f"unknown sampler {spec.sampler!r}")  # pragma: no cover
