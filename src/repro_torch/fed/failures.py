"""Failure model and straggler mitigation for the federated runner: a
copy-port of ``repro.fed.failures`` (numpy, host-side), so the same seeds
give bit-identical masks and the ``state_dict``s round-trip the same way.

* ``FailureSimulator`` - per-client iid failure/recovery Markov chain
  (deterministic under seed), standing in for a failure detector.
* ``StragglerModel`` - per-client local-step latency ~ lognormal; a client
  whose kappa1 steps exceed the edge deadline is left out of that edge
  aggregation but keeps its local model and rejoins at the next boundary.
* ``SubtreeOutageSimulator`` - correlated failures: a tier-``tier`` node of
  the tree goes down with every client beneath it; the zero-survivor rule of
  ``core.aggregation`` keeps the subtree's parameters until it recovers.
* ``combine_masks`` / ``compose_masks`` - the product of the masks, and the
  same with the dead (outage) and late (deadline miss) channels kept apart.

The runner (``fed.runner``) hands the masks to the round as (N,) float
tensors.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class FailureSimulator:
    """Two-state Markov chain per client: alive <-> dead.

    p_fail: P(alive->dead) per aggregation boundary; p_recover: P(dead->alive).
    """

    num_clients: int
    p_fail: float = 0.0
    p_recover: float = 0.5
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.alive = np.ones(self.num_clients, bool)

    def step(self) -> np.ndarray:
        u = self._rng.random(self.num_clients)
        die = self.alive & (u < self.p_fail)
        recover = (~self.alive) & (u < self.p_recover)
        self.alive = (self.alive & ~die) | recover
        return self.alive.astype(np.float32)

    def state_dict(self):
        return {"alive": self.alive.copy(), "rng": self._rng.bit_generator.state}

    def load_state_dict(self, s):
        self.alive = s["alive"].copy()
        self._rng.bit_generator.state = s["rng"]


@dataclasses.dataclass
class StragglerModel:
    """Lognormal per-client step-latency; exceeds-deadline -> masked out."""

    num_clients: int
    mean_step_s: float = 1.0
    sigma: float = 0.3
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        # persistent per-client slowness factor (heterogeneous hardware)
        self.slowness = np.exp(self._rng.normal(0.0, self.sigma / 2, self.num_clients))

    def interval_latency(self, kappa1: int) -> np.ndarray:
        """Simulated wall time for each client to finish kappa1 local steps."""
        jitter = np.exp(self._rng.normal(0.0, self.sigma, self.num_clients))
        return kappa1 * self.mean_step_s * self.slowness * jitter

    def deadline_for(self, kappa1: int, *, percentile: float = 95.0, slack: float = 1.1) -> float:
        """Deadline = slack * p-th percentile of the latency distribution."""
        # analytic percentile of lognormal(mean*slowness median)
        base = kappa1 * self.mean_step_s * np.median(self.slowness)
        z = {90.0: 1.2816, 95.0: 1.6449, 99.0: 2.3263}.get(percentile, 1.6449)
        return slack * base * float(np.exp(self.sigma * z))

    def survivors(self, kappa1: int, deadline: Optional[float] = None) -> Tuple[np.ndarray, float]:
        lat = self.interval_latency(kappa1)
        d = deadline if deadline is not None else self.deadline_for(kappa1)
        return (lat <= d).astype(np.float32), d

    def state_dict(self):
        # slowness rides along (it is drawn from the same stream at
        # construction, so a resumed model must not redraw it)
        return {"slowness": self.slowness.copy(), "rng": self._rng.bit_generator.state}

    def load_state_dict(self, s):
        self.slowness = s["slowness"].copy()
        self._rng.bit_generator.state = s["rng"]


@dataclasses.dataclass
class SubtreeOutageSimulator:
    """Two-state Markov chain per tier-``tier`` node of a hierarchy: when a
    node is down, every client in its subtree is masked out together.

    spec: a ``core.hierarchy.HierarchySpec`` (or FedTopology via
    ``as_hierarchy``); tier 1 = edge servers, higher tiers = regions.
    """

    spec: object
    tier: int = 1
    p_fail: float = 0.0
    p_recover: float = 0.5
    seed: int = 0

    def __post_init__(self):
        from repro_torch.core.hierarchy import as_hierarchy

        self.spec = as_hierarchy(self.spec)
        if not 1 <= self.tier <= self.spec.depth:
            raise ValueError(f"tier {self.tier} outside 1..{self.spec.depth}")
        self._segments = self.spec.segments(self.tier)
        self._num_nodes = self.spec.num_nodes(self.tier)
        self._rng = np.random.default_rng(self.seed)
        self.alive = np.ones(self._num_nodes, bool)

    def step(self) -> np.ndarray:
        """Advance one boundary; returns the (N,) client survival mask."""
        u = self._rng.random(self._num_nodes)
        die = self.alive & (u < self.p_fail)
        recover = (~self.alive) & (u < self.p_recover)
        self.alive = (self.alive & ~die) | recover
        return self.alive[self._segments].astype(np.float32)

    def state_dict(self):
        return {"alive": self.alive.copy(), "rng": self._rng.bit_generator.state}

    def load_state_dict(self, s):
        self.alive = s["alive"].copy()
        self._rng.bit_generator.state = s["rng"]


def combine_masks(*masks: Optional[np.ndarray]) -> Optional[np.ndarray]:
    out: Optional[np.ndarray] = None
    for m in masks:
        if m is None:
            continue
        out = m if out is None else out * m
    return out


class MaskComposition(NamedTuple):
    """Survival masks split by *why* a client is missing a boundary.

    ``effective`` is the plain product of every mask (what the aggregation
    operators consume — identical to ``combine_masks`` over all inputs).
    ``late`` flags clients whose compute finished but whose upload missed
    the boundary (straggler deadline): their model is fresh and the upload
    can be deferred to the next boundary. ``dead`` flags clients with no
    contribution at all (outage): nothing exists to defer. A client that is
    both dead and slow counts as dead — there is no upload to be late with.
    All three are None when no mask of that kind was supplied.
    """

    effective: Optional[np.ndarray]
    late: Optional[np.ndarray]
    dead: Optional[np.ndarray]

    @property
    def late_count(self) -> int:
        return 0 if self.late is None else int(np.sum(self.late > 0))

    @property
    def dead_count(self) -> int:
        return 0 if self.dead is None else int(np.sum(self.dead > 0))


def compose_masks(
    dead: Sequence[Optional[np.ndarray]] = (),
    late: Sequence[Optional[np.ndarray]] = (),
) -> MaskComposition:
    """Compose outage masks (``dead``: 0 = no contribution) with straggler
    masks (``late``: 0 = compute done, upload deferred) without losing the
    distinction ``combine_masks`` erases.

    Returns a :class:`MaskComposition` whose ``effective`` channel equals
    ``combine_masks(*dead, *late)`` bit for bit — existing aggregation
    semantics are unchanged — plus indicator channels: ``late[i] = 1`` iff
    client i survived every outage mask but was zeroed by a straggler mask,
    ``dead[i] = 1`` iff client i was zeroed by an outage mask.
    """
    dead_m = combine_masks(*dead)
    late_m = combine_masks(*late)
    effective = combine_masks(dead_m, late_m)
    dead_ind = None if dead_m is None else (dead_m == 0).astype(np.float32)
    late_ind = None
    if late_m is not None:
        late_ind = (late_m == 0).astype(np.float32)
        if dead_m is not None:
            late_ind = late_ind * (dead_m != 0)  # dead wins: nothing to defer
    return MaskComposition(effective=effective, late=late_ind, dead=dead_ind)
