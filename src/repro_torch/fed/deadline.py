"""Semi-synchronous cloud rounds: deadlines, quorums, and staleness.

Copy-port of ``repro.fed.deadline`` (host numpy): the same staleness
grammar, cadences, close rule and random streams, so a scheduler fed the
same dead-edge marks plans the same rounds as the JAX package's, bit for
bit, and its ``state_dict`` loads in either package.

The synchronous HierFAVG barrier stalls every cloud round on the slowest
edge — one straggling subtree degrades the whole system, the exact
heterogeneous-resource regime HFEL (arXiv 2002.11343) targets. This module
owns the host-side half of the semi-synchronous engine:

* ``StalenessPolicy`` — how much a late edge's update counts once it lands
  (``constant`` | ``poly:a`` → (1+s)^-a | ``exp:a`` → e^{-a·s}); a new
  config axis alongside ``AggregatorSpec``.
* ``EdgeCadenceModel`` — per-edge cloud-interval durations: a persistent
  speed factor per edge (drawn from a ``sim.distributions`` grammar string,
  or reduced from a ``StragglerModel``'s slowness array) times per-round
  jitter.
* ``SemiSyncScheduler`` — the event queue. Each cloud round it advances
  every edge's upload-finish time, closes the round when a quorum / FedBuff
  buffer fills or a timeout fires (never before the first arrival, never
  past the ``max_staleness`` force-wait bound), injects mid-round upload
  drops with bounded retry, and returns a :class:`RoundPlan` telling the
  engine which edges fold into the cloud aggregate and at what weight.

Everything here is pure host numpy with JSON-safe ``state_dict`` /
``load_state_dict`` (PCG64 state, same contract as the cohort samplers and
``sim.distributions``), so an interrupted semi-synchronous run resumes on
the exact same event sequence.

Semantics of a :class:`RoundPlan` (consumed by ``fed.engine.DeadlineEngine``
via ``core.hierfavg.build_deadline_super_round``):

* ``folded`` edges contribute their upload to the cloud aggregate at weight
  ``weights`` (arrival × staleness decay) and receive the new cloud model;
  their next interval starts at the round's close.
* late edges (in flight past the close) keep computing; their upload is
  *carried into the next round* rather than dropped, and they miss the
  broadcast — their clients keep the edge-synced model (staleness + 1).
* dropped uploads (fault injection) retry at the next round start up to
  ``retry_limit`` times, then the edge abandons the stale upload and
  recomputes — the aggregation renormalizes over whoever folded
  (skip-and-reweight; the masked weighted mean does this for free).

Compute-lockstep approximation: every edge executes the same κ₂·κ₁ device
steps per dispatched interval; heterogeneity enters through *when* the
cloud folds an edge in (arrival times, staleness decay, frozen late
subtrees), not through differing step counts. ``docs/robustness.md``
spells out what this does and does not model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional

import numpy as np

from repro_torch.sim.distributions import Distribution, parse_distribution

__all__ = [
    "StalenessPolicy",
    "parse_staleness",
    "EdgeCadenceModel",
    "RoundPlan",
    "SemiSyncScheduler",
]


# ---------------------------------------------------------------------------
# Staleness policies
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StalenessPolicy:
    """Weight multiplier for an update that is ``s`` cloud rounds stale.

    All policies are exactly 1.0 at s=0 (an on-time update is never
    down-weighted — the parity contract with the synchronous engine depends
    on this being exact, and it is: ``(1+0)**-a == exp(-a*0) == 1.0``).
    """

    kind: str = "constant"
    rate: float = 0.0

    def weights(self, staleness: np.ndarray) -> np.ndarray:
        s = np.asarray(staleness, np.float64)
        if self.kind == "constant":
            return np.ones_like(s)
        if self.kind == "poly":
            return (1.0 + s) ** (-self.rate)
        return np.exp(-self.rate * s)

    @property
    def is_trivial(self) -> bool:
        return self.kind == "constant" or self.rate == 0.0

    def describe(self) -> str:
        return self.kind if self.kind == "constant" else f"{self.kind}:{self.rate:g}"


def parse_staleness(text: str) -> StalenessPolicy:
    """Parse the staleness grammar: ``constant`` | ``poly:A`` | ``exp:A``."""
    name, _, args = text.strip().partition(":")
    if name == "constant":
        if args:
            raise ValueError(f"bad staleness {text!r}: constant takes no rate")
        return StalenessPolicy("constant", 0.0)
    if name in ("poly", "exp"):
        try:
            rate = float(args)
        except ValueError:
            raise ValueError(f"bad staleness {text!r}: {name} needs a numeric rate") from None
        if rate < 0:
            raise ValueError(f"bad staleness {text!r}: rate must be >= 0")
        return StalenessPolicy(name, rate)
    raise ValueError(
        f"unknown staleness policy {text!r}; grammar: constant | poly:A | exp:A"
    )


# ---------------------------------------------------------------------------
# Edge cadence
# ---------------------------------------------------------------------------


class EdgeCadenceModel:
    """Per-edge cloud-interval durations (simulated seconds).

    ``base_interval_s`` is the nominal duration of ONE edge interval (κ₁
    local steps + the client↔edge exchange); each edge multiplies it by a
    persistent ``slowness`` factor (heterogeneous provisioning) and a fresh
    jitter draw per call. The speed distribution is consumed once at
    construction; only the jitter stream stays live (and is checkpointed).
    """

    def __init__(
        self,
        num_edges: int,
        base_interval_s: float = 1.0,
        *,
        speed: str = "det",
        jitter: str = "det",
        seed: int = 0,
        slowness: Optional[np.ndarray] = None,
    ):
        if num_edges < 1:
            raise ValueError(f"num_edges must be >= 1, got {num_edges}")
        if base_interval_s <= 0:
            raise ValueError(f"base_interval_s must be positive, got {base_interval_s}")
        self.num_edges = int(num_edges)
        self.base_interval_s = float(base_interval_s)
        if slowness is not None:
            self.slowness = np.asarray(slowness, np.float64).copy()
            if self.slowness.shape != (self.num_edges,):
                raise ValueError(
                    f"slowness shape {self.slowness.shape} != ({self.num_edges},)"
                )
        else:
            self.slowness = parse_distribution(speed, seed=(seed, 1)).sample(self.num_edges)
        self._jitter: Distribution = parse_distribution(jitter, seed=(seed, 2))

    @classmethod
    def from_stragglers(
        cls,
        model,
        segments: np.ndarray,
        num_edges: int,
        kappa1: int,
        *,
        jitter: str = "det",
        seed: int = 0,
    ) -> "EdgeCadenceModel":
        """Derive edge cadences from a ``StragglerModel``: an edge's interval
        completes when its slowest client does, so the edge slowness is the
        per-edge max of the model's persistent per-client slowness. Reads
        the ``slowness`` array only — never the model's RNG stream, which
        drives the survival-mask draws and must not shift.
        """
        seg = np.asarray(segments)
        slow = np.zeros(num_edges, np.float64)
        np.maximum.at(slow, seg, np.asarray(model.slowness, np.float64))
        slow[slow == 0.0] = 1.0  # edge with no clients: nominal speed
        return cls(
            num_edges,
            kappa1 * model.mean_step_s,
            jitter=jitter,
            seed=seed,
            slowness=slow,
        )

    def interval_durations(self) -> np.ndarray:
        """(E,) simulated seconds for each edge's next edge interval.
        Consumes one jitter draw per edge."""
        return self.base_interval_s * self.slowness * self._jitter.sample(self.num_edges)

    def state_dict(self) -> Dict[str, Any]:
        return {"slowness": self.slowness.copy(), "jitter": self._jitter.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.slowness = np.asarray(state["slowness"], np.float64).copy()
        self._jitter.load_state_dict(state["jitter"])


# ---------------------------------------------------------------------------
# The scheduler
# ---------------------------------------------------------------------------


class RoundPlan(NamedTuple):
    """What the cloud does at one semi-synchronous round close."""

    start: float  # simulated clock when the round opened
    close: float  # simulated clock when the cloud closed the round
    arrivals: np.ndarray  # (E,) upload-ready times (in-flight finish times)
    folded: np.ndarray  # (E,) bool: upload aggregated into this cloud model
    staleness: np.ndarray  # (E,) int: rounds since each edge last folded
    weights: np.ndarray  # (E,) float: arrival x staleness multiplier (0 if not folded)
    dropped: np.ndarray  # (E,) bool: upload arrived but was lost (fault injection)
    dead: np.ndarray  # (E,) bool: edge had no live clients this round (outage)

    @property
    def is_trivial(self) -> bool:
        """True when this round is indistinguishable from the synchronous
        barrier: every edge folded, nothing dropped, all weights exactly 1."""
        return bool(
            self.folded.all() and not self.dropped.any() and np.all(self.weights == 1.0)
        )

    def client_gate(self, segments: np.ndarray) -> np.ndarray:
        """(N,) float32 per-client cloud-aggregation gate: the edge weight
        broadcast to each client (0 for late/dropped/dead edges)."""
        return self.weights[np.asarray(segments)].astype(np.float32)


class SemiSyncScheduler:
    """Event-driven cloud-round bookkeeping over per-edge upload times.

    Round close rule, per :meth:`next_round` call:

    1. every idle edge (just folded, has the current cloud model) starts a
       fresh interval of ``intervals_per_round`` edge intervals at the
       current clock; in-flight edges keep their finish times;
    2. the K-th live arrival closes the round, where K is ``buffer_size``
       (FedBuff) if set, else ``ceil(quorum * live_edges)``;
    3. a positive ``timeout_s`` caps the close at ``start + timeout_s`` but
       never before the first live arrival (the cloud always folds at
       least one upload);
    4. any live edge at ``staleness >= max_staleness`` is force-waited —
       bounded staleness is a hard guarantee, not a preference;
    5. each arrived upload is lost with probability ``edge_drop_rate``;
       lost uploads retry at the next round start up to ``retry_limit``
       times, then the edge abandons the upload and recomputes.

    ``dead`` edges (outage: no live clients, see
    ``fed.failures.compose_masks``) are excluded from the quorum
    denominator and from the force-wait bound — a dead edge cannot stall
    the cloud, unlike a merely *late* one whose upload is still coming.
    """

    def __init__(
        self,
        cadence: EdgeCadenceModel,
        *,
        intervals_per_round: int = 1,
        quorum: float = 1.0,
        timeout_s: float = 0.0,
        buffer_size: int = 0,
        max_staleness: int = 2,
        staleness: str = "constant",
        edge_drop_rate: float = 0.0,
        retry_limit: int = 1,
        seed: int = 0,
    ):
        if not 0.0 < quorum <= 1.0:
            raise ValueError(f"quorum must be in (0, 1], got {quorum}")
        if timeout_s < 0:
            raise ValueError(f"timeout_s must be >= 0, got {timeout_s}")
        if buffer_size < 0 or buffer_size > cadence.num_edges:
            raise ValueError(
                f"buffer_size must be in 0..{cadence.num_edges}, got {buffer_size}"
            )
        if max_staleness < 0:
            raise ValueError(f"max_staleness must be >= 0, got {max_staleness}")
        if not 0.0 <= edge_drop_rate < 1.0:
            raise ValueError(f"edge_drop_rate must be in [0, 1), got {edge_drop_rate}")
        if retry_limit < 0:
            raise ValueError(f"retry_limit must be >= 0, got {retry_limit}")
        if intervals_per_round < 1:
            raise ValueError(f"intervals_per_round must be >= 1, got {intervals_per_round}")
        self.cadence = cadence
        self.intervals_per_round = int(intervals_per_round)
        self.quorum = float(quorum)
        self.timeout_s = float(timeout_s)
        self.buffer_size = int(buffer_size)
        self.max_staleness = int(max_staleness)
        self.policy = parse_staleness(staleness)
        self.edge_drop_rate = float(edge_drop_rate)
        self.retry_limit = int(retry_limit)
        self.seed = seed
        e = cadence.num_edges
        self.clock = 0.0
        self.rounds_closed = 0
        self.finish = np.zeros(e, np.float64)
        self.in_flight = np.zeros(e, bool)
        self.staleness = np.zeros(e, np.int64)
        self.retry = np.zeros(e, np.int64)
        self._rng = np.random.default_rng(seed)

    @property
    def num_edges(self) -> int:
        return self.cadence.num_edges

    @property
    def is_barrier(self) -> bool:
        """True when the configuration can never leave an edge behind:
        full quorum, no timeout, no buffer, no fault injection."""
        return (
            self.quorum == 1.0
            and self.timeout_s == 0.0
            and self.buffer_size == 0
            and self.edge_drop_rate == 0.0
        )

    # ------------------------------------------------------------------
    def next_round(self, dead: Optional[np.ndarray] = None) -> RoundPlan:
        """Advance the event queue by one cloud round and return its plan.
        ``dead``: optional (E,) truthy marks for edges with no live clients
        this boundary (from the outage channel of ``compose_masks``)."""
        e = self.num_edges
        start = self.clock
        # one duration draw per edge per round (jitter at round granularity)
        dur = self.intervals_per_round * self.cadence.interval_durations()
        starting = ~self.in_flight
        self.finish = np.where(starting, start + dur, self.finish)
        self.in_flight = np.ones(e, bool)
        arrivals = self.finish.copy()

        dead_e = np.zeros(e, bool) if dead is None else np.asarray(dead).astype(bool)
        live = ~dead_e
        if not live.any():
            # total outage: nothing to wait for, nothing folds
            close = start
            arrived = np.zeros(e, bool)
        else:
            order = np.sort(arrivals[live])
            k = self.buffer_size if self.buffer_size > 0 else math.ceil(self.quorum * int(live.sum()))
            k = min(max(k, 1), int(live.sum()))
            close = float(order[k - 1])
            if self.timeout_s > 0.0:
                close = max(min(close, start + self.timeout_s), float(order[0]))
            must = live & (self.staleness >= self.max_staleness)
            if must.any():
                close = max(close, float(arrivals[must].max()))
            arrived = live & (arrivals <= close)

        # fault injection: each arrived upload is lost independently
        drop_u = self._rng.random(e)
        dropped = arrived & (drop_u < self.edge_drop_rate)
        folded = arrived & ~dropped

        stale_used = self.staleness.copy()
        weights = np.where(folded, self.policy.weights(stale_used), 0.0)

        # post-round state: folded edges received the broadcast and restart
        # at the close; retryable drops re-send the buffered upload at the
        # next round start; exhausted drops abandon it and recompute.
        self.in_flight = self.in_flight & ~folded
        retryable = dropped & (self.retry < self.retry_limit)
        exhausted = dropped & ~retryable
        self.finish = np.where(retryable, close, self.finish)
        self.retry = np.where(retryable, self.retry + 1, self.retry)
        self.retry[folded | exhausted] = 0
        self.in_flight = self.in_flight & ~exhausted
        self.staleness = np.where(folded, 0, self.staleness + 1)
        self.clock = close
        self.rounds_closed += 1
        return RoundPlan(
            start=start,
            close=close,
            arrivals=arrivals,
            folded=folded,
            staleness=stale_used,
            weights=weights,
            dropped=dropped,
            dead=dead_e,
        )

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "clock": self.clock,
            "rounds_closed": self.rounds_closed,
            "finish": self.finish.copy(),
            "in_flight": self.in_flight.copy(),
            "staleness": self.staleness.copy(),
            "retry": self.retry.copy(),
            "rng": self._rng.bit_generator.state,
            "cadence": self.cadence.state_dict(),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.clock = float(state["clock"])
        self.rounds_closed = int(state["rounds_closed"])
        self.finish = np.asarray(state["finish"], np.float64).copy()
        self.in_flight = np.asarray(state["in_flight"]).astype(bool).copy()
        self.staleness = np.asarray(state["staleness"], np.int64).copy()
        self.retry = np.asarray(state["retry"], np.int64).copy()
        self._rng.bit_generator.state = state["rng"]
        self.cadence.load_state_dict(state["cadence"])
