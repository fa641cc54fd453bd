"""Seeded, checkpointable cost distributions for the round-replay simulator.

Copy-port of ``repro.sim.distributions``: the same grammar, the same numpy
generators seeded the same way, so every draw is bit-identical to the JAX
package's and a generator state saved by one loads in the other.

The analytic cost model (``core.cost_model``) prices every client, link,
and backhaul identically — it answers "what does one round cost", never
"what is the p99 round time when 10% of edges sit on a congested
backhaul". This module owns the stochastic half of that gap:

* ``Distribution`` — a seeded multiplicative-factor distribution with
  ``state_dict``/``load_state_dict`` (the PCG64 state survives a JSON
  round-trip, same contract as the cohort samplers), so a checkpointed
  replay resumes bit-exactly.
* ``NetworkSpec`` — the serializable ``ExperimentSpec`` section naming one
  distribution per cost axis (persistent per-client/per-edge factors +
  per-draw jitter), in a small CLI grammar:

      det            deterministic 1.0 (the analytic model)
      det:2.5        deterministic factor 2.5
      lognormal:0.3  exp(N(0, 0.3)), median 1
      mixture:0.9@1,0.1@8
                     10% of entities draw an 8x factor (congested tail)

All factors are *multiplicative* with a deterministic value of exactly
1.0, so a zero-variance ``NetworkSpec()`` leaves every calibrated cost
bit-identical — the replay then reduces to the analytic model (the parity
contract tested in ``tests/test_sim.py`` and ``tests/test_torch_sim.py``).

Pure numpy on purpose: ``fed.api`` imports ``NetworkSpec`` into the spec
tree, and the deadline scheduler (``fed.deadline``) draws its edge
cadences from these distributions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import numpy as np

__all__ = [
    "Distribution",
    "DeterministicDist",
    "LogNormalDist",
    "MixtureDist",
    "parse_distribution",
    "NetworkSpec",
    "NetworkModel",
]


# ---------------------------------------------------------------------------
# Distributions
# ---------------------------------------------------------------------------


class Distribution:
    """A seeded multiplicative-factor distribution.

    ``sample(n)`` returns an (n,) float64 array of factors; deterministic
    distributions never touch an RNG, so their draws are exactly their
    value (no float noise — the zero-variance parity contract depends on
    this).
    """

    kind = "base"

    def sample(self, n: int) -> np.ndarray:  # pragma: no cover - abstract
        raise NotImplementedError

    def mean(self) -> float:  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def is_deterministic(self) -> bool:
        return False

    def state_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if state.get("kind") != self.kind:
            raise ValueError(f"state is for {state.get('kind')!r}, not {self.kind!r}")


@dataclasses.dataclass
class DeterministicDist(Distribution):
    """A constant factor — ``det`` (1.0) is the analytic model."""

    value: float = 1.0
    kind = "det"

    def __post_init__(self):
        if self.value <= 0:
            raise ValueError(f"det factor must be positive, got {self.value}")

    def sample(self, n: int) -> np.ndarray:
        return np.full(n, float(self.value), np.float64)

    def mean(self) -> float:
        return float(self.value)

    @property
    def is_deterministic(self) -> bool:
        return True


class LogNormalDist(Distribution):
    """``exp(N(0, sigma)) * median`` — median ``median``, heavy right tail."""

    kind = "lognormal"

    def __init__(self, sigma: float, median: float = 1.0, seed: int = 0):
        if sigma <= 0:
            raise ValueError(f"lognormal sigma must be positive, got {sigma}")
        if median <= 0:
            raise ValueError(f"lognormal median must be positive, got {median}")
        self.sigma = float(sigma)
        self.median = float(median)
        self._rng = np.random.default_rng(seed)

    def sample(self, n: int) -> np.ndarray:
        return self.median * np.exp(self._rng.normal(0.0, self.sigma, n))

    def mean(self) -> float:
        return self.median * float(np.exp(self.sigma**2 / 2.0))

    def state_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "sigma": self.sigma, "median": self.median,
                "rng": self._rng.bit_generator.state}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        self._rng.bit_generator.state = state["rng"]


class MixtureDist(Distribution):
    """A finite mixture of constant factors: ``mixture:0.9@1,0.1@8`` gives
    10% of draws an 8x factor — the congested-tail model."""

    kind = "mixture"

    def __init__(self, weights: Sequence[float], factors: Sequence[float], seed: int = 0):
        w = np.asarray(weights, np.float64)
        f = np.asarray(factors, np.float64)
        if w.shape != f.shape or w.ndim != 1 or w.size == 0:
            raise ValueError("mixture needs matching 1-d weights and factors")
        if np.any(w < 0) or not np.isclose(w.sum(), 1.0, atol=1e-9):
            raise ValueError(f"mixture weights must be >= 0 and sum to 1, got {w}")
        if np.any(f <= 0):
            raise ValueError(f"mixture factors must be positive, got {f}")
        self.weights = w / w.sum()
        self.factors = f
        self._rng = np.random.default_rng(seed)

    def sample(self, n: int) -> np.ndarray:
        idx = self._rng.choice(self.factors.size, size=n, p=self.weights)
        return self.factors[idx]

    def mean(self) -> float:
        return float(np.dot(self.weights, self.factors))

    def state_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "weights": self.weights.tolist(),
                "factors": self.factors.tolist(), "rng": self._rng.bit_generator.state}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        self._rng.bit_generator.state = state["rng"]


def parse_distribution(text: str, *, seed: int = 0) -> Distribution:
    """Parse the NetworkSpec grammar: ``det[:V]``, ``lognormal:SIGMA[:MEDIAN]``,
    ``mixture:W@F,W@F,...``."""
    name, _, args = text.strip().partition(":")
    try:
        if name == "det":
            return DeterministicDist(float(args)) if args else DeterministicDist()
        if name == "lognormal":
            parts = args.split(":")
            if not args or len(parts) > 2:
                raise ValueError("lognormal needs SIGMA[:MEDIAN]")
            sigma = float(parts[0])
            median = float(parts[1]) if len(parts) == 2 else 1.0
            return LogNormalDist(sigma, median, seed=seed)
        if name == "mixture":
            weights, factors = [], []
            for comp in args.split(","):
                w, at, f = comp.partition("@")
                if not at:
                    raise ValueError(f"mixture component {comp!r} must be WEIGHT@FACTOR")
                weights.append(float(w))
                factors.append(float(f))
            return MixtureDist(weights, factors, seed=seed)
    except ValueError as e:
        raise ValueError(f"bad distribution {text!r}: {e}") from None
    raise ValueError(
        f"unknown distribution {text!r}; grammar: det[:V] | lognormal:SIGMA[:MEDIAN] "
        f"| mixture:W@F,W@F,..."
    )


# ---------------------------------------------------------------------------
# NetworkSpec: the ExperimentSpec section
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    """Per-entity cost distributions for the round-replay simulator
    (``repro_torch.sim``). Inert for training — the runner never reads it;
    ``sim.simulate_spec`` builds a :class:`NetworkModel` from it.

    Persistent factors (drawn once per entity at build — heterogeneous
    hardware / provisioned links):

        client_speed   per-client compute-time factor
        client_link    per-client uplink factor
        edge_uplink    per-edge factor on every client→edge upload
        edge_backhaul  per-edge factor on the edge→cloud (level-2) hop

    Per-draw jitter (sampled per DAG node during replay — load spikes,
    channel fading):

        compute_jitter   per client-step (or per edge interval, see
                         ``jitter_granularity``) compute-time factor
        link_jitter      per client upload
        backhaul_jitter  per hop at levels >= 2

    ``contention=True`` scales each client's uplink by ``n_e / cap_e``
    (clients sharing edge e's band / its nominal capacity) — under the
    tree's own association every factor is exactly 1, so the parity
    contract is unaffected; the association optimizer trades this load
    term against the persistent link factors (the HFEL knob).
    """

    client_speed: str = "det"
    client_link: str = "det"
    edge_uplink: str = "det"
    edge_backhaul: str = "det"
    compute_jitter: str = "det"
    link_jitter: str = "det"
    backhaul_jitter: str = "det"
    contention: bool = False
    jitter_granularity: str = "step"  # step | interval
    seed: int = 0

    def __post_init__(self):
        if self.jitter_granularity not in ("step", "interval"):
            raise ValueError(
                f"jitter_granularity must be step|interval, got {self.jitter_granularity!r}"
            )
        for f in dataclasses.fields(self):
            if f.type == "str" and f.name != "jitter_granularity":
                parse_distribution(getattr(self, f.name))  # validate eagerly

    @property
    def is_active(self) -> bool:
        """True when any axis deviates from the analytic model."""
        default = NetworkSpec()
        return any(
            getattr(self, f.name) != getattr(default, f.name)
            for f in dataclasses.fields(self)
            if f.name != "seed"
        )

    def build(self, tree) -> "NetworkModel":
        """Draw the persistent factors for ``tree`` (a ``HierarchySpec``)
        and seed the jitter streams. Deterministic under ``seed``."""
        return NetworkModel.build(self, tree)

    def describe(self) -> str:
        default = NetworkSpec()
        tags = [
            f"{f.name}={getattr(self, f.name)}"
            for f in dataclasses.fields(self)
            if f.name != "seed" and getattr(self, f.name) != getattr(default, f.name)
        ]
        return " ".join(tags) if tags else "det"


# stream salts: every axis gets an independent, reproducible PCG64 stream
_STREAMS = {
    "client_speed": 1, "client_link": 2, "edge_uplink": 3, "edge_backhaul": 4,
    "compute_jitter": 5, "link_jitter": 6, "backhaul_jitter": 7,
}


@dataclasses.dataclass
class NetworkModel:
    """The built form of :class:`NetworkSpec`: persistent factor arrays
    (fixed after build) + live jitter distributions (checkpointable)."""

    spec: NetworkSpec
    client_speed: np.ndarray  # (N,)
    client_link: np.ndarray  # (N,)
    edge_uplink: np.ndarray  # (E,)
    edge_backhaul: np.ndarray  # (E,)
    compute_jitter: Distribution
    link_jitter: Distribution
    backhaul_jitter: Distribution

    @classmethod
    def build(cls, spec: NetworkSpec, tree) -> "NetworkModel":
        n = tree.num_clients
        e = tree.num_nodes(1) if tree.depth >= 1 else 1

        def persistent(field: str, count: int) -> np.ndarray:
            d = parse_distribution(getattr(spec, field), seed=(spec.seed, _STREAMS[field]))
            return d.sample(count)

        def jitter(field: str) -> Distribution:
            return parse_distribution(getattr(spec, field), seed=(spec.seed, _STREAMS[field]))

        return cls(
            spec=spec,
            client_speed=persistent("client_speed", n),
            client_link=persistent("client_link", n),
            edge_uplink=persistent("edge_uplink", e),
            edge_backhaul=persistent("edge_backhaul", e),
            compute_jitter=jitter("compute_jitter"),
            link_jitter=jitter("link_jitter"),
            backhaul_jitter=jitter("backhaul_jitter"),
        )

    @property
    def contention(self) -> bool:
        return self.spec.contention

    @property
    def jitter_granularity(self) -> str:
        return self.spec.jitter_granularity

    def state_dict(self) -> Dict[str, Any]:
        """The live RNG state (jitter streams). Persistent factors are a
        pure function of (spec, tree) and rebuild identically."""
        return {
            "compute_jitter": self.compute_jitter.state_dict(),
            "link_jitter": self.link_jitter.state_dict(),
            "backhaul_jitter": self.backhaul_jitter.state_dict(),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.compute_jitter.load_state_dict(state["compute_jitter"])
        self.link_jitter.load_state_dict(state["link_jitter"])
        self.backhaul_jitter.load_state_dict(state["backhaul_jitter"])
