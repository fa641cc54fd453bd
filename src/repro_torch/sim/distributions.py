"""The spec's ``network`` section (``repro.sim.distributions``'s
``NetworkSpec``): per-entity cost distributions for the round-replay
simulator, in a small grammar:

    det            deterministic 1.0 (the analytic model)
    det:2.5        deterministic factor 2.5
    lognormal:0.3  exp(N(0, 0.3)), median 1 (``lognormal:SIGMA[:MEDIAN]``)
    mixture:0.9@1,0.1@8
                   10% of entities draw an 8x factor

Copy-port of the grammar, the distribution classes and their validity
checks, so a ``NetworkSpec`` validates every string eagerly, as the JAX
package's does. Training never reads the section. Sampling, the
checkpointable generator state and ``NetworkModel`` come with the simulator
(ROADMAP.md Queue 1 item 11).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

__all__ = ["Distribution", "DeterministicDist", "LogNormalDist", "MixtureDist", "parse_distribution", "NetworkSpec"]


class Distribution:
    """A multiplicative cost factor distribution."""

    kind = "base"

    def mean(self) -> float:  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def is_deterministic(self) -> bool:
        return False


@dataclasses.dataclass
class DeterministicDist(Distribution):
    """A constant factor; ``det`` (1.0) is the analytic model."""

    value: float = 1.0
    kind = "det"

    def __post_init__(self):
        if self.value <= 0:
            raise ValueError(f"det factor must be positive, got {self.value}")

    def mean(self) -> float:
        return float(self.value)

    @property
    def is_deterministic(self) -> bool:
        return True


class LogNormalDist(Distribution):
    """``exp(N(0, sigma)) * median``."""

    kind = "lognormal"

    def __init__(self, sigma: float, median: float = 1.0):
        if sigma <= 0:
            raise ValueError(f"lognormal sigma must be positive, got {sigma}")
        if median <= 0:
            raise ValueError(f"lognormal median must be positive, got {median}")
        self.sigma = float(sigma)
        self.median = float(median)

    def mean(self) -> float:
        return self.median * math.exp(self.sigma**2 / 2.0)


class MixtureDist(Distribution):
    """A finite mixture of constant factors: ``mixture:0.9@1,0.1@8``."""

    kind = "mixture"

    def __init__(self, weights: Sequence[float], factors: Sequence[float]):
        w = [float(x) for x in weights]
        f = [float(x) for x in factors]
        if len(w) != len(f) or not w:
            raise ValueError("mixture needs matching 1-d weights and factors")
        if any(x < 0 for x in w) or abs(sum(w) - 1.0) > 1e-9 + 1e-5:  # np.isclose(sum, 1, atol=1e-9)
            raise ValueError(f"mixture weights must be >= 0 and sum to 1, got {w}")
        if any(x <= 0 for x in f):
            raise ValueError(f"mixture factors must be positive, got {f}")
        total = sum(w)
        self.weights = [x / total for x in w]
        self.factors = f

    def mean(self) -> float:
        return sum(w * f for w, f in zip(self.weights, self.factors))


def parse_distribution(text: str) -> Distribution:
    """Parse the grammar: ``det[:V]``, ``lognormal:SIGMA[:MEDIAN]``,
    ``mixture:W@F,W@F,...``. Raises ``ValueError`` on anything else."""
    name, _, args = text.strip().partition(":")
    try:
        if name == "det":
            return DeterministicDist(float(args)) if args else DeterministicDist()
        if name == "lognormal":
            parts = args.split(":")
            if not args or len(parts) > 2:
                raise ValueError("lognormal needs SIGMA[:MEDIAN]")
            return LogNormalDist(float(parts[0]), float(parts[1]) if len(parts) == 2 else 1.0)
        if name == "mixture":
            weights, factors = [], []
            for comp in args.split(","):
                w, at, f = comp.partition("@")
                if not at:
                    raise ValueError(f"mixture component {comp!r} must be WEIGHT@FACTOR")
                weights.append(float(w))
                factors.append(float(f))
            return MixtureDist(weights, factors)
    except ValueError as e:
        raise ValueError(f"bad distribution {text!r}: {e}") from None
    raise ValueError(
        f"unknown distribution {text!r}; grammar: det[:V] | lognormal:SIGMA[:MEDIAN] | mixture:W@F,W@F,..."
    )


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
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
