"""The spec's ``network`` section (``repro.sim.distributions``'s
``NetworkSpec``): per-entity cost distributions for the round-replay
simulator. Training never reads it, so the port carries its fields for the
spec tree to round-trip; parsing the distribution grammar comes with the
simulator (ROADMAP.md Queue 1 item 11)."""
from __future__ import annotations

import dataclasses


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
