"""The spec's ``participation`` section (``repro.fed.participation``'s
``ParticipationSpec``). Cohort samplers and the cohort engine come with
ROADMAP.md Queue 1 item 10; until then only the inert default runs."""
from __future__ import annotations

import dataclasses

SAMPLERS = ("uniform", "round_robin", "stratified")


@dataclasses.dataclass(frozen=True)
class ParticipationSpec:
    """Which clients are device-resident per cloud interval; cohort_size=0
    (the default) disables sampling."""

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
