"""The federated runtime: spec, scenarios, runner, engines, failure models,
sampled participation."""
from repro_torch.fed.api import ExperimentSpec
from repro_torch.fed.client_store import ClientStateStore
from repro_torch.fed.engine import CohortEngine, SuperRoundEngine
from repro_torch.fed.failures import (
    FailureSimulator,
    MaskComposition,
    StragglerModel,
    SubtreeOutageSimulator,
    combine_masks,
    compose_masks,
)
from repro_torch.fed.participation import (
    CohortSampler,
    ParticipationSpec,
    RoundRobinSampler,
    StratifiedSampler,
    UniformSampler,
    build_sampler,
)
from repro_torch.fed.runner import FederatedRunner, RoundRecord, RunnerConfig

__all__ = [
    "ClientStateStore",
    "CohortEngine",
    "CohortSampler",
    "ExperimentSpec",
    "FailureSimulator",
    "FederatedRunner",
    "MaskComposition",
    "ParticipationSpec",
    "RoundRecord",
    "RoundRobinSampler",
    "RunnerConfig",
    "StragglerModel",
    "StratifiedSampler",
    "SubtreeOutageSimulator",
    "SuperRoundEngine",
    "UniformSampler",
    "build_sampler",
    "combine_masks",
    "compose_masks",
]
