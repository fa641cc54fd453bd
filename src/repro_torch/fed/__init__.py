"""The federated runtime: spec, scenarios, runner, engine, failure models."""
from repro_torch.fed.api import ExperimentSpec
from repro_torch.fed.failures import (
    FailureSimulator,
    MaskComposition,
    StragglerModel,
    SubtreeOutageSimulator,
    combine_masks,
    compose_masks,
)
from repro_torch.fed.runner import FederatedRunner, RoundRecord, RunnerConfig

__all__ = [
    "ExperimentSpec",
    "FailureSimulator",
    "FederatedRunner",
    "MaskComposition",
    "RoundRecord",
    "RunnerConfig",
    "StragglerModel",
    "SubtreeOutageSimulator",
    "combine_masks",
    "compose_masks",
]
