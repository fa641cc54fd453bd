"""The federated runtime: spec, scenarios, runner, engine."""
from repro_torch.fed.api import ExperimentSpec
from repro_torch.fed.runner import FederatedRunner, RoundRecord, RunnerConfig

__all__ = ["ExperimentSpec", "FederatedRunner", "RoundRecord", "RunnerConfig"]
