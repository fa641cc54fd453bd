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
from repro_torch.fed.topology import (
    MeshFedPlan,
    edge_replica_groups,
    plan_for_hierarchy,
    plan_for_mesh,
    replica_groups,
)

__all__ = [
    "ClientStateStore",
    "CohortEngine",
    "CohortSampler",
    "ExperimentSpec",
    "FailureSimulator",
    "FederatedRunner",
    "MaskComposition",
    "MeshFedPlan",
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
    "edge_replica_groups",
    "plan_for_hierarchy",
    "plan_for_mesh",
    "replica_groups",
]
