"""The federated runtime: spec, scenarios, runner, engines, transports,
failure models, sampled participation, the semi-synchronous deadline
scheduler."""
from repro_torch.fed import client_store, deadline, engine, failures, participation, runner, topology, transport
from repro_torch.fed import api, scenarios
from repro_torch.fed.api import ExperimentSpec
from repro_torch.fed.client_store import ClientStateStore
from repro_torch.fed.deadline import (
    EdgeCadenceModel,
    RoundPlan,
    SemiSyncScheduler,
    StalenessPolicy,
    parse_staleness,
)
from repro_torch.fed.engine import CohortEngine, DeadlineEngine, SuperRoundEngine
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
from repro_torch.fed.transport import (
    IdentityCodec,
    Int8BlockCodec,
    TransportSpec,
    int8_ef,
    parse_codec,
)
from repro_torch.fed.topology import (
    MeshFedPlan,
    edge_replica_groups,
    plan_for_hierarchy,
    plan_for_mesh,
    replica_groups,
)

__all__ = [
    "api",
    "client_store",
    "deadline",
    "engine",
    "failures",
    "participation",
    "runner",
    "scenarios",
    "topology",
    "transport",
    "ClientStateStore",
    "CohortEngine",
    "CohortSampler",
    "DeadlineEngine",
    "EdgeCadenceModel",
    "ExperimentSpec",
    "FailureSimulator",
    "FederatedRunner",
    "IdentityCodec",
    "Int8BlockCodec",
    "MaskComposition",
    "MeshFedPlan",
    "ParticipationSpec",
    "RoundPlan",
    "RoundRecord",
    "RoundRobinSampler",
    "RunnerConfig",
    "SemiSyncScheduler",
    "StalenessPolicy",
    "StragglerModel",
    "StratifiedSampler",
    "SubtreeOutageSimulator",
    "SuperRoundEngine",
    "TransportSpec",
    "UniformSampler",
    "build_sampler",
    "combine_masks",
    "compose_masks",
    "edge_replica_groups",
    "int8_ef",
    "parse_codec",
    "parse_staleness",
    "plan_for_hierarchy",
    "plan_for_mesh",
    "replica_groups",
]
