"""repro_torch.sim — trace-driven discrete-event replay of the
client-edge-cloud system: a copy-port of ``repro.sim`` (host numpy, no
torch), bit-identical to it.

The analytic cost model prices one round with identical clients; this
package replays the round's dependency DAG under per-client / per-edge
cost *distributions* to answer production questions — p99 round time,
energy CDFs, congested-backhaul what-ifs — and optimizes the client→edge
association on top (HFEL, arXiv 2002.11343). See docs/simulation.md.

    dag            the per-cloud-interval dependency DAG
    distributions  seeded, checkpointable cost distributions + NetworkSpec
    calibrate      node costs from WorkloadCosts / ClusterCosts / roofline terms
    replay         event-queue replay -> time & energy distributions
    association    greedy + local-search client→edge optimizer

Zero-variance contract: with every distribution ``det`` the replay equals
``cloud_interval_time`` / ``cloud_interval_energy`` to machine precision.
"""
from repro_torch.sim.association import (
    AssociationResult,
    assignment_to_spec,
    optimize_association,
)
from repro_torch.sim.calibrate import (
    SimCosts,
    from_cluster,
    from_roofline,
    from_workload,
    straggler_masks,
    straggler_network,
)
from repro_torch.sim.dag import AGG, HOP, STEP, RoundDag, build_round_dag
from repro_torch.sim.distributions import (
    DeterministicDist,
    Distribution,
    LogNormalDist,
    MixtureDist,
    NetworkModel,
    NetworkSpec,
    parse_distribution,
)
from repro_torch.sim.replay import (
    JitterTables,
    ReplayResult,
    assemble_durations,
    draw_jitter_tables,
    replay_once,
    simulate_round,
    simulate_spec,
    sweep,
)

__all__ = [
    "AGG",
    "HOP",
    "STEP",
    "AssociationResult",
    "DeterministicDist",
    "Distribution",
    "JitterTables",
    "LogNormalDist",
    "MixtureDist",
    "NetworkModel",
    "NetworkSpec",
    "ReplayResult",
    "RoundDag",
    "SimCosts",
    "assignment_to_spec",
    "assemble_durations",
    "build_round_dag",
    "draw_jitter_tables",
    "from_cluster",
    "from_roofline",
    "from_workload",
    "optimize_association",
    "parse_distribution",
    "replay_once",
    "simulate_round",
    "simulate_spec",
    "straggler_masks",
    "straggler_network",
    "sweep",
]
