"""Named scenario registry: the paper's configurations as one-line lookups.

Port of ``repro.fed.scenarios``:

    from repro_torch.fed import scenarios
    runner, state = scenarios.get("quickstart").run_experiment()

Every entry is a factory returning a fresh ``ExperimentSpec`` with the
same fields as the JAX package's entry of that name.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

from repro_torch.fed.api import (
    AggregatorSpec,
    CostSpec,
    DataSpec,
    DeadlineSpec,
    ExperimentSpec,
    FailureSpec,
    ModelSpec,
    ParticipationSpec,
    RunSpec,
    ScheduleSpec,
    TopologySpec,
    TransportSpec,
)
from repro_torch.sim.distributions import NetworkSpec

_REGISTRY: Dict[str, Tuple[Callable[[], ExperimentSpec], str]] = {}


def register(name: str, description: str = ""):
    """Decorator: ``@register("my_scenario", "what it shows")`` on a
    zero-arg factory returning an ``ExperimentSpec``."""

    def wrap(fn: Callable[[], ExperimentSpec]):
        if name in _REGISTRY:
            raise ValueError(f"scenario {name!r} is already registered")
        _REGISTRY[name] = (fn, description or (fn.__doc__ or "").strip())
        return fn

    return wrap


def names() -> List[str]:
    return sorted(_REGISTRY)


def get(name: str, overrides: Sequence[str] = ()) -> ExperimentSpec:
    """A fresh spec for a registered scenario, with optional dotted-path
    overrides applied (``overrides=["run.num_rounds=8"]``)."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown scenario {name!r}; choose from {names()}")
    spec = _REGISTRY[name][0]()
    return spec.with_overrides(overrides) if overrides else spec


# The benchmark stand-in problem: 50 clients / 5 edges on the synthetic
# 10-class dataset; lr exponential 0.995/50.
_BENCH_MODEL = ModelSpec(lr=0.15, lr_schedule="exponential")


def _bench(name, *, kappas, partition, rounds, **sections) -> ExperimentSpec:
    """A 50-client / 5-edge benchmark spec; ``sections`` (``transport=``,
    ``aggregators=``, ``failures=``, ``deadline=``, ``network=``) replace
    the defaults. ``run.eval_every`` stays 1, as in the JAX package, so the
    deadline scenarios refuse to run until it is a multiple of a cloud
    interval (10 rounds)."""
    return ExperimentSpec(
        name=name,
        topology=TopologySpec(num_edges=5, clients_per_edge=10),
        schedule=ScheduleSpec(kappas=kappas),
        data=DataSpec(partition=partition),
        model=_BENCH_MODEL,
        run=RunSpec(num_rounds=rounds),
        **sections,
    )


@register("quickstart", "20 clients / 4 edges, edge-NIID, kappas=(4,2) — the README example")
def _quickstart() -> ExperimentSpec:
    return ExperimentSpec(
        name="quickstart",
        topology=TopologySpec(num_edges=4, clients_per_edge=5),
        schedule=ScheduleSpec(kappas=(4, 2)),
        data=DataSpec(partition="edge_niid", num_samples=2000),
        model=ModelSpec(lr=0.15),
        run=RunSpec(num_rounds=24, eval_every=4),
    )


@register("favg", "cloud-based FAVG baseline: kappa=(60,1), simple-NIID (paper Fig. 2)")
def _favg() -> ExperimentSpec:
    return _bench("favg", kappas=(60, 1), partition="simple_niid", rounds=10)


@register("hierfavg_iid", "HierFAVG kappas=(6,10) on IID client data (paper Fig. 4 anchor)")
def _hierfavg_iid() -> ExperimentSpec:
    return _bench("hierfavg_iid", kappas=(6, 10), partition="iid", rounds=40)


@register("hierfavg_edge_iid", "HierFAVG kappas=(6,10), edge-IID partition (paper Fig. 4a)")
def _hierfavg_edge_iid() -> ExperimentSpec:
    return _bench("hierfavg_edge_iid", kappas=(6, 10), partition="edge_iid", rounds=40)


@register("hierfavg_edge_niid", "HierFAVG kappas=(6,10), edge-NIID partition (paper Fig. 4b)")
def _hierfavg_edge_niid() -> ExperimentSpec:
    return _bench("hierfavg_edge_niid", kappas=(6, 10), partition="edge_niid", rounds=40)


@register("kappa_sweep_fast", "frequent cloud sync: kappas=(30,2) (paper Table II row)")
def _kappa_sweep_fast() -> ExperimentSpec:
    return _bench("kappa_sweep_fast", kappas=(30, 2), partition="edge_iid", rounds=12)


@register("edge_only", "one edge's 10 clients, no cloud hop — limited data access (paper Fig. 2)")
def _edge_only() -> ExperimentSpec:
    return ExperimentSpec(
        name="edge_only",
        topology=TopologySpec(num_edges=1, clients_per_edge=10),
        schedule=ScheduleSpec(kappas=(6, 1)),
        data=DataSpec(
            partition="simple_niid", class_sep=2.0,
            partition_topology="10,10,10,10,10/5",  # shard for 50, train the first 10
        ),
        model=_BENCH_MODEL,
        cost=CostSpec(workload="mnist", cloud_latency_mult=1.0),
        run=RunSpec(num_rounds=60),
    )


@register("int8_cloud", "int8 cloud hop (blockwise-absmax, Table IIc compressed-wire rows)")
def _int8_cloud() -> ExperimentSpec:
    return _bench(
        "int8_cloud", kappas=(6, 10), partition="edge_iid", rounds=40,
        transport=TransportSpec(levels="identity/int8:256"),
    )


@register("int8_ef_both", "error-feedback int8 on both hops (arXiv:2103.14272 compounding)")
def _int8_ef_both() -> ExperimentSpec:
    return _bench(
        "int8_ef_both", kappas=(6, 10), partition="edge_iid", rounds=40,
        transport=TransportSpec(levels="int8_ef:128/int8_ef:128"),
    )


@register("trimmed_edge", "robust edge sync: 10%-trimmed mean under client failures")
def _trimmed_edge() -> ExperimentSpec:
    # as in the JAX package, 5-client edges never trim at 0.1:
    # floor(0.1 * m) = 0 for m <= 9 survivors, so the edge sync is the
    # unweighted member mean
    return ExperimentSpec(
        name="trimmed_edge",
        topology=TopologySpec(num_edges=4, clients_per_edge=5),
        schedule=ScheduleSpec(kappas=(4, 2)),
        data=DataSpec(partition="edge_niid", num_samples=2000),
        model=ModelSpec(lr=0.15),
        aggregators=AggregatorSpec(levels="trimmed_mean:0.1/weighted_mean"),
        failures=FailureSpec(p_fail=0.05, p_recover=0.5),
        run=RunSpec(num_rounds=16, eval_every=4),
    )


@register("median_cloud", "coordinate-median cloud sync (Byzantine-robust top hop)")
def _median_cloud() -> ExperimentSpec:
    return _bench(
        "median_cloud", kappas=(6, 10), partition="edge_iid", rounds=40,
        aggregators=AggregatorSpec(levels="weighted_mean/coordinate_median"),
    )


@register("trimmed_int8", "robustness x compression: trimmed edge sync over an int8 cloud hop")
def _trimmed_int8() -> ExperimentSpec:
    return _bench(
        "trimmed_int8", kappas=(6, 10), partition="edge_iid", rounds=40,
        aggregators=AggregatorSpec(levels="trimmed_mean:0.1/weighted_mean"),
        transport=TransportSpec(levels="identity/int8:256"),
    )


@register("ragged_edges", "ragged 16/12/10/7/5-client edges, kappas=(6,10)")
def _ragged_edges() -> ExperimentSpec:
    return ExperimentSpec(
        name="ragged_edges",
        topology=TopologySpec(fanouts="16,12,10,7,5/5"),
        schedule=ScheduleSpec(kappas=(6, 10)),
        # simple_niid: edge_iid needs <= num_classes clients per edge (16 > 10)
        data=DataSpec(partition="simple_niid"),
        model=_BENCH_MODEL,
        run=RunSpec(num_rounds=40),
    )


@register("three_level", "client-edge-region-cloud tree, kappas=(6,5,2)")
def _three_level() -> ExperimentSpec:
    return ExperimentSpec(
        name="three_level",
        topology=TopologySpec(fanouts="10,10,10,10,10/3,2/2"),
        schedule=ScheduleSpec(kappas=(6, 5, 2)),
        data=DataSpec(partition="edge_iid"),
        model=_BENCH_MODEL,
        run=RunSpec(num_rounds=40),
    )


@register("lm_edge_niid", "decoder-only 10M LM, 8 clients / 2 edges, label-skewed corpus")
def _lm_edge_niid() -> ExperimentSpec:
    return ExperimentSpec(
        name="lm_edge_niid",
        topology=TopologySpec(num_edges=2, clients_per_edge=4),
        schedule=ScheduleSpec(kappas=(4, 2)),
        data=DataSpec(
            dataset="tokens", partition="edge_niid", num_samples=512,
            num_classes=8, classes_per_edge=4, seq_len=64, vocab=512,
        ),
        model=ModelSpec(
            arch="lm-10m", optimizer="adam", lr=3e-4,
            lr_schedule="warmup_cosine", warmup_steps=20,
        ),
        cost=CostSpec(workload="none"),
        run=RunSpec(num_rounds=24, eval_every=0),
    )


@register(
    "n1m_cohort4096",
    "1M virtual clients / 1000 edges, stratified 4096-client cohorts — "
    "population-scale streaming participation (device state ∝ cohort)",
)
def _n1m_cohort4096() -> ExperimentSpec:
    return ExperimentSpec(
        name="n1m_cohort4096",
        topology=TopologySpec(num_edges=1000, clients_per_edge=1000),
        schedule=ScheduleSpec(kappas=(4, 2)),
        data=DataSpec(
            partition="iid", num_samples=20000, batch_size=8,
            virtual_clients=1_000_000, samples_per_client=64,
        ),
        model=ModelSpec(lr=0.1),
        participation=ParticipationSpec(cohort_size=4096, sampler="stratified"),
        cost=CostSpec(workload="none"),
        run=RunSpec(num_rounds=8, eval_every=0),
    )


# ---------------------------------------------------------------------------
# Simulation scenarios (repro_torch.sim: ``sim.simulate_spec``)
# ---------------------------------------------------------------------------

@register(
    "congested_backhaul",
    "sim: 10% of edges on an 8x-slower backhaul + lognormal link jitter — "
    "p99 round time vs the analytic point estimate",
)
def _congested_backhaul() -> ExperimentSpec:
    return _bench(
        "congested_backhaul", kappas=(6, 10), partition="edge_iid", rounds=40,
        network=NetworkSpec(
            edge_backhaul="mixture:0.9@1,0.1@8",
            backhaul_jitter="lognormal:0.25",
            link_jitter="lognormal:0.15",
            seed=11,
        ),
    )


@register(
    "hetero_clients_assoc",
    "sim: heterogeneous client speeds + a congested uplink band with "
    "contention — the association-optimizer target (HFEL)",
)
def _hetero_clients_assoc() -> ExperimentSpec:
    return _bench(
        "hetero_clients_assoc", kappas=(6, 10), partition="edge_iid", rounds=40,
        network=NetworkSpec(
            client_speed="lognormal:0.35",
            edge_uplink="mixture:0.6@1,0.4@4",
            link_jitter="lognormal:0.2",
            contention=True,
            seed=3,
        ),
    )


@register(
    "straggler_tail",
    "sim: deadline-based straggler exclusion priced by the replay from the "
    "same StragglerModel distribution the runner masks with",
)
def _straggler_tail() -> ExperimentSpec:
    return _bench(
        "straggler_tail", kappas=(6, 10), partition="edge_iid", rounds=40,
        failures=FailureSpec(straggler_sigma=0.4, straggler_mean_s=1.0, seed=5),
        network=NetworkSpec(
            compute_jitter="lognormal:0.4", jitter_granularity="interval", seed=5
        ),
    )


# ---------------------------------------------------------------------------
# Semi-synchronous deadline scenarios (fed.deadline; docs/robustness.md)
# ---------------------------------------------------------------------------

@register(
    "deadline_straggler",
    "semi-sync: 60% quorum over the straggler tail's edge cadences with "
    "mid-round edge dropout — late edges carry, dead edges are reweighted",
)
def _deadline_straggler() -> ExperimentSpec:
    return _bench(
        "deadline_straggler", kappas=(6, 10), partition="edge_iid", rounds=40,
        failures=FailureSpec(straggler_sigma=0.4, straggler_mean_s=1.0, seed=5),
        deadline=DeadlineSpec(
            enabled=True, quorum=0.6, max_staleness=3,
            staleness="poly:0.5", edge_drop_rate=0.05, retry_limit=1, seed=5,
        ),
    )


@register(
    "fedbuff_k4",
    "semi-sync: FedBuff-style buffered aggregation — the cloud folds the "
    "first K=4 edge arrivals per round under heterogeneous edge speeds",
)
def _fedbuff_k4() -> ExperimentSpec:
    return _bench(
        "fedbuff_k4", kappas=(6, 10), partition="edge_iid", rounds=40,
        deadline=DeadlineSpec(
            enabled=True, buffer_size=4, max_staleness=3,
            staleness="poly:0.5", edge_speed="lognormal:0.5", seed=7,
        ),
    )


@register(
    "stale_decay",
    "semi-sync: 80% quorum with exponential staleness decay exp:0.7 — "
    "stragglers' carried updates fold at geometrically shrinking weight",
)
def _stale_decay() -> ExperimentSpec:
    return _bench(
        "stale_decay", kappas=(6, 10), partition="edge_iid", rounds=40,
        deadline=DeadlineSpec(
            enabled=True, quorum=0.8, max_staleness=4,
            staleness="exp:0.7", edge_speed="lognormal:0.4", seed=9,
        ),
    )


__all__ = ["register", "get", "names"]
