"""Named scenario registry: the paper's configurations as one-line lookups.

Port of ``repro.fed.scenarios`` for the scenarios this slice can run:

    from repro_torch.fed import scenarios
    runner, state = scenarios.get("quickstart").run_experiment()

Every entry is a factory returning a fresh ``ExperimentSpec`` with the
same fields as the JAX package's entry of that name. The JAX package's
other scenarios need features later slices bring; ``get`` of one of them
raises ``NotImplementedError`` naming the ROADMAP.md item.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

from repro_torch.errors import unported
from repro_torch.fed.api import (
    AggregatorSpec,
    CostSpec,
    DataSpec,
    ExperimentSpec,
    FailureSpec,
    ModelSpec,
    ParticipationSpec,
    RunSpec,
    ScheduleSpec,
    TopologySpec,
    TransportSpec,
)

_REGISTRY: Dict[str, Tuple[Callable[[], ExperimentSpec], str]] = {}

# JAX scenarios that need an unported feature: (what it needs, ROADMAP.md
# Queue 1 item that brings it)
_LATER = {
    "congested_backhaul": ("the round-replay simulator", 11),
    "hetero_clients_assoc": ("the round-replay simulator", 11),
    "straggler_tail": ("the round-replay simulator", 11),
    "deadline_straggler": ("the deadline engine", 11),
    "fedbuff_k4": ("the deadline engine", 11),
    "stale_decay": ("the deadline engine", 11),
}


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
        if name in _LATER:
            what, item = _LATER[name]
            raise unported(f"scenario {name!r} (needs {what})", item)
        raise ValueError(f"unknown scenario {name!r}; choose from {names()}")
    spec = _REGISTRY[name][0]()
    return spec.with_overrides(overrides) if overrides else spec


# The benchmark stand-in problem: 50 clients / 5 edges on the synthetic
# 10-class dataset; lr exponential 0.995/50.
_BENCH_MODEL = ModelSpec(lr=0.15, lr_schedule="exponential")


def _bench(name, *, kappas, partition, rounds, transport=None, aggregators=None) -> ExperimentSpec:
    return ExperimentSpec(
        name=name,
        topology=TopologySpec(num_edges=5, clients_per_edge=10),
        schedule=ScheduleSpec(kappas=kappas),
        data=DataSpec(partition=partition),
        model=_BENCH_MODEL,
        transport=transport or TransportSpec(),
        aggregators=aggregators or AggregatorSpec(),
        run=RunSpec(num_rounds=rounds),
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


__all__ = ["register", "get", "names"]
