"""Declarative experiment construction: the ``ExperimentSpec`` tree.

Port of ``repro.fed.api``. The dataclass tree has the same sections,
field names and defaults, so a spec round-trips between the packages
(``repro_torch...ExperimentSpec.from_json(jax_spec.to_json())``), and it
takes the same dotted-path overrides
(``spec.with_overrides(["schedule.kappas=4,2", "run.num_rounds=12"])``).

    topology     FedTopology or ragged tree (``fanouts`` grammar)
    schedule     the kappa vector + sync flags
    data         synthetic dataset + partition protocol + batching
    model        architecture + optimizer + LR schedule
    precision    client state dtype + remat
    transport    per-level link codecs
    aggregators  per-level aggregation statistic
    participation  sampled cohorts
    failures     failure / straggler injection
    deadline     semi-synchronous cloud rounds
    cost         the paper's T/E cost model workload
    network      replay-simulator distributions (inert for training)
    run          rounds, cadences, engine, seeds

``build(device=...)`` assembles the ``FederatedRunner``;
``run_experiment(device=...)`` builds, initializes and trains. Both run on
``cuda`` unless given ``device``, and raise without a GPU. A spec that
needs a feature the port does not have yet (a device mesh) raises
``NotImplementedError`` naming the ROADMAP.md item that brings it.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hierfavg import PrecisionSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.errors import unported
from repro_torch.fed.participation import ParticipationSpec
from repro_torch.sim.distributions import NetworkSpec

_MISSING = dataclasses.MISSING


# ---------------------------------------------------------------------------
# Spec sections
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """The aggregation tree. ``fanouts`` (``core.hierarchy.parse_fanouts``
    grammar, e.g. ``"16,12,10,7,5/5"``) wins when set; otherwise the uniform
    two-level ``num_edges`` x ``clients_per_edge``. ``mesh_axes`` (client
    sharding over devices) comes with the multi-device slice."""

    fanouts: str = ""
    num_edges: int = 5
    clients_per_edge: int = 10
    mesh_axes: str = ""

    def build(self):
        from repro_torch.core.hierarchy import parse_fanouts
        from repro_torch.core.hierfavg import FedTopology

        if self.fanouts:
            return parse_fanouts(self.fanouts)
        return FedTopology(num_edges=self.num_edges, clients_per_edge=self.clients_per_edge)

    @property
    def depth(self) -> int:
        from repro_torch.core.hierarchy import as_hierarchy

        return as_hierarchy(self.build()).depth


@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """The kappa vector: ``kappas[0]`` local steps per edge aggregation,
    ``kappas[l]`` level-l intervals per level-(l+1) aggregation."""

    kappas: Tuple[int, ...] = (6, 10)
    sync_opt_state: bool = False
    delta_cloud: bool = False
    async_cloud: bool = False  # deprecated: maps to the deadline engine (build)


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """Synthetic dataset + partition protocol (Section IV-A)."""

    dataset: str = "gaussians"  # gaussians | tokens
    partition: str = "edge_iid"  # iid | simple_niid | edge_iid | edge_niid
    num_samples: int = 3000
    dim: int = 16
    num_classes: int = 10
    class_sep: float = 3.5
    batch_size: int = 8
    seed: int = 0
    classes_per_edge: int = 0  # edge_niid skew override (0 = the C/2 rule)
    partition_topology: str = ""  # partition as if this tree (fanouts grammar)
    seq_len: int = 64  # tokens only
    vocab: int = 512  # tokens only
    concentration: float = 0.2  # tokens only
    virtual_clients: int = 0  # 0 = materialized partition (the default)
    samples_per_client: int = 64  # virtual shard size (>= batch_size)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Architecture + optimizer. ``arch="mlp"`` is the benchmark classifier
    (``dim -> hidden -> num_classes``)."""

    arch: str = "mlp"  # mlp | lm-10m | lm-100m
    hidden: int = 48
    optimizer: str = "sgd"  # sgd | adam
    lr: float = 0.15
    lr_schedule: str = "constant"  # constant | exponential | warmup_cosine
    decay_rate: float = 0.995
    decay_steps: int = 50
    warmup_steps: int = 20


def _levels(text: str, default: str) -> list:
    return [p for p in (text.strip() or default).split("/") if p]


def _parse_levels(text: str, depth: int, parse_one, field: str, default: str) -> tuple:
    """'/'-separated per-level grammar: a single entry replicates to every
    level; otherwise the count must match the schedule depth. Errors name
    the spec field."""
    parts = _levels(text, default)
    if len(parts) == 1:
        parts = parts * depth
    if len(parts) != depth:
        raise ValueError(
            f"{field}={text!r} names {len(parts)} levels but the schedule has "
            f"{depth}; give one entry per level ('/'-separated) or one entry "
            f"for all levels"
        )
    try:
        return tuple(parse_one(p) for p in parts)
    except ValueError as e:
        raise ValueError(f"{field}: {e}") from None


@dataclasses.dataclass(frozen=True)
class TransportSpec:
    """Per-level link codecs, bottom-up, in the ``fed.transport`` grammar:
    ``"identity/int8_ef:128"`` is an fp32 edge hop and an error-feedback
    int8 cloud hop. A single codec (no ``/``) applies to every level."""

    levels: str = "identity"

    def build(self, depth: int):
        """The ``fed.transport.TransportSpec``, or None for an all-identity
        transport (the uncompressed protocol)."""
        from repro_torch.fed import transport as transport_lib

        codecs = _parse_levels(self.levels, depth, transport_lib.parse_codec, "transport.levels", "identity")
        spec = transport_lib.TransportSpec(codecs=codecs)
        return None if spec.is_trivial else spec


@dataclasses.dataclass(frozen=True)
class AggregatorSpec:
    """Per-level aggregation statistic, bottom-up, in the
    ``core.aggregation`` grammar: ``"trimmed_mean:0.1/weighted_mean"`` trims
    at the edge sync and keeps the paper's weighted mean at the cloud. A
    single name applies to every level."""

    levels: str = "weighted_mean"

    def build(self, depth: int):
        """The ``core.aggregation.AggregatorSpec``, or None when every
        level is the weighted mean."""
        from repro_torch.core import aggregation

        aggs = _parse_levels(self.levels, depth, aggregation.parse_aggregator, "aggregators.levels", "weighted_mean")
        spec = aggregation.AggregatorSpec(aggregators=aggs)
        return None if spec.is_trivial else spec


@dataclasses.dataclass(frozen=True)
class FailureSpec:
    """Host-side failure / straggler injection (``fed.failures``)."""

    p_fail: float = 0.0  # per-boundary P(alive -> dead); 0 = no failures
    p_recover: float = 0.5
    straggler_sigma: float = 0.0  # lognormal step-latency sigma; 0 = off
    straggler_mean_s: float = 1.0
    seed: int = 1

    def build(self, num_clients: int):
        """(FailureSimulator or None, StragglerModel or None)."""
        from repro_torch.fed.failures import FailureSimulator, StragglerModel

        failures = stragglers = None
        if self.p_fail > 0:
            failures = FailureSimulator(num_clients, p_fail=self.p_fail, p_recover=self.p_recover, seed=self.seed)
        if self.straggler_sigma > 0:
            stragglers = StragglerModel(
                num_clients, mean_step_s=self.straggler_mean_s, sigma=self.straggler_sigma, seed=self.seed
            )
        return failures, stragglers


@dataclasses.dataclass(frozen=True)
class DeadlineSpec:
    """Semi-synchronous cloud rounds (``fed.deadline``): edges run their
    cloud intervals at their own cadence; the cloud closes a round at a
    deadline or quorum and folds whatever arrived, staleness-decayed. Late
    edges carry their upload into the next round instead of dropping it.

    ``quorum=1.0`` with ``timeout_s=0`` is the full barrier: under uniform
    cadences it is the synchronous engine bit for bit. ``buffer_size=K``
    (FedBuff) replaces the fractional quorum by an arrival count.
    ``staleness`` is ``fed.deadline.parse_staleness``'s grammar:
    ``constant | poly:A | exp:A``.

    Edge cadences: ``mean_interval_s`` sets the base edge-interval seconds;
    at 0 they come from the straggler model (per-edge max client slowness x
    kappa1 x mean step time) if there is one, else from the cost model's
    ``kappa1 * t_comp + t_comm_edge``, else 1 s x kappa1. ``edge_speed`` /
    ``edge_jitter`` are ``sim.distributions`` grammars for the per-edge
    slowness (drawn once) and the per-round jitter."""

    enabled: bool = False
    timeout_s: float = 0.0  # 0 = no deadline (pure quorum or barrier)
    quorum: float = 1.0  # fraction of live edges that closes the round
    buffer_size: int = 0  # absolute arrival count (FedBuff K); 0 = use quorum
    max_staleness: int = 2  # force-wait bound on an edge's missed rounds
    staleness: str = "constant"  # constant | poly:A | exp:A
    edge_drop_rate: float = 0.0  # P(an arrived upload is lost mid-round)
    retry_limit: int = 1  # bounded re-upload attempts for dropped edges
    edge_speed: str = "det"  # per-edge slowness distribution (drawn once)
    edge_jitter: str = "det"  # per-round interval jitter distribution
    mean_interval_s: float = 0.0  # 0 = derive from stragglers / costs
    seed: int = 0

    def build_scheduler(self, *, topology, kappa1: int, kappa2: int, stragglers=None, costs=None):
        """The configured ``fed.deadline.SemiSyncScheduler`` over this
        spec's cadence model (None when disabled)."""
        if not self.enabled:
            return None
        from repro_torch.core.hierarchy import as_hierarchy
        from repro_torch.fed.deadline import EdgeCadenceModel, SemiSyncScheduler

        spec = as_hierarchy(topology)
        num_edges = spec.num_nodes(spec.depth - 1) if spec.depth >= 2 else 1
        if stragglers is not None and self.mean_interval_s <= 0:
            segments = (
                np.asarray(spec.segments(spec.depth - 1)) if spec.depth >= 2 else np.zeros(spec.num_clients, np.int64)
            )
            cadence = EdgeCadenceModel.from_stragglers(
                stragglers, segments, num_edges, kappa1, jitter=self.edge_jitter, seed=self.seed)
        else:
            if self.mean_interval_s > 0:
                base = self.mean_interval_s
            elif costs is not None:
                base = kappa1 * costs.t_comp + costs.t_comm_edge
            else:
                base = float(kappa1)
            cadence = EdgeCadenceModel(num_edges, base, speed=self.edge_speed, jitter=self.edge_jitter, seed=self.seed)
        return SemiSyncScheduler(
            cadence,
            intervals_per_round=kappa2,
            quorum=self.quorum,
            timeout_s=self.timeout_s,
            buffer_size=self.buffer_size,
            max_staleness=self.max_staleness,
            staleness=self.staleness,
            edge_drop_rate=self.edge_drop_rate,
            retry_limit=self.retry_limit,
            seed=self.seed,
        )


@dataclasses.dataclass(frozen=True)
class CostSpec:
    """The paper's T/E accounting (``core.cost_model``). ``workload="none"``
    disables it; ``cloud_latency_mult`` overrides the Table I 10x cloud hop
    when positive."""

    workload: str = "mnist"  # mnist | cifar10 | none
    cloud_latency_mult: float = 0.0  # 0 = workload default

    def build(self):
        from repro_torch.core import cost_model as cm

        if self.workload == "none":
            return None
        costs = cm.paper_workload(self.workload)
        if self.cloud_latency_mult > 0:
            costs = dataclasses.replace(costs, cloud_latency_mult=self.cloud_latency_mult)
        return costs


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """Loop shape: rounds, cadences, engine, checkpointing, and the seed
    (``seed`` seeds the state's generator, ``seed + 1`` the model init)."""

    num_rounds: int = 40
    eval_every: int = 1
    checkpoint_every: int = 0
    checkpoint_dir: str = ""
    target_accuracy: float = 0.0
    engine: str = "auto"  # auto | superround | megakernel | per_round
    seed: int = 0


# ---------------------------------------------------------------------------
# The experiment spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One point of the paper's design space as a serializable value."""

    name: str = "experiment"
    topology: TopologySpec = dataclasses.field(default_factory=TopologySpec)
    schedule: ScheduleSpec = dataclasses.field(default_factory=ScheduleSpec)
    data: DataSpec = dataclasses.field(default_factory=DataSpec)
    model: ModelSpec = dataclasses.field(default_factory=ModelSpec)
    precision: PrecisionSpec = dataclasses.field(default_factory=PrecisionSpec)
    transport: TransportSpec = dataclasses.field(default_factory=TransportSpec)
    aggregators: AggregatorSpec = dataclasses.field(default_factory=AggregatorSpec)
    participation: ParticipationSpec = dataclasses.field(default_factory=ParticipationSpec)
    failures: FailureSpec = dataclasses.field(default_factory=FailureSpec)
    deadline: DeadlineSpec = dataclasses.field(default_factory=DeadlineSpec)
    cost: CostSpec = dataclasses.field(default_factory=CostSpec)
    network: NetworkSpec = dataclasses.field(default_factory=NetworkSpec)
    run: RunSpec = dataclasses.field(default_factory=RunSpec)

    def __post_init__(self):
        for f in dataclasses.fields(self):
            default = _field_default(f)
            if dataclasses.is_dataclass(default) and not isinstance(getattr(self, f.name), type(default)):
                raise TypeError(
                    f"ExperimentSpec.{f.name} must be a fed.api.{type(default).__name__} "
                    f"(the serializable spec form), got {type(getattr(self, f.name)).__name__}"
                )

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return _jsonable(dataclasses.asdict(self))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentSpec":
        return _from_dict(cls, d, prefix="")

    def to_json(self, *, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(text))

    # -- dotted-path overrides ----------------------------------------------

    def with_overrides(self, assignments: Sequence[str]) -> "ExperimentSpec":
        """Apply ``"dotted.path=value"`` assignments. Unknown paths and
        malformed values raise ``ValueError`` naming the path."""
        spec = self
        for a in assignments:
            path, eq, text = a.partition("=")
            if not eq:
                raise ValueError(
                    f"override {a!r} must look like 'dotted.path=value' (e.g. schedule.kappas=4,2)"
                )
            spec = _apply_override(spec, path.strip().split("."), text.strip(), path.strip())
        return spec

    @classmethod
    def parse(cls, overrides: Sequence[str] = (), *, base: Optional["ExperimentSpec"] = None) -> "ExperimentSpec":
        return (base if base is not None else cls()).with_overrides(overrides)

    # -- assembly -----------------------------------------------------------

    def hier_config(self, *, _depth: Optional[int] = None):
        """The ``HierFAVGConfig`` this spec describes."""
        from repro_torch.core.hierfavg import HierFAVGConfig

        depth = self.topology.depth if _depth is None else _depth
        if len(self.schedule.kappas) != depth:
            raise ValueError(
                f"schedule.kappas={self.schedule.kappas} has {len(self.schedule.kappas)} "
                f"levels but the topology tree has depth {depth}; set schedule.kappas "
                f"to one interval per level"
            )
        return HierFAVGConfig.multi_level(
            self.schedule.kappas,
            sync_opt_state=self.schedule.sync_opt_state,
            delta_cloud=self.schedule.delta_cloud,
            transport=self.transport.build(depth),
            aggregators=self.aggregators.build(depth),
            participation=self.participation if self.participation.is_active else None,
            precision=self.precision if self.precision.is_active else None,
        )

    def _check_ported(self) -> None:
        """Raise for run-level features this slice does not port."""
        if self.topology.mesh_axes:
            raise unported(f"topology.mesh_axes={self.topology.mesh_axes!r}", 12)

    def model_bundle(self, device: DeviceLike = None) -> Dict[str, Any]:
        """{"module", "init", "apply", "loss"} for this spec's model."""
        return _model_bundle(self, resolve_device(device))

    def init_params(self, seed: int, device: DeviceLike = None):
        """Initial (unstacked) model parameters from a torch generator
        seeded with ``seed`` (not the JAX init's numbers)."""
        return self.model_bundle(device)["init"](seed)

    def params_from_numpy(self, np_params, device: DeviceLike = None):
        """A JAX init carried across (``jax.device_get(spec.init_params(key))``),
        checked against this spec's model (names, shapes, dtypes)."""
        from repro_torch.models import params_from_numpy

        device = resolve_device(device)
        return params_from_numpy(np_params, device, like=self.model_bundle(device)["like"]())

    def build(self, *, device: DeviceLike = None):
        """Assemble the ``FederatedRunner`` on ``device`` (default ``cuda``)."""
        from repro_torch.core.hierarchy import as_hierarchy
        from repro_torch.fed.runner import FederatedRunner, RunnerConfig

        device = resolve_device(device)
        self._check_ported()
        topo = self.topology.build()
        tree = as_hierarchy(topo)
        hier = self.hier_config(_depth=tree.depth)
        bundle = _model_bundle(self, device)
        batcher, eval_fn = _build_data(self, topo, bundle, device)
        failures, stragglers = self.failures.build(tree.num_clients)
        costs = self.cost.build()
        deadline_spec = self.deadline
        if self.schedule.async_cloud and not deadline_spec.enabled:
            import warnings

            warnings.warn(
                "schedule.async_cloud is deprecated: the staleness-1 async "
                "lowering was retired. Routing to the semi-synchronous "
                "deadline engine (quorum=0.5, poly:1 staleness decay) — the "
                "cloud folds whatever arrived and late edges carry their "
                "upload forward, matching the old semantics in kind, not "
                "bit-for-bit. Under uniform edge cadences every edge arrives "
                "together, so this reduces to the synchronous engine "
                "exactly. Configure the deadline.* section directly instead.",
                DeprecationWarning,
                stacklevel=2,
            )
            deadline_spec = dataclasses.replace(deadline_spec, enabled=True, quorum=0.5, staleness="poly:1.0")
        deadline = deadline_spec.build_scheduler(
            topology=topo, kappa1=hier.kappa1, kappa2=hier.kappa2_effective, stragglers=stragglers, costs=costs)
        checkpointer = None
        if self.run.checkpoint_dir:
            from repro_torch.checkpoint import CheckpointManager

            checkpointer = CheckpointManager(self.run.checkpoint_dir, keep=2)
        runner = FederatedRunner(
            loss_fn=bundle["loss"],
            optimizer=_build_optimizer(self.model, self.run.num_rounds * hier.kappa1),
            topology=topo,
            hier_config=hier,
            data_sizes=batcher.data_sizes,
            batcher=batcher,
            runner_config=RunnerConfig(
                num_rounds=self.run.num_rounds,
                eval_every=self.run.eval_every,
                checkpoint_every=self.run.checkpoint_every,
                target_accuracy=self.run.target_accuracy,
                engine=self.run.engine,
            ),
            eval_fn=eval_fn,
            costs=costs,
            failures=failures,
            stragglers=stragglers,
            deadline=deadline,
            checkpointer=checkpointer,
            device=device,
        )
        runner.spec = self  # provenance: the runner knows its declarative form
        return runner

    def run_experiment(self, *, device: DeviceLike = None, params=None, resume: bool = False):
        """Build, initialize, and train: returns ``(runner, final_state)``.
        ``params`` (unstacked) replaces the spec's own init, e.g. a JAX init
        carried across with ``params_from_numpy``. ``resume=True`` restores
        the latest checkpoint of ``run.checkpoint_dir`` when one exists."""
        device = resolve_device(device)
        runner = self.build(device=device)
        if params is None:
            params = self.init_params(self.run.seed + 1, device)
        rng = torch.Generator(device=device).manual_seed(self.run.seed)
        if resume:
            if runner.checkpointer is None:
                raise ValueError(
                    "run_experiment(resume=True) needs run.checkpoint_dir set on "
                    "the spec — without a checkpointer there is nothing to resume from"
                )
            state, start = runner.restore_or_init(rng, params)
        else:
            state, start = runner.init(rng, params), 0
        state = runner.run(state, start_round=start)
        return runner, state

    def describe(self) -> str:
        topo = self.topology.fanouts or f"{self.topology.num_edges}x{self.topology.clients_per_edge}"
        extras = []
        if self.transport.levels != "identity":
            extras.append(f"transport={self.transport.levels}")
        if self.aggregators.levels != "weighted_mean":
            extras.append(f"agg={self.aggregators.levels}")
        if self.participation.is_active:
            extras.append(f"cohort={self.participation.cohort_size}/{self.participation.sampler}")
        if self.precision.is_active:
            extras.append(f"precision={self.precision.param_dtype}" + ("+remat" if self.precision.remat else ""))
        if self.failures.p_fail > 0:
            extras.append(f"p_fail={self.failures.p_fail:g}")
        if self.deadline.enabled:
            gate = (
                f"buffer={self.deadline.buffer_size}" if self.deadline.buffer_size
                else f"quorum={self.deadline.quorum:g}"
            )
            extras.append(f"deadline[{gate},{self.deadline.staleness}]")
        tail = (" " + " ".join(extras)) if extras else ""
        return (
            f"{self.name}: {topo} kappas={','.join(map(str, self.schedule.kappas))} "
            f"{self.data.partition} {self.model.arch} rounds={self.run.num_rounds}{tail}"
        )


# ---------------------------------------------------------------------------
# Serialization helpers
# ---------------------------------------------------------------------------


def _jsonable(v):
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


def _field_default(f: dataclasses.Field):
    if f.default is not _MISSING:
        return f.default
    return f.default_factory()  # every section field has a factory


def _from_dict(cls, d, prefix: str):
    if not isinstance(d, dict):
        raise ValueError(f"spec section {prefix[:-1] or 'root'!r} must be a dict, got {type(d).__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - set(fields))
    if unknown:
        raise ValueError(
            f"unknown spec key {prefix + unknown[0]!r}; valid keys under "
            f"{prefix[:-1] or 'the spec root'!r}: {sorted(fields)}"
        )
    kwargs = {}
    for name, f in fields.items():
        if name not in d:
            continue
        default = _field_default(f)
        v = d[name]
        if dataclasses.is_dataclass(default):
            kwargs[name] = _from_dict(type(default), v, prefix=f"{prefix}{name}.")
        elif isinstance(default, tuple):
            if not isinstance(v, (list, tuple)):
                raise ValueError(
                    f"spec key {prefix + name!r} expects a list of integers, got {type(v).__name__} {v!r}"
                )
            kwargs[name] = tuple(int(x) for x in v)
        else:
            kwargs[name] = v
    return cls(**kwargs)


def _coerce(text: str, current, path: str):
    """Parse an override value by the type of the field's current value."""
    if isinstance(current, bool):
        low = text.lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"{path!r} expects a boolean (true/false), got {text!r}")
    if isinstance(current, tuple):
        try:
            return tuple(int(x) for x in text.replace("/", ",").split(",") if x)
        except ValueError:
            raise ValueError(f"{path!r} expects comma-separated integers (e.g. 4,2), got {text!r}") from None
    if isinstance(current, int):
        try:
            return int(text)
        except ValueError:
            raise ValueError(f"{path!r} expects an integer, got {text!r}") from None
    if isinstance(current, float):
        try:
            return float(text)
        except ValueError:
            raise ValueError(f"{path!r} expects a number, got {text!r}") from None
    return text


def _apply_override(obj, parts, text: str, full_path: str):
    fields = {f.name: f for f in dataclasses.fields(obj)}
    name = parts[0]
    if name not in fields:
        raise ValueError(
            f"unknown spec path {full_path!r}: {type(obj).__name__} has no field "
            f"{name!r}; valid fields: {sorted(fields)}"
        )
    current = getattr(obj, name)
    if len(parts) == 1:
        if dataclasses.is_dataclass(current):
            raise ValueError(
                f"{full_path!r} is a spec section ({type(current).__name__}), not a value; "
                f"set one of its fields: {sorted(f.name for f in dataclasses.fields(current))}"
            )
        return dataclasses.replace(obj, **{name: _coerce(text, current, full_path)})
    if not dataclasses.is_dataclass(current):
        raise ValueError(f"cannot descend into {full_path!r}: field {name!r} is a plain value, not a section")
    return dataclasses.replace(obj, **{name: _apply_override(current, parts[1:], text, full_path)})


# ---------------------------------------------------------------------------
# Build helpers
# ---------------------------------------------------------------------------


_LM_PRESETS = ("lm-10m", "lm-100m")


def _lm_config(spec: ExperimentSpec):
    """lm-100m (``configs.paper.LM_100M``) or its 4-layer, 256-wide cut
    lm-10m, with the vocabulary of ``data.vocab``, as JAX's ``_lm_config``
    (``repro/fed/api.py:736-746``)."""
    from repro_torch.configs.paper import LM_100M

    if spec.model.arch == "lm-10m":
        cfg = dataclasses.replace(
            LM_100M, name="lm-10m", num_layers=4, d_model=256, num_heads=8, num_kv_heads=4, d_ff=768,
        )
    else:
        cfg = LM_100M
    return dataclasses.replace(cfg, vocab_size=spec.data.vocab)


def _model_bundle(spec: ExperimentSpec, device: torch.device) -> Dict[str, Any]:
    """{"init", "loss", "apply" (None for an LM), "like"} for the spec's
    architecture. ``init`` takes a seed; ``like()`` is a tree of the model's
    names, shapes and dtypes that ``params_from_numpy`` checks against."""
    arch = spec.model.arch
    if arch == "mlp":
        from repro_torch.models.cnn import mlp_bundle

        bundle = mlp_bundle(spec.data.dim, spec.model.hidden, spec.data.num_classes, device)
        return {**bundle, "like": lambda: dict(bundle["module"].named_parameters())}
    if arch in _LM_PRESETS:
        from repro_torch.models import transformer

        cfg = _lm_config(spec)

        def init(seed: int):
            with torch.no_grad():
                return transformer.init_params(torch.Generator(device=device).manual_seed(int(seed)), cfg)

        return {"init": init, "apply": None, "loss": transformer.make_loss_fn(cfg), "like": lambda: init(0)}
    raise ValueError(f"model.arch must be one of ('mlp',) + {_LM_PRESETS}, got {arch!r}")


def _build_optimizer(model: ModelSpec, total_steps: int):
    """The optimizer with its schedule; ``total_steps`` (run.num_rounds x
    kappa1 local steps) is what ``warmup_cosine`` decays over."""
    from repro_torch.optim import adam, exponential_decay, sgd, warmup_cosine

    if model.lr_schedule == "constant":
        lr = model.lr
    elif model.lr_schedule == "exponential":
        lr = exponential_decay(model.lr, model.decay_rate, model.decay_steps)
    elif model.lr_schedule == "warmup_cosine":
        lr = warmup_cosine(model.lr, model.warmup_steps, total_steps)
    else:
        raise ValueError(f"model.lr_schedule must be constant|exponential|warmup_cosine, got {model.lr_schedule!r}")
    if model.optimizer == "sgd":
        return sgd(lr)
    if model.optimizer == "adam":
        return adam(lr)
    raise ValueError(f"model.optimizer must be sgd|adam, got {model.optimizer!r}")


def _build_data(spec: ExperimentSpec, topo, bundle, device: torch.device):
    """(batcher, eval_fn). RNG order matches the JAX package exactly
    (dataset draw, then partition, both from ``default_rng(data.seed)``), so
    the two packages train on the same batches."""
    from repro_torch.core.hierarchy import as_hierarchy, parse_fanouts
    from repro_torch.data import (
        FederatedBatcher,
        VirtualClientBatcher,
        clustered_gaussians,
        partition_hierarchy,
        token_corpus,
    )
    from repro_torch.models.cnn import accuracy

    d = spec.data
    if d.dataset not in ("gaussians", "tokens"):
        raise ValueError(f"data.dataset must be gaussians|tokens, got {d.dataset!r}")
    if d.dataset == "gaussians" and bundle["apply"] is None:
        raise ValueError(
            f"model.arch={spec.model.arch!r} is a language model and needs "
            f"data.dataset=tokens (got {d.dataset!r})"
        )
    if d.dataset == "tokens" and spec.model.arch not in _LM_PRESETS:
        raise ValueError(
            f"data.dataset=tokens needs a language model, got "
            f"model.arch={spec.model.arch!r}; choose one of {_LM_PRESETS}"
        )
    rng = np.random.default_rng(d.seed)
    pspec = parse_fanouts(d.partition_topology) if d.partition_topology else as_hierarchy(topo)
    n = as_hierarchy(topo).num_clients
    if pspec.num_clients < n:
        raise ValueError(
            f"data.partition_topology={d.partition_topology!r} has "
            f"{pspec.num_clients} clients but the training topology needs {n}"
        )
    kw = {}
    if d.partition == "edge_niid" and d.classes_per_edge:
        kw["classes_per_edge"] = d.classes_per_edge
    if d.dataset == "tokens":
        corp = token_corpus(
            rng, num_sequences=d.num_samples, seq_len=d.seq_len, vocab=d.vocab,
            num_classes=d.num_classes, concentration=d.concentration,
        )
        parts = partition_hierarchy(d.partition, corp.labels, pspec, rng, **kw)[:n]
        batcher = FederatedBatcher(
            {"tokens": corp.tokens}, parts, batch_size=d.batch_size, seed=d.seed,
            batch_fn=lambda b: {"inputs": b["tokens"][..., :-1], "targets": b["tokens"][..., 1:]},
        )
        return batcher, None
    data = clustered_gaussians(
        rng, num_samples=d.num_samples, num_classes=d.num_classes, dim=(d.dim,), class_sep=d.class_sep
    )
    if d.virtual_clients:
        # population mode: no partition is drawn; a client's shard is a
        # function of (seed, client id), realized when it is sampled
        if d.virtual_clients != n:
            raise ValueError(
                f"data.virtual_clients={d.virtual_clients} must equal the "
                f"topology's {n} clients (the population IS the client set)"
            )
        batcher = VirtualClientBatcher(
            {"inputs": data.x, "targets": data.y}, num_clients=n, samples_per_client=d.samples_per_client,
            batch_size=d.batch_size, seed=d.seed,
        )
    else:
        parts = partition_hierarchy(d.partition, data.y, pspec, rng, **kw)[:n]
        batcher = FederatedBatcher(
            {"inputs": data.x, "targets": data.y}, parts, batch_size=d.batch_size, seed=d.seed)
    # the eval scores the cloud model on the whole pool, in population mode too
    apply_fn = bundle["apply"]
    x_all = torch.from_numpy(data.x).to(device)
    y_all = torch.from_numpy(data.y).to(device)

    def eval_fn(p):
        # bf16 client state: the f32 data promotes the params to f32, as
        # JAX's type promotion does in its eval
        p = {k: v.to(x_all.dtype) if v.is_floating_point() else v for k, v in p.items()}
        return float(accuracy(apply_fn(p, x_all), y_all))

    return batcher, eval_fn


__all__ = [
    "AggregatorSpec",
    "CostSpec",
    "DataSpec",
    "DeadlineSpec",
    "ExperimentSpec",
    "FailureSpec",
    "ModelSpec",
    "NetworkSpec",
    "ParticipationSpec",
    "PrecisionSpec",
    "RunSpec",
    "ScheduleSpec",
    "TopologySpec",
    "TransportSpec",
]
