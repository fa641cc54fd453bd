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
needs a feature this slice does not port raises ``NotImplementedError``
naming the ROADMAP.md item that brings it.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hierfavg import PrecisionSpec, unported
from repro_torch.device import DeviceLike, resolve_device
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
    async_cloud: bool = False  # deprecated in the JAX package: maps to the deadline engine


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
    """Per-level aggregation statistic, bottom-up. Only the paper's
    weighted mean at every level runs here."""

    levels: str = "weighted_mean"

    def build(self, depth: int):
        names = {p.partition(":")[0].strip() for p in _levels(self.levels, "weighted_mean")}
        if not names <= {"weighted_mean", "mean"}:
            raise unported(f"aggregators.levels={self.levels!r}", 8)
        return None


@dataclasses.dataclass(frozen=True)
class FailureSpec:
    """Host-side failure / straggler injection (off by default)."""

    p_fail: float = 0.0
    p_recover: float = 0.5
    straggler_sigma: float = 0.0
    straggler_mean_s: float = 1.0
    seed: int = 1

    def check(self) -> None:
        if self.p_fail > 0 or self.straggler_sigma > 0:
            raise unported("failure / straggler injection", 9)


@dataclasses.dataclass(frozen=True)
class DeadlineSpec:
    """Semi-synchronous cloud rounds (off by default)."""

    enabled: bool = False
    timeout_s: float = 0.0
    quorum: float = 1.0
    buffer_size: int = 0
    max_staleness: int = 2
    staleness: str = "constant"
    edge_drop_rate: float = 0.0
    retry_limit: int = 1
    edge_speed: str = "det"
    edge_jitter: str = "det"
    mean_interval_s: float = 0.0
    seed: int = 0


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
        self.failures.check()
        if self.deadline.enabled or self.schedule.async_cloud:
            raise unported("the semi-synchronous deadline engine", 11)
        if self.run.checkpoint_dir or self.run.checkpoint_every:
            raise unported("checkpointing (checkpoint/manager.py)", 5)

    def model_bundle(self, device: DeviceLike = None) -> Dict[str, Any]:
        """{"module", "init", "apply", "loss"} for this spec's model."""
        return _model_bundle(self, resolve_device(device))

    def init_params(self, seed: int, device: DeviceLike = None):
        """Initial (unstacked) model parameters from a torch generator
        seeded with ``seed`` (not the JAX init's numbers)."""
        return self.model_bundle(device)["init"](seed)

    def params_from_numpy(self, np_params, device: DeviceLike = None):
        """A JAX init carried across (``jax.device_get(spec.init_params(key))``),
        checked against this spec's model."""
        from repro_torch.models.cnn import params_from_numpy

        device = resolve_device(device)
        return params_from_numpy(np_params, device, module=self.model_bundle(device)["module"])

    def build(self, *, device: DeviceLike = None):
        """Assemble the ``FederatedRunner`` on ``device`` (default ``cuda``)."""
        from repro_torch.core.hierarchy import as_hierarchy
        from repro_torch.fed.runner import FederatedRunner, RunnerConfig

        device = resolve_device(device)
        self._check_ported()
        topo = self.topology.build()
        hier = self.hier_config(_depth=as_hierarchy(topo).depth)
        bundle = _model_bundle(self, device)
        batcher, eval_fn = _build_data(self, topo, bundle, device)
        runner = FederatedRunner(
            loss_fn=bundle["loss"],
            optimizer=_build_optimizer(self.model),
            topology=topo,
            hier_config=hier,
            data_sizes=batcher.data_sizes,
            batcher=batcher,
            runner_config=RunnerConfig(
                num_rounds=self.run.num_rounds,
                eval_every=self.run.eval_every,
                target_accuracy=self.run.target_accuracy,
                engine=self.run.engine,
            ),
            eval_fn=eval_fn,
            costs=self.cost.build(),
            device=device,
        )
        runner.spec = self  # provenance: the runner knows its declarative form
        return runner

    def run_experiment(self, *, device: DeviceLike = None, params=None):
        """Build, initialize, and train: returns ``(runner, final_state)``.
        ``params`` (unstacked) replaces the spec's own init, e.g. a JAX init
        carried across with ``params_from_numpy``."""
        device = resolve_device(device)
        runner = self.build(device=device)
        if params is None:
            params = self.init_params(self.run.seed + 1, device)
        rng = torch.Generator(device=device).manual_seed(self.run.seed)
        state = runner.run(runner.init(rng, params))
        return runner, state

    def describe(self) -> str:
        topo = self.topology.fanouts or f"{self.topology.num_edges}x{self.topology.clients_per_edge}"
        tail = f" transport={self.transport.levels}" if self.transport.levels != "identity" else ""
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


def _model_bundle(spec: ExperimentSpec, device: torch.device) -> Dict[str, Any]:
    arch = spec.model.arch
    if arch == "mlp":
        from repro_torch.models.cnn import mlp_bundle

        return mlp_bundle(spec.data.dim, spec.model.hidden, spec.data.num_classes, device)
    if arch in _LM_PRESETS:
        raise unported(f"model.arch={arch!r}", 13)
    raise ValueError(f"model.arch must be one of ('mlp',) + {_LM_PRESETS}, got {arch!r}")


def _build_optimizer(model: ModelSpec):
    from repro_torch.optim import adam, exponential_decay, sgd

    if model.lr_schedule == "constant":
        lr = model.lr
    elif model.lr_schedule == "exponential":
        lr = exponential_decay(model.lr, model.decay_rate, model.decay_steps)
    elif model.lr_schedule == "warmup_cosine":
        raise unported("model.lr_schedule='warmup_cosine'", 13)
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
    from repro_torch.data import FederatedBatcher, clustered_gaussians, partition_hierarchy
    from repro_torch.models.cnn import accuracy

    d = spec.data
    if d.dataset == "tokens":
        raise unported("data.dataset='tokens'", 13)
    if d.dataset != "gaussians":
        raise ValueError(f"data.dataset must be gaussians|tokens, got {d.dataset!r}")
    if d.virtual_clients:
        raise unported("data.virtual_clients (population mode)", 10)
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
    data = clustered_gaussians(
        rng, num_samples=d.num_samples, num_classes=d.num_classes, dim=(d.dim,), class_sep=d.class_sep
    )
    parts = partition_hierarchy(d.partition, data.y, pspec, rng, **kw)[:n]
    batcher = FederatedBatcher({"inputs": data.x, "targets": data.y}, parts, batch_size=d.batch_size, seed=d.seed)
    apply_fn = bundle["apply"]
    x_all = torch.from_numpy(data.x).to(device)
    y_all = torch.from_numpy(data.y).to(device)

    def eval_fn(p):
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
