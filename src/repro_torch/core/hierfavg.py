"""HierFAVG (Algorithm 1) over stacked client tensors: the main path's part
of ``repro.core.hierfavg``.

Parameters are stacked along a leading client axis, ``{name: (N, ...)}``.
One ``torch.func.grad`` of the summed per-client loss (``vmap`` over the
client axis) yields every client's local gradient at once, since client
losses are block-separable in the stacked parameters. With the kappa vector
(k1, ..., kL), level l aggregates whenever ``k % prod(kappa[:l]) == 0`` and the
deepest due level wins (its staged mean subsumes the finer ones).

The JAX package's ``lax.scan`` loops are Python loops here and its
``lax.switch`` on the round index is a Python index: the aggregation level
of every round is known on the host. ``FedState.rng`` is a seeded
``torch.Generator`` handed to the loss; it does not reproduce the JAX
threefry stream draw for draw. The paper losses ignore it
(``repro/models/cnn.py:124-125``), so their trajectories are comparable.

Compressed transports (``fed.transport``) and ``delta_cloud`` carry the
last broadcast each client received in ``FedState.anchor`` and, for
error-feedback codecs, a per-client residual in ``FedState.residual``.
Since the port updates ``params`` in place, the anchor is always a copy
(``clone``), never a view of the parameters.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP.md
Queue 1 item): robust aggregators and non-f32 precision (8), sampled
participation (10), the deadline lowering (11), the client-sharded lowering
(12), the megakernel lowering (6).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.func import grad, vmap

from repro_torch.core import aggregation
from repro_torch.core.hierarchy import HierarchySpec, as_hierarchy
from repro_torch.optim import GradientTransformation, apply_updates

Params = Dict[str, torch.Tensor]
LossFn = Callable[[Params, Dict[str, torch.Tensor], Any], torch.Tensor]  # (params_i, batch_i, rng)


def unported(feature: str, item: int) -> NotImplementedError:
    """The error for a configuration that needs a feature a later slice
    brings; names the ROADMAP.md item."""
    return NotImplementedError(
        f"{feature} is not ported to repro_torch yet (ROADMAP.md Queue 1 item {item} brings it)"
    )


@dataclasses.dataclass(frozen=True)
class FedTopology:
    """Client-edge-cloud topology: N = num_edges * clients_per_edge clients."""

    num_edges: int
    clients_per_edge: int

    @property
    def num_clients(self) -> int:
        return self.num_edges * self.clients_per_edge


Topology = Union[FedTopology, HierarchySpec]


@dataclasses.dataclass(frozen=True)
class PrecisionSpec:
    """Mixed-precision policy for the stacked client state (the spec's
    ``precision`` section). Only the inert default (float32, no remat) runs
    in this slice; an active policy raises when a config is built."""

    param_dtype: str = "float32"
    remat: bool = False

    def __post_init__(self):
        dt = getattr(torch, self.param_dtype, None)
        if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
            raise ValueError(f"param_dtype must be floating, got {self.param_dtype!r}")
        object.__setattr__(self, "param_dtype", str(dt).removeprefix("torch."))

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def is_active(self) -> bool:
        return self.remat or self.dtype != torch.float32


@dataclasses.dataclass(frozen=True)
class HierFAVGConfig:
    """Aggregation schedule: ``kappa1`` local steps per edge aggregation,
    ``kappa2`` edge aggregations per cloud aggregation; ``kappas`` holds the
    full per-level vector for deeper trees (``multi_level`` builds a
    consistent config). ``sync_opt_state`` also averages the stacked
    optimizer state at each aggregation."""

    kappa1: int
    kappa2: int
    sync_opt_state: bool = False
    delta_cloud: bool = False
    kappas: Optional[Tuple[int, ...]] = None
    transport: Optional[Any] = None
    aggregators: Optional[Any] = None
    participation: Optional[Any] = None
    precision: Optional[PrecisionSpec] = None

    def __post_init__(self):
        if self.transport is not None:
            if not hasattr(self.transport, "codec") or not hasattr(self.transport, "is_trivial"):
                raise TypeError(
                    f"transport must be a fed.transport.TransportSpec, got {type(self.transport).__name__}"
                )
            n_levels = len(self.kappas) if self.kappas is not None else 2
            if self.transport.depth != n_levels:
                raise ValueError(
                    f"transport has {self.transport.depth} levels but the schedule has "
                    f"{n_levels} (kappas={self.kappas or (self.kappa1, self.kappa2)})"
                )
            if not self.transport.is_trivial and self.delta_cloud:
                raise ValueError(
                    "a non-identity transport subsumes delta_cloud (both repurpose "
                    "the anchor slot); drop the flag"
                )
        if self.aggregators is not None:
            raise unported("a non-default aggregator", 8)
        if self.precision is not None and self.precision.is_active:
            raise unported("a non-float32 precision policy", 8)
        if self.participation is not None:
            raise unported("sampled participation", 10)
        if self.kappas is not None:
            kv = tuple(int(k) for k in self.kappas)
            object.__setattr__(self, "kappas", kv)
            if len(kv) < 1 or any(k < 1 for k in kv):
                raise ValueError(f"kappas must be >= 1 per level, got {kv}")
            if kv[0] != self.kappa1 or (len(kv) > 1 and kv[1] != self.kappa2):
                raise ValueError(
                    f"kappas {kv} inconsistent with kappa1={self.kappa1}, "
                    f"kappa2={self.kappa2}; use HierFAVGConfig.multi_level"
                )
        if self.kappa1 < 1 or self.kappa2 < 1:
            raise ValueError("kappa1/kappa2 must be >= 1")

    @classmethod
    def multi_level(cls, kappas: Sequence[int], **kwargs) -> "HierFAVGConfig":
        kv = tuple(int(k) for k in kappas)
        if not kv:
            raise ValueError("kappas must have at least one level")
        return cls(kappa1=kv[0], kappa2=kv[1] if len(kv) > 1 else 1, kappas=kv, **kwargs)

    @property
    def kappa_vector(self) -> Tuple[int, ...]:
        return self.kappas if self.kappas is not None else (self.kappa1, self.kappa2)

    @property
    def num_levels(self) -> int:
        return len(self.kappa_vector)

    def level_interval(self, level: int) -> int:
        """Local steps between level-l aggregations: prod(kappa[:l])."""
        return math.prod(self.kappa_vector[:level])

    @property
    def cloud_interval(self) -> int:
        return self.level_interval(self.num_levels)

    @property
    def kappa2_effective(self) -> int:
        """Edge intervals per cloud interval (= kappa2 for two levels)."""
        return math.prod(self.kappa_vector[1:])

    @property
    def transport_active(self) -> bool:
        """True iff some level's uplink compresses (an all-identity
        transport is the uncompressed protocol and allocates no anchor or
        residual)."""
        return self.transport is not None and not self.transport.is_trivial

    # The JAX config's other feature predicates. Each such feature is
    # rejected in __post_init__ until its slice lands, so each reads False.

    @property
    def aggregators_active(self) -> bool:
        return self.aggregators is not None

    @property
    def participation_active(self) -> bool:
        return self.participation is not None

    @property
    def precision_active(self) -> bool:
        return self.precision is not None and self.precision.is_active


class FedState(NamedTuple):
    step: torch.Tensor  # () int32 local update counter k
    params: Params  # stacked (N, ...) client models
    opt_state: Any  # optimizer state over the stacked params
    rng: torch.Generator  # seeded; not the JAX threefry stream
    anchor: Optional[Params] = None  # last broadcast (delta_cloud / compressed transport)
    residual: Optional[Params] = None  # per-client error-feedback residual (EF codecs), f32


def replicate_for_clients(params: Params, num_clients: int) -> Params:
    """Stack the initial model: every client starts from w0 (Algorithm 1 l.2)."""
    return {k: p.unsqueeze(0).expand((num_clients,) + tuple(p.shape)).clone() for k, p in params.items()}


def init_state(
    rng: torch.Generator,
    params: Params,
    optimizer: GradientTransformation,
    topology: Topology,
    config: HierFAVGConfig,
) -> FedState:
    """Every client starts from ``params`` (unstacked), with fresh
    optimizer state and step 0."""
    stacked = replicate_for_clients(params, topology.num_clients)
    device = next(iter(stacked.values())).device
    anchor = residual = None
    if config.delta_cloud or config.transport_active:
        # the last broadcast each client received: w - anchor is what a
        # compressed uplink carries
        anchor = _copy(stacked)
    if config.transport_active and config.transport.needs_residual:
        residual = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in stacked.items()}
    return FedState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        params=stacked,
        opt_state=optimizer.init(stacked),
        rng=rng,
        anchor=anchor,
        residual=residual,
    )


def _copy(tree: Params) -> Params:
    """A copy that shares no storage with ``tree``: the anchor must not move
    when the local steps update ``params`` in place."""
    return {k: v.clone() for k, v in tree.items()}


def build_local_step(loss_fn: LossFn, optimizer: GradientTransformation):
    """One local SGD update for all clients (Algorithm 1 l.5).

    batch leaves: (N, b, ...). Returns ``local_step(state, batch) ->
    (state, metrics)``. The stacked parameters are updated in place
    (``optim.apply_updates``); the loss / grad-norm metrics are f32 device
    scalars."""

    def total_loss(params, batch, rng):
        losses = vmap(loss_fn, in_dims=(0, 0, None))(params, batch, rng)
        # sum (not mean): keeps per-client gradients identical to each client
        # running SGD on its own mean loss
        return torch.sum(losses), losses

    grad_fn = grad(total_loss, has_aux=True)

    def local_step(state: FedState, batch: Dict[str, torch.Tensor]) -> Tuple[FedState, dict]:
        grads, losses = grad_fn(state.params, batch, state.rng)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        apply_updates(state.params, updates)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(grads[k].to(torch.float32))) for k in sorted(grads)))
        metrics = {"loss": torch.mean(losses.to(torch.float32)), "grad_norm": gnorm}
        return state._replace(step=state.step + 1, opt_state=opt_state), metrics

    return local_step


def _maybe_sync_opt_state(opt_state, agg_fn, sync: bool):
    """Average the stacked optimizer leaves too (``sync_opt_state``): every
    dict in the state holds stacked (N, ...) leaves; shared scalars (the
    schedule count) pass through."""
    if not sync:
        return opt_state

    def walk(x):
        if isinstance(x, dict):
            return agg_fn(x)
        if isinstance(x, tuple):
            parts = [walk(v) for v in x]
            return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
        return x

    return walk(opt_state)


def build_level_sync(topology: Topology, config: HierFAVGConfig, weights: torch.Tensor, level: int):
    """Aggregation at one hierarchy level (Algorithm 1 l.25-31 generalized)
    with an optional (N,) survival mask: the single-device branch of
    ``repro/core/hierfavg.py:611-667``. Level 1 is edge aggregation, level
    ``depth`` cloud aggregation, computed as the staged bottom-up
    composition (``hierarchical_segment_mean``); the top level honours
    ``delta_cloud``.

    With a non-identity codec at this level each client uploads its delta
    w - anchor through the codec's round trip, and the group mean is taken
    over anchor + decoded delta. While a transport is active the anchor
    re-syncs to the new broadcast after every level sync, identity levels
    included. A client whose whole group died keeps its exact params and
    anchor, and a masked client keeps its error-feedback residual; the
    ``received`` / ``sent`` masks are computed on the device.
    """
    spec = as_hierarchy(topology)
    if not 1 <= level <= spec.depth:
        raise ValueError(f"level {level} outside 1..{spec.depth}")
    is_top = level == spec.depth
    if is_top and config.delta_cloud and config.sync_opt_state:
        raise ValueError("delta_cloud + sync_opt_state do not compose (the optimizer state has no anchor)")
    codec = config.transport.codec(level) if config.transport_active else None
    if codec is not None and codec.is_identity:
        codec = None
    stages = aggregation.level_stages(spec, level)  # uniform vs ragged, decided once
    seg = torch.as_tensor(spec.segments(level), dtype=torch.long, device=weights.device)
    num_segs = spec.num_nodes(level)

    def level_sync(state: FedState, mask: Optional[torch.Tensor] = None) -> FedState:
        uploaded = state.params
        residual = state.residual
        if codec is not None:
            delta = {k: x.to(torch.float32) - state.anchor[k].to(torch.float32) for k, x in state.params.items()}
            delta_hat, residual = codec.roundtrip(delta, residual)
            uploaded = {
                k: (a.to(torch.float32) + delta_hat[k]).to(state.params[k].dtype) for k, a in state.anchor.items()
            }
        if is_top and config.delta_cloud and state.anchor is not None:
            agg = lambda t: aggregation.delta_weighted_mean(t, state.anchor, weights, mask)
            params = agg(uploaded)
            anchor = _copy(params)
        else:
            agg = lambda t: aggregation.staged_mean(t, weights, stages, mask)
            params = agg(uploaded)
            anchor = _copy(params) if config.transport_active else state.anchor
        if codec is not None:
            w_eff = weights.to(torch.float32)
            if mask is not None:
                w_eff = w_eff * mask.to(torch.float32)
            den = torch.zeros(num_segs, dtype=torch.float32, device=w_eff.device).index_add_(0, seg, w_eff)
            received = (den > 0)[seg]  # (N,) the client's group had a survivor
            sent = w_eff > 0  # (N,) the client uploaded

            def keep(flags, new, old):
                f = flags.reshape((-1,) + (1,) * (new.dim() - 1))
                return torch.where(f, new, old.to(new.dtype))

            params = {k: keep(received, v, state.params[k]) for k, v in params.items()}
            anchor = {k: keep(received, v, state.anchor[k]) for k, v in anchor.items()}
            if residual is not None and state.residual is not None:
                residual = {k: keep(sent, v, state.residual[k]) for k, v in residual.items()}
        opt_state = _maybe_sync_opt_state(state.opt_state, agg, config.sync_opt_state)
        return state._replace(params=params, opt_state=opt_state, anchor=anchor, residual=residual)

    return level_sync


def _check_levels(spec: HierarchySpec, config: HierFAVGConfig) -> int:
    if config.num_levels != spec.depth:
        raise ValueError(
            f"schedule has {config.num_levels} levels (kappas="
            f"{config.kappa_vector}) but the hierarchy has depth {spec.depth}"
        )
    return spec.depth


def _round_intervals(config: HierFAVGConfig):
    """Rounds between level-l aggregations: prod(kappa_2..kappa_l)."""
    kv = config.kappa_vector
    return [math.prod(kv[1:l]) for l in range(1, len(kv) + 1)]


def _step_slice(batches: Dict[str, torch.Tensor], j: int) -> Dict[str, torch.Tensor]:
    return {k: v[j] for k, v in batches.items()}


def _edge_interval(local_step, state: FedState, batches, k1: int):
    """kappa1 local steps; returns (state, mean loss, mean grad norm)."""
    losses, gnorms = [], []
    for j in range(k1):
        state, m = local_step(state, _step_slice(batches, j))
        losses.append(m["loss"])
        gnorms.append(m["grad_norm"])
    return state, torch.mean(torch.stack(losses)), torch.mean(torch.stack(gnorms))


def build_hier_round(
    loss_fn: LossFn,
    optimizer: GradientTransformation,
    topology: Topology,
    config: HierFAVGConfig,
    weights: torch.Tensor,
):
    """One edge interval: kappa1 local steps, then the deepest due
    aggregation (edge every round, level l every prod(kappa_2..kappa_l)
    rounds). ``hier_round(state, batches, round_index, mask=None)``; batch
    leaves carry a leading (kappa1,) axis."""
    spec = as_hierarchy(topology)
    depth = _check_levels(spec, config)
    local_step = build_local_step(loss_fn, optimizer)
    level_syncs = [build_level_sync(spec, config, weights, l) for l in range(1, depth + 1)]
    intervals = _round_intervals(config)

    def hier_round(state: FedState, batches, round_index: int, mask=None):
        state, loss, gnorm = _edge_interval(local_step, state, batches, config.kappa1)
        deepest = sum(1 for iv in intervals if (round_index + 1) % iv == 0)
        state = level_syncs[deepest - 1](state, mask)
        return state, {"loss": loss, "grad_norm": gnorm}

    return hier_round


def super_round_schedule(config: HierFAVGConfig) -> Tuple[int, ...]:
    """Deepest aggregation level after each of the kappa2_effective rounds
    of one cloud interval (1 = edge only, depth = cloud)."""
    intervals = _round_intervals(config)
    return tuple(
        sum(1 for iv in intervals if (j + 1) % iv == 0) for j in range(config.kappa2_effective)
    )


def build_super_round(
    loss_fn: LossFn,
    optimizer: GradientTransformation,
    topology: Topology,
    config: HierFAVGConfig,
    weights: torch.Tensor,
):
    """One cloud interval: kappa2_effective edge intervals, each kappa1 local
    steps plus its due aggregation from ``super_round_schedule``.

        super_round(state, batches, masks=None) -> (state, metrics)

    batch leaves carry a leading (kappa2_eff, kappa1) pair; ``masks`` is an
    optional (kappa2_eff, N) stack of survival vectors. Metrics come back
    stacked on the device, ``{"loss", "grad_norm", "step"}`` each
    (kappa2_eff,), so the caller can defer the host fetch. The stacked
    parameters are updated in place (the counterpart of the JAX engine's
    donated state). Callers start at a cloud boundary.
    """
    spec = as_hierarchy(topology)
    depth = _check_levels(spec, config)
    local_step = build_local_step(loss_fn, optimizer)
    level_syncs = [build_level_sync(spec, config, weights, l) for l in range(1, depth + 1)]
    schedule = super_round_schedule(config)

    def super_round(state: FedState, batches, masks: Optional[torch.Tensor] = None):
        losses, gnorms, steps = [], [], []
        for r, deepest in enumerate(schedule):
            state, loss, gnorm = _edge_interval(local_step, state, _step_slice(batches, r), config.kappa1)
            state = level_syncs[deepest - 1](state, None if masks is None else masks[r])
            losses.append(loss)
            gnorms.append(gnorm)
            steps.append(state.step)
        metrics = {"loss": torch.stack(losses), "grad_norm": torch.stack(gnorms), "step": torch.stack(steps)}
        return state, metrics

    return super_round
