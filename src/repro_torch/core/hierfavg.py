"""HierFAVG (Algorithm 1) over stacked client tensors: the main path's part
of ``repro.core.hierfavg``.

Parameters are trees (``repro_torch.tree``: the MLP's flat dict, the LM's
nested tree) of tensors stacked along a leading client axis, (N, ...).
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

Every local step may accumulate microbatches (``grad_accum``): batch
leaves (grad_accum, N, b, ...), the gradients the microbatches' mean, the
loss metric the last microbatch's, as JAX's scan carry leaves it.
``build_train_step`` is one local step and the level sync due after it,
``build_edge_sync`` / ``build_cloud_sync`` the two hops alone (the launch
cells of ``launch.steps``).

A ``PrecisionSpec`` with a non-f32 ``param_dtype`` stores and steps the
stacked client state in that dtype (batches are cast on the way into the
loss); every aggregation still accumulates in f32.
``PrecisionSpec.remat`` recomputes each client's forward in the backward
(``_remat``). ``build_megakernel_super_round`` is the client-blocked
lowering of the superround (``engine="megakernel"``). A non-default
``AggregatorSpec`` level (``core.aggregation``: trimmed mean, coordinate
median) replaces that level's weighted mean in ``build_level_sync``.

Sampled participation (``HierFAVGConfig.participation``) runs through
``build_cohort_super_round``: the state stacks the C sampled clients, and
each sync's staged mean runs over the cohort members' original node ids
(``aggregation.cohort_stages``). The semi-synchronous deadline engine runs
``build_deadline_super_round``: the superround with its top-level sync
gated by a per-client arrival weight, K1/K2 for every stage as in the
synchronous sync.

The client-sharded lowerings (``build_sharded_super_round``,
``build_sharded_cohort_super_round``) run one process per shard of a
``dist.sharding.RankMesh``: each rank holds the rows of the clients
``core.hierarchy.ShardPlacement`` puts on it, every sync below the top is
rank-local (K1/K2 over the rank's own segments) and each cloud sync is one
``dist.all_reduce`` (``aggregation.psum_weighted_mean``). The rank is known
on the host, so its weights and segments are plain host rows where JAX
selects them with ``lax.axis_index``. Every rank's ``FedState.rng`` is the
same seeded generator and the loss gets it as on one device; the vmapped
losses cannot draw from it, so no rank's stream moves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.func import grad, vmap
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.analysis import opcount
from repro_torch.core import aggregation
from repro_torch.core.hierarchy import (
    HierarchySpec,
    ShardPlacement,
    as_hierarchy,
    cohort_hierarchy,
    plan_cohort_placement,
    plan_shard_placement,
)
from repro_torch.optim import GradientTransformation, apply_updates
from repro_torch.tree import Tree, first_leaf, leaves, tree_map, unflatten

Params = Tree
LossFn = Callable[[Params, Dict[str, torch.Tensor], Any], torch.Tensor]  # (params_i, batch_i, rng)


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
    ``precision`` section). ``param_dtype`` is the storage and compute
    dtype of the stacked client params and their stacked optimizer rows
    (``"bfloat16"`` halves them); aggregation accumulates in f32 and casts
    back, and the loss / grad-norm metrics are reduced in f32. ``remat``
    keeps only each client loss's inputs for the backward, which reruns the
    forward (``_remat``), as JAX's ``jax.checkpoint`` of the loss does."""

    param_dtype: str = "float32"
    remat: bool = False

    def __post_init__(self):
        # names parse as the JAX package parses them (``jnp.dtype``, numpy's
        # rules: "float" is float64, "half" float16; unknown names raise
        # TypeError); numpy has no bfloat16 of its own
        name = "bfloat16" if self.param_dtype == "bfloat16" else np.dtype(self.param_dtype).name
        dt = getattr(torch, name, None)
        if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
            raise ValueError(f"param_dtype must be floating, got {self.param_dtype!r}")
        object.__setattr__(self, "param_dtype", name)

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
        if self.precision is not None and not isinstance(self.precision, PrecisionSpec):
            raise TypeError(f"precision must be a PrecisionSpec, got {type(self.precision).__name__}")
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
            if not hasattr(self.aggregators, "aggregator") or not hasattr(self.aggregators, "is_trivial"):
                raise TypeError(
                    f"aggregators must be a core.aggregation.AggregatorSpec, got "
                    f"{type(self.aggregators).__name__}"
                )
            n_levels = len(self.kappas) if self.kappas is not None else 2
            if self.aggregators.depth != n_levels:
                raise ValueError(
                    f"aggregators has {self.aggregators.depth} levels but the schedule "
                    f"has {n_levels} (kappas={self.kappas or (self.kappa1, self.kappa2)})"
                )
            if not self.aggregators.is_trivial:
                if self.delta_cloud and not self.aggregators.aggregator(n_levels).is_default:
                    raise ValueError(
                        "delta_cloud requires the default weighted_mean at the top "
                        "level (delta aggregation is a weighted-mean identity)"
                    )
        if self.participation is not None:
            if not hasattr(self.participation, "cohort_size") or not hasattr(self.participation, "is_active"):
                raise TypeError(
                    f"participation must be a fed.participation.ParticipationSpec, got "
                    f"{type(self.participation).__name__}"
                )
            if self.participation.is_active and self.aggregators_active:
                raise ValueError(
                    "sampled participation requires the default weighted mean at "
                    "every level (a robust statistic over a sampled cohort is not "
                    "the population statistic)"
                )
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

    def is_level_step(self, level: int, k: int) -> bool:
        """Local step ``k`` (the count after the step) ends a level-l interval."""
        return k % self.level_interval(level) == 0

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

    @property
    def aggregators_active(self) -> bool:
        """True iff some level replaces the paper's weighted mean (an
        all-``weighted_mean`` spec keeps the unchanged code path)."""
        return self.aggregators is not None and not self.aggregators.is_trivial

    @property
    def participation_active(self) -> bool:
        """True iff cohort sampling is on (a cohort_size=0 spec is inert and
        every engine keeps its full-population behaviour)."""
        return self.participation is not None and self.participation.is_active

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
    return tree_map(lambda p: p.unsqueeze(0).expand((num_clients,) + tuple(p.shape)).clone(), params)


def init_state(
    rng: torch.Generator,
    params: Params,
    optimizer: GradientTransformation,
    topology: Optional[Topology],
    config: HierFAVGConfig,
    *,
    already_stacked: bool = False,
) -> FedState:
    """Every client starts from ``params`` (unstacked; with
    ``already_stacked`` the rows are given and ``topology`` is unused),
    with fresh optimizer state and step 0. Under an active precision policy
    the stacked floating params are cast to its dtype before the optimizer
    state is made, so stacked optimizer rows follow (Adam's moments stay
    f32)."""
    stacked = params if already_stacked else replicate_for_clients(params, topology.num_clients)
    if config.precision_active:
        dt = config.precision.dtype
        stacked = tree_map(lambda p: p.to(dt) if p.is_floating_point() else p, stacked)
    device = first_leaf(stacked).device
    anchor = residual = None
    if config.delta_cloud or config.transport_active:
        # the last broadcast each client received: w - anchor is what a
        # compressed uplink carries
        anchor = _copy(stacked)
    if config.transport_active and config.transport.needs_residual:
        residual = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), stacked)
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
    return tree_map(torch.clone, tree)


class _RematLoss(torch.autograd.Function):
    """One client's loss whose backward reruns the forward: ``forward``
    keeps no activations, ``setup_context`` saves the loss's inputs (the
    params and batch leaves in ``tree.leaves`` order) and ``backward``
    reruns the loss under ``torch.func.vjp`` for the params' cotangents.

    ``torch.utils.checkpoint`` cannot run inside ``torch.func.grad`` (saved
    tensor hooks), so this is the port's ``jax.checkpoint``. Under the
    engine's ``grad(vmap(...))`` the generated vmap rule runs the forward
    and the backward under ``vmap``: their inputs are functorch-wrapped, so
    the LM layers take their layer code in both (``layers._use_kernels``),
    never K7/K8 in one and the layer code in the other."""

    generate_vmap_rule = True

    @staticmethod
    def forward(loss_fn, pskel, bskel, rng, n_params, *flat):
        return loss_fn(unflatten(pskel, flat[:n_params]), unflatten(bskel, flat[n_params:]), rng)

    @staticmethod
    def setup_context(ctx, inputs, output):
        loss_fn, pskel, bskel, rng, n_params, *flat = inputs
        ctx.save_for_backward(*flat)
        ctx.loss_fn, ctx.pskel, ctx.bskel, ctx.rng, ctx.n_params = loss_fn, pskel, bskel, rng, n_params

    @staticmethod
    def backward(ctx, g):
        flat = ctx.saved_tensors
        n = ctx.n_params
        batch = unflatten(ctx.bskel, flat[n:])
        _, vjp_fn = torch.func.vjp(lambda *p: ctx.loss_fn(unflatten(ctx.pskel, p), batch, ctx.rng), *flat[:n])
        return (None,) * 5 + tuple(vjp_fn(g)) + (None,) * (len(flat) - n)


def _remat(loss_fn: LossFn) -> LossFn:
    """``loss_fn`` through ``_RematLoss``: the same value, gradients from a
    rerun of the forward."""

    def remat_loss(params, batch, rng):
        p, b = list(leaves(params)), list(leaves(batch))
        skel = lambda t: tree_map(lambda _: 0, t)
        return _RematLoss.apply(loss_fn, skel(params), skel(batch), rng, len(p), *p, *b)

    return remat_loss


def _apply_precision(loss_fn: LossFn, precision: Optional[PrecisionSpec]) -> LossFn:
    """Wrap a per-client loss with the precision policy: ``remat`` reruns
    the forward in the backward (``_remat``), and the batch's floating
    leaves are cast to the policy dtype on the way in, so the forward and
    backward run in it. The inert policy (or None) returns ``loss_fn``
    unchanged."""
    if precision is None or not precision.is_active:
        return loss_fn
    inner = _remat(loss_fn) if precision.remat else loss_fn
    dt = precision.dtype
    if dt == torch.float32:
        return inner

    def cast_loss(params, batch, rng):
        batch = {k: x.to(dt) if x.is_floating_point() else x for k, x in batch.items()}
        return inner(params, batch, rng)

    return cast_loss


def _client_grads(loss_fn: LossFn, precision: Optional[PrecisionSpec], grad_accum: int = 1):
    """``(params, batch, rng) -> (grads, per-client losses)`` for a stack of
    clients: one ``torch.func`` grad of the summed per-client loss, vmapped
    over the leading client axis.

    With ``grad_accum`` > 1 the batch leaves carry a leading microbatch axis,
    (grad_accum, N, b, ...) (``repro/core/hierfavg.py:354-384``): the
    gradients are the microbatches' sum divided by ``grad_accum``, added
    in microbatch order, and the losses are the last microbatch's (JAX's
    scan carry replaces them)."""
    loss_p = _apply_precision(loss_fn, precision)

    def total_loss(params, batch, rng):
        losses = vmap(loss_p, in_dims=(0, 0, None))(params, batch, rng)
        # sum (not mean): keeps per-client gradients identical to each client
        # running SGD on its own mean loss
        return torch.sum(losses), losses

    grad_fn = grad(total_loss, has_aux=True)
    if grad_accum == 1:
        return grad_fn

    def microbatch_grads(params, batch, rng):
        acc, losses = grad_fn(params, _step_slice(batch, 0), rng)
        for i in opcount.iterations(range(1, grad_accum)):  # a count on meta tensors folds them
            g, losses = grad_fn(params, _step_slice(batch, i), rng)
            acc = tree_map(lambda a, b: a.add_(b), acc, g)
            del g
        return tree_map(lambda a: a.div_(grad_accum), acc), losses

    return microbatch_grads


def build_local_step(loss_fn: LossFn, optimizer: GradientTransformation, *, grad_accum: int = 1,
                     precision: Optional[PrecisionSpec] = None, model=None):
    """One local SGD update for all clients (Algorithm 1 l.5).

    batch leaves: (N, b, ...), or (grad_accum, N, b, ...) with microbatch
    accumulation (``_client_grads``). Returns ``local_step(state, batch) ->
    (state, metrics)``. The stacked parameters are updated in place
    (``optim.apply_updates``); ``precision`` casts the batch to the policy
    dtype; the loss / grad-norm metrics are f32 device scalars (the loss
    the last microbatch's). ``model`` (a ``dist.sharding.ModelShards``:
    the params are a model rank's tensor-parallel slices) makes the grad
    norm global over the model ranks, one counted all-reduce."""
    grad_fn = _client_grads(loss_fn, precision, grad_accum)

    def local_step(state: FedState, batch: Dict[str, torch.Tensor]) -> Tuple[FedState, dict]:
        grads, losses = grad_fn(state.params, batch, state.rng)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        apply_updates(state.params, updates)
        sq = [torch.sum(torch.square(g.to(torch.float32))) for g in leaves(grads)]
        gnorm = torch.sqrt(sum(sq) if model is None else model.sum_sq(sq))
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


def _level_codec(config: HierFAVGConfig, level: int):
    """The level's non-identity link codec, or None."""
    codec = config.transport.codec(level) if config.transport_active else None
    return None if codec is None or codec.is_identity else codec


def _sync_state(state: FedState, config: HierFAVGConfig, codec, is_top: bool, weights: torch.Tensor,
                mask: Optional[torch.Tensor], mean, seg: torch.Tensor, num_segs: int) -> FedState:
    """The body of a level sync, shared by ``build_level_sync`` and the
    cohort lowering: the codec's round trip of the uploads, ``mean`` over
    them (or the top level's ``delta_cloud`` form), the anchor's re-sync,
    the keep-dead rules over the level's groups (``seg`` (N,) device ids in
    [0, ``num_segs``)), and ``sync_opt_state``."""
    uploaded = state.params
    residual = state.residual
    if codec is not None:
        delta = tree_map(lambda x, a: x.to(torch.float32) - a.to(torch.float32), state.params, state.anchor)
        delta_hat, residual = codec.roundtrip(delta, residual)
        uploaded = tree_map(lambda a, d, x: (a.to(torch.float32) + d).to(x.dtype),
                            state.anchor, delta_hat, state.params)
    if is_top and config.delta_cloud and state.anchor is not None:
        agg = lambda t: aggregation.delta_weighted_mean(t, state.anchor, weights, mask)
        params = agg(uploaded)
        anchor = _copy(params)
    else:
        agg = mean
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

        params = tree_map(lambda v, old: keep(received, v, old), params, state.params)
        anchor = tree_map(lambda v, old: keep(received, v, old), anchor, state.anchor)
        if residual is not None and state.residual is not None:
            residual = tree_map(lambda v, old: keep(sent, v, old), residual, state.residual)
    opt_state = _maybe_sync_opt_state(state.opt_state, agg, config.sync_opt_state)
    return state._replace(params=params, opt_state=opt_state, anchor=anchor, residual=residual)


def build_level_sync(topology: Topology, config: HierFAVGConfig, weights: torch.Tensor, level: int, *,
                     shard: Optional["ClientSharding"] = None):
    """Aggregation at one hierarchy level (Algorithm 1 l.25-31 generalized)
    with an optional (N,) survival mask: the single-device branch of
    ``repro/core/hierfavg.py:611-667``. Level 1 is edge aggregation, level
    ``depth`` cloud aggregation, computed as the staged bottom-up
    composition (``hierarchical_segment_mean``); the top level honours
    ``delta_cloud``. A non-default aggregator at this level
    (``config.aggregators``: trimmed mean, coordinate median) replaces the
    weighted mean, applied to what the transport delivered, so robustness
    composes with codecs and masks; the default keeps the path unchanged.

    With a non-identity codec at this level each client uploads its delta
    w - anchor through the codec's round trip, and the group mean is taken
    over anchor + decoded delta. While a transport is active the anchor
    re-syncs to the new broadcast after every level sync, identity levels
    included. A client whose whole group died keeps its exact params and
    anchor, and a masked client keeps its error-feedback residual; the
    ``received`` / ``sent`` masks are computed on the device.

    With ``shard`` (a ``ClientSharding``) the sync runs on this rank's rows
    of a client-sharded state (``_build_sharded_level_sync``): sub-top
    levels reduce rank-locally, the top level with one all-reduce.
    """
    spec = as_hierarchy(topology)
    if not 1 <= level <= spec.depth:
        raise ValueError(f"level {level} outside 1..{spec.depth}")
    is_top = level == spec.depth
    codec = _level_codec(config, level)
    robust = config.aggregators.aggregator(level) if config.aggregators_active else None
    if robust is not None and robust.is_default:
        robust = None
    if shard is not None:
        return _build_sharded_level_sync(spec, config, level, codec, robust, shard)
    if is_top and config.delta_cloud and config.sync_opt_state:
        raise ValueError("delta_cloud + sync_opt_state do not compose (the optimizer state has no anchor)")
    stages = aggregation.level_stages(spec, level)  # uniform vs ragged, decided once
    seg = torch.as_tensor(spec.segments(level), dtype=torch.long, device=weights.device)
    num_segs = spec.num_nodes(level)

    def level_sync(state: FedState, mask: Optional[torch.Tensor] = None) -> FedState:
        if robust is not None:
            mean = lambda t: robust(t, weights, spec, level, mask)
        else:
            mean = lambda t: aggregation.staged_mean(t, weights, stages, mask)
        return _sync_state(state, config, codec, is_top, weights, mask, mean, seg, num_segs)

    return level_sync


def build_edge_sync(topology: Topology, config: HierFAVGConfig, weights: torch.Tensor, *,
                    shard: Optional["ClientSharding"] = None):
    """Edge aggregation (Algorithm 1 l.8, 25-28): the level-1 sync."""
    return build_level_sync(topology, config, weights, 1, shard=shard)


def build_cloud_sync(topology: Topology, config: HierFAVGConfig, weights: torch.Tensor, *,
                     shard: Optional["ClientSharding"] = None):
    """Cloud aggregation (Algorithm 1 l.18-21, 29-31): the top-level sync."""
    return build_level_sync(topology, config, weights, as_hierarchy(topology).depth, shard=shard)


def build_train_step(
    loss_fn: LossFn,
    optimizer: GradientTransformation,
    topology: Topology,
    config: HierFAVGConfig,
    weights: torch.Tensor,
    *,
    grad_accum: int = 1,
    shard: Optional["ClientSharding"] = None,
    model=None,
):
    """One fused HierFAVG step (``repro/core/hierfavg.py:822-859``): a local
    update, then the deepest level sync due at the new step count.

        train_step(state, batch, mask=None) -> (state, metrics)

    ``mask`` is the (N,) survival vector (None: all alive). The level
    intervals nest, so the levels due at step k are a prefix 1..m and the
    level-m sync subsumes the finer ones; m = 0 syncs nothing. JAX picks
    the branch with ``lax.switch`` on the device step; here the step count
    is read on the host (one device sync a step).

    With ``shard`` (a ``ClientSharding``) the step runs on this rank's rows
    of a client-sharded state: the local step is the single-device one, the
    sub-top syncs are rank-local and the cloud sync is one all-reduce
    (``build_level_sync(shard=)``). The metrics then stay per client, as the
    sharded superround's, so no collective is spent on them: ``{"loss":
    (C,), "gsq": (C,) squared grad norms, "step"}``; unsharded they are the
    means ``{"loss", "grad_norm", "step"}``.

    With ``model`` (a ``dist.sharding.ModelShards``) the params are a model
    rank's tensor-parallel slices: the grad norms (or "gsq") are global over
    the model ranks, one counted all-reduce a step, and each level sync
    runs K1 on the rank's slice of every leaf, no collective of its own
    (``shard``'s mesh is then the client axis's line)."""
    spec = as_hierarchy(topology)
    depth = _check_levels(spec, config)
    if shard is None:
        local_step = build_local_step(loss_fn, optimizer, grad_accum=grad_accum, precision=config.precision,
                                      model=model)
    else:
        sharded_step = _sharded_local_step(loss_fn, optimizer, config.precision, grad_accum, model)

        def local_step(state, batch):
            state, losses, gsq = sharded_step(state, batch)
            return state, {"loss": losses, "gsq": gsq}
    level_syncs = [build_level_sync(spec, config, weights, lvl, shard=shard) for lvl in range(1, depth + 1)]

    def train_step(state: FedState, batch, mask: Optional[torch.Tensor] = None):
        state, metrics = local_step(state, batch)
        k = int(state.step)
        deepest = sum(1 for lvl in range(1, depth + 1) if config.is_level_step(lvl, k))
        if deepest:
            state = level_syncs[deepest - 1](state, mask)
        metrics["step"] = state.step
        return state, metrics

    return train_step


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

    *,
    grad_accum: int = 1,
):
    """One edge interval: kappa1 local steps, then the deepest due
    aggregation (edge every round, level l every prod(kappa_2..kappa_l)
    rounds). ``hier_round(state, batches, round_index, mask=None)``; batch
    leaves carry a leading (kappa1,) axis."""
    spec = as_hierarchy(topology)
    depth = _check_levels(spec, config)
    local_step = build_local_step(loss_fn, optimizer, grad_accum=grad_accum, precision=config.precision)
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

    *,
    grad_accum: int = 1,
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
    local_step = build_local_step(loss_fn, optimizer, grad_accum=grad_accum, precision=config.precision)
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


def deadline_incompatibility(config: HierFAVGConfig, topology: Topology) -> Optional[str]:
    """Why this schedule cannot run under the semi-synchronous deadline
    engine (``build_deadline_super_round``), or None when it can: the one
    predicate that function (raises) and the runner (reports) consult. The
    reasons and their words are the JAX package's
    (``repro/core/hierfavg.py:988-1021``): the gate is a per-client weight,
    a sound reweighting only of the default weighted mean at the top, and a
    late edge that misses the broadcast has no keep path for anchors or
    averaged optimizer state."""
    spec = as_hierarchy(topology)
    if config.transport_active:
        return (
            "compressed transports re-sync every client's anchor at each "
            "boundary; a late edge that missed the broadcast would desync "
            "its delta reference"
        )
    if config.delta_cloud:
        return "delta_cloud's anchor rebroadcast assumes every edge receives each round"
    if config.sync_opt_state:
        return "optimizer-state averaging has no per-edge keep path for late subtrees yet"
    if config.aggregators_active and not config.aggregators.aggregator(spec.depth).is_default:
        return (
            "the staleness gate reweights client columns, which is only a "
            "sound transformation of the default weighted mean at the top level"
        )
    if config.participation_active:
        return "sampled participation runs through the cohort engine"
    return None


def build_deadline_super_round(
    loss_fn: LossFn,
    optimizer: GradientTransformation,
    topology: Topology,
    config: HierFAVGConfig,
    weights: torch.Tensor,

    *,
    grad_accum: int = 1,
):
    """One semi-synchronous cloud interval (``repro/core/hierfavg.py:1024-1131``):
    ``build_super_round`` with the top-level sync gated by a per-client
    cloud-arrival weight.

        deadline_round(state, batches, gate, masks=None) -> (state, metrics)

    ``gate`` is (N,) f32 on the state's device: each client's edge arrival
    x staleness weight for this interval's cloud aggregation
    (``fed.deadline.RoundPlan.client_gate``). At the interval's last round
    the sub-top stages are the synchronous staged mean with the survival
    mask alone (every edge syncs, late ones included); the top stage takes
    ``mask * gate`` (K1 with one group on the card: folded edges count at
    their decayed weight, late and dropped ones at 0; an all-zero gate
    keeps the rows, so ``mid`` comes back); a client whose gate is 0 missed
    the broadcast and keeps the edge-synced model (``torch.where`` per
    leaf). The other rounds are ``build_super_round``'s level syncs. The
    engine dispatches the stock superround for trivial plans, so the
    barrier's bit-exactness never rests on this function."""
    spec = as_hierarchy(topology)
    depth = _check_levels(spec, config)
    reason = deadline_incompatibility(config, spec)
    if reason is not None:
        raise ValueError(f"schedule cannot run the deadline engine: {reason}")
    local_step = build_local_step(loss_fn, optimizer, grad_accum=grad_accum, precision=config.precision)
    level_syncs = [build_level_sync(spec, config, weights, l) for l in range(1, depth)]
    sub_top = aggregation.level_stages(spec, depth - 1) if depth > 1 else ()
    top = aggregation.level_stages(spec, depth)[-1:]
    schedule = super_round_schedule(config)

    def gated_top_sync(state: FedState, mask, gate) -> FedState:
        mid = aggregation.staged_mean(state.params, weights, sub_top, mask) if sub_top else state.params
        top_mask = gate if mask is None else mask * gate
        new = aggregation.staged_mean(mid, weights, top, top_mask)
        received = gate > 0  # this client's unit got the broadcast

        def select(n, m):
            return torch.where(received.reshape((-1,) + (1,) * (n.dim() - 1)), n, m)

        return state._replace(params=tree_map(select, new, mid))

    def deadline_round(state: FedState, batches, gate: torch.Tensor, masks: Optional[torch.Tensor] = None):
        losses, gnorms, steps = [], [], []
        for r, deepest in enumerate(schedule):
            state, loss, gnorm = _edge_interval(local_step, state, _step_slice(batches, r), config.kappa1)
            mask = None if masks is None else masks[r]
            if deepest == depth:
                state = gated_top_sync(state, mask, gate)
            else:
                state = level_syncs[deepest - 1](state, mask)
            losses.append(loss)
            gnorms.append(gnorm)
            steps.append(state.step)
        metrics = {"loss": torch.stack(losses), "grad_norm": torch.stack(gnorms), "step": torch.stack(steps)}
        return state, metrics

    return deadline_round


# ---------------------------------------------------------------------------
# Client-blocked megakernel lowering
# ---------------------------------------------------------------------------


def megakernel_incompatibility(config: HierFAVGConfig, topology: Topology, *, grad_accum: int = 1) -> Optional[str]:
    """Why this schedule cannot run through the client-blocked lowering
    (``build_megakernel_super_round``), or None when it can:
    ``build_megakernel_super_round`` raises on a reason, the engine reports
    it and runs the superround. The
    reasons and their words are the JAX package's
    (``repro/core/hierfavg.py:1135-1166``)."""
    spec = as_hierarchy(topology)
    if not spec.is_paper_topology:
        return (
            f"the megakernel lowering is two-level uniform "
            f"(clients/edges/cloud) only, got {spec.describe()}"
        )
    if config.delta_cloud:
        return "delta_cloud's anchor bookkeeping keeps the scan-fused path"
    if config.transport_active:
        return "compressed transports (codec round-trips, EF residuals) keep the scan-fused path"
    if config.aggregators_active:
        return "non-default aggregators need the full client axis at each sync"
    if config.participation_active:
        return "sampled participation runs through the cohort engine"
    if config.sync_opt_state:
        return "optimizer-state averaging keeps the scan-fused path"
    if grad_accum != 1:
        return "microbatch accumulation keeps the scan-fused path"
    return None


def _megakernel_block_clients(clients_per_edge: int, bytes_per_client: int) -> int:
    """Client-block size: the largest divisor of ``clients_per_edge`` whose
    block of param and optimizer rows fits the JAX package's 4 MiB
    residency budget. Blocks never straddle an edge."""
    budget = 4 << 20
    best = 1
    for b in range(1, clients_per_edge + 1):
        if clients_per_edge % b == 0 and b * bytes_per_client <= budget:
            best = b
    return best


def build_megakernel_super_round(
    loss_fn: LossFn,
    optimizer: GradientTransformation,
    topology: Topology,
    config: HierFAVGConfig,
    weights: torch.Tensor,
    *,
    grad_accum: int = 1,
    block_clients: Optional[int] = None,
):
    """``build_super_round`` lowered client-major, as
    ``repro/core/hierfavg.py:1198-1364``: per edge interval, blocks of
    ``block_clients`` clients (default: ``_megakernel_block_clients``) each
    run all kappa1 local steps, then one flat weighted mean per leaf: over
    each edge (G = num_edges), or over all N clients on a cloud round
    (G = 1), so each leaf takes one K1 launch per edge interval on CUDA.

        super_round(state, batches, masks=None) -> (state, metrics)

    The same contract as ``build_super_round`` (batch leaves (kappa2,
    kappa1, N, b, ...); metrics ``loss``, ``grad_norm``, ``step`` each
    (kappa2,)), except that ``masks`` must be None. Stacked params are
    updated in place through views of each block's rows; stacked optimizer
    rows are rebuilt per edge interval, and a shared scalar (the schedule
    count) steps identically in every block, so the first block's value is
    kept. Only the order of the mean and metric sums differs from the
    superround.

    The JAX lowering precomputes its per-step threefry key table
    (``_rng_step_table``) so that its keys equal the superround's. Here
    both paths hand every loss call the same ``FedState.rng`` and neither
    draws from it (``vmap`` refuses random draws), so the generator ends in
    the superround's state by construction.

    K1 keeps a zero-weight group's rows where JAX divides by the unguarded
    sum of weights; with no masks the runner's weights are partition
    sizes, so no group weighs zero and the two agree.
    """
    spec = as_hierarchy(topology)
    depth = _check_levels(spec, config)
    reason = megakernel_incompatibility(config, spec, grad_accum=grad_accum)
    if reason is not None:
        raise ValueError(f"schedule cannot run through the megakernel: {reason}")
    n = spec.num_clients
    num_edges = spec.num_nodes(1)
    cpe = n // num_edges
    k1 = config.kappa1
    schedule = super_round_schedule(config)
    w = weights.to(torch.float32)
    grad_fn = _client_grads(loss_fn, config.precision)

    def block_steps(params, opt, batches, j, lo, hi, rng):
        """All kappa1 steps of clients [lo, hi): ``params`` are views of
        their rows (updated in place), ``opt`` their optimizer state.
        Returns (opt, losses (kappa1, Bc) f32, squared grad norms
        (kappa1, Bc) f32)."""
        losses_t, gsq_t = [], []
        for t in range(k1):
            batch = {k: v[j, t, lo:hi] for k, v in batches.items()}
            grads, losses = grad_fn(params, batch, rng)
            updates, opt = optimizer.update(grads, opt, params)
            apply_updates(params, updates)
            losses_t.append(losses.to(torch.float32))
            gsq_t.append(sum(
                torch.sum(torch.square(g.to(torch.float32)).reshape(g.shape[0], -1), dim=1) for g in leaves(grads)
            ))
        return opt, torch.stack(losses_t), torch.stack(gsq_t)

    def super_round(state: FedState, batches, masks: Optional[torch.Tensor] = None):
        if masks is not None:
            raise TypeError(
                "the megakernel superround takes no survival masks; failure "
                "models are routed to the scan-fused engine by eligibility"
            )
        params = state.params
        opt_leaves, opt_def = tree_flatten(state.opt_state)
        for leaf in opt_leaves:
            if leaf.dim() >= 1 and leaf.shape[0] != n:
                raise ValueError(
                    f"megakernel needs optimizer state leaves that are either "
                    f"scalar (shared) or stacked (N, ...); got shape {tuple(leaf.shape)}"
                )
        stacked = [leaf.dim() >= 1 for leaf in opt_leaves]
        bytes_per_client = sum(x.numel() * x.element_size() // n for x in leaves(params)) + sum(
            x.numel() * x.element_size() // n for x, s in zip(opt_leaves, stacked) if s
        )
        bc = block_clients if block_clients is not None else _megakernel_block_clients(cpe, max(1, bytes_per_client))
        if cpe % bc != 0:
            raise ValueError(f"block_clients={bc} does not divide clients_per_edge={cpe}")
        step0 = state.step
        loss_r, gnorm_r, step_r = [], [], []
        for j, deepest in enumerate(schedule):
            new_opt, losses, gsq = [], [], []
            for lo in range(0, n, bc):
                hi = lo + bc
                block_params = tree_map(lambda v: v[lo:hi], params)
                block_opt = tree_unflatten([x[lo:hi] if s else x for x, s in zip(opt_leaves, stacked)], opt_def)
                opt_b, loss_b, gsq_b = block_steps(block_params, block_opt, batches, j, lo, hi, state.rng)
                new_opt.append(tree_flatten(opt_b)[0])
                losses.append(loss_b)
                gsq.append(gsq_b)
            opt_leaves = [
                torch.cat([blk[i] for blk in new_opt]) if s else new_opt[0][i] for i, s in enumerate(stacked)
            ]
            ls, gs = torch.cat(losses, dim=1), torch.cat(gsq, dim=1)  # (kappa1, N), client order
            loss_r.append(torch.mean(ls))
            gnorm_r.append(torch.mean(torch.sqrt(torch.sum(gs, dim=1))))
            step_r.append(step0 + (j + 1) * k1)
            groups = 1 if deepest == depth else num_edges
            params = aggregation.grouped_weighted_mean(params, w, groups)
        new_state = state._replace(
            step=step0 + k1 * len(schedule), params=params, opt_state=tree_unflatten(opt_leaves, opt_def)
        )
        metrics = {"loss": torch.stack(loss_r), "grad_norm": torch.stack(gnorm_r), "step": torch.stack(step_r)}
        return new_state, metrics

    return super_round


# ---------------------------------------------------------------------------
# Sampled-participation (cohort) lowering
# ---------------------------------------------------------------------------


def cohort_incompatibility(config: HierFAVGConfig, topology: Topology, cohort_size: int) -> Optional[str]:
    """None if the schedule can run cohort-sampled, else why not, in the
    JAX package's words (``repro/core/hierfavg.py:1367-1392``): the one
    predicate ``build_cohort_super_round`` (raises) and the runner (reports)
    consult."""
    spec = as_hierarchy(topology)
    if config.aggregators_active:
        return "a robust statistic over a sampled cohort is not the population statistic"
    if not 1 <= int(cohort_size) <= spec.num_clients:
        return f"cohort_size {cohort_size} outside 1..{spec.num_clients} (population)"
    part = config.participation
    if part is not None and getattr(part, "sampler", None) == "stratified" and spec.depth >= 2:
        num_edges = spec.num_nodes(1)
        if int(cohort_size) < num_edges:
            return (
                f"stratified sampling needs cohort_size >= num_edges "
                f"({cohort_size} < {num_edges}): every alive edge gets a "
                f"floor-1 quota, so a smaller cohort cannot cover the edges"
            )
    return None


def init_cohort_state(
    rng: torch.Generator,
    params: Params,
    optimizer: GradientTransformation,
    config: HierFAVGConfig,
    cohort_size: int,
) -> FedState:
    """The cohort-resident ``FedState``: C stacked rows, not N. Its zero
    optimizer and residual rows are what ``ClientStateStore`` hands back
    for never-sampled clients, so a fresh state is "every member
    participates for the first time"."""
    stacked = replicate_for_clients(params, int(cohort_size))
    return init_state(rng, stacked, optimizer, None, config, already_stacked=True)


def _with_stages(cohort: Dict[str, Any], cohort_size: int, device: torch.device) -> Dict[str, Any]:
    """The cohort dict with its weights on ``device`` and its stages built
    (``aggregation.cohort_stages``) when the caller passed only JAX's
    ``{"segments", "weights"}``; the engine's prefetcher builds and uploads
    them ahead."""
    w = cohort["weights"]
    w = w.to(device) if isinstance(w, torch.Tensor) else torch.as_tensor(np.asarray(w, np.float32), device=device)
    if "stages" in cohort:
        return {**cohort, "weights": w}
    seg = cohort["segments"]
    seg = seg.cpu().numpy() if isinstance(seg, torch.Tensor) else np.asarray(seg)
    return {**cohort, "weights": w, "stages": aggregation.cohort_stages(seg, cohort_size)}


def _build_cohort_level_sync(spec: HierarchySpec, config: HierFAVGConfig, level: int, cohort_size: int):
    """``build_level_sync`` lowered for a sampled cohort
    (``repro/core/hierfavg.py:1411-1510``):
    ``level_sync(state, cohort, mask=None)``.

    The cohort's per-level segment ids change every interval and arrive in
    ``cohort["stages"]`` (``aggregation.cohort_stages``: the members'
    original node ids, compacted to the nodes the cohort holds), with its
    (C,) weights in ``cohort["weights"]``. Nodes with no sampled member
    contribute nothing, so clients outside the cohort carry zero weight in
    every mean: the partial-participation HierFAVG semantics. The top stage
    maps every member to the root (K1 with G = 1, as the full-population
    top stage); compacted sub-top ids that form equal blocks take K1 too,
    ragged ones K2 with the table uploaded beside the cohort. ``mask`` is an
    optional (C,) survival vector over the cohort's columns; the codec's
    keep-dead rules, ``delta_cloud`` and ``sync_opt_state`` are
    ``build_level_sync``'s."""
    is_top = level == spec.depth
    if is_top and config.delta_cloud and config.sync_opt_state:
        raise ValueError("delta_cloud + sync_opt_state do not compose (the optimizer state has no anchor)")
    codec = _level_codec(config, level)

    def level_sync(state: FedState, cohort: Dict[str, Any], mask: Optional[torch.Tensor] = None) -> FedState:
        weights = cohort["weights"]
        stages = cohort["stages"][:level]
        st = stages[-1]
        seg = st.device_ids if st.device_ids is not None else torch.as_tensor(st.ids, device=weights.device)
        mean = lambda t: aggregation.staged_mean(t, weights, stages, mask)
        return _sync_state(state, config, codec, is_top, weights, mask, mean, seg, st.num_segments)

    return level_sync


def build_cohort_super_round(
    loss_fn: LossFn,
    optimizer: GradientTransformation,
    topology: Topology,
    config: HierFAVGConfig,
    *,
    cohort_size: int,
    grad_accum: int = 1,
):
    """``build_super_round`` for a sampled cohort of C clients
    (``repro/core/hierfavg.py:1513-1581``):

        super_round(state, batches, cohort, masks=None) -> (state, metrics)

    ``state`` stacks C rows (``init_cohort_state``); batch leaves carry a
    leading (kappa2_eff, kappa1) pair over cohort-shaped batches;
    ``cohort`` is ``{"segments": (depth-1, C) original node ids, "weights":
    (C,)}`` as in JAX, or the engine's prefetched form, which adds the
    built ``"stages"``; ``masks`` is an optional (kappa2_eff, C) stack of
    survival vectors over the cohort's columns. Metrics as
    ``build_super_round``'s. With the identity cohort (C = N, the full
    population's weights and segments) this is ``build_super_round``'s
    computation op for op, so the two agree bit for bit.
    """
    spec = as_hierarchy(topology)
    depth = _check_levels(spec, config)
    reason = cohort_incompatibility(config, spec, cohort_size)
    if reason is not None:
        raise ValueError(f"schedule cannot run cohort-sampled: {reason}")
    local_step = build_local_step(loss_fn, optimizer, grad_accum=grad_accum, precision=config.precision)
    level_syncs = [_build_cohort_level_sync(spec, config, lvl, cohort_size) for lvl in range(1, depth + 1)]
    schedule = super_round_schedule(config)

    def super_round(state: FedState, batches, cohort, masks: Optional[torch.Tensor] = None):
        cohort = _with_stages(cohort, cohort_size, first_leaf(state.params).device)
        losses, gnorms, steps = [], [], []
        for r, deepest in enumerate(schedule):
            state, loss, gnorm = _edge_interval(local_step, state, _step_slice(batches, r), config.kappa1)
            state = level_syncs[deepest - 1](state, cohort, None if masks is None else masks[r])
            losses.append(loss)
            gnorms.append(gnorm)
            steps.append(state.step)
        metrics = {"loss": torch.stack(losses), "grad_norm": torch.stack(gnorms), "step": torch.stack(steps)}
        return state, metrics

    return super_round


# ---------------------------------------------------------------------------
# Client-sharded lowering (one process per shard of a RankMesh)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ClientSharding:
    """How this rank sees the tree of a client-sharded state
    (``repro/core/hierfavg.py:444-494``): a ``core.hierarchy.ShardPlacement``,
    the global weights permuted and padded into a (num_shards, capacity)
    table, and the ``mesh`` (a ``dist.sharding.RankMesh``) whose rank
    picks the row. JAX selects the row inside ``shard_map`` with
    ``lax.axis_index``; here the rank is known on the host, so
    ``local_weights`` is this rank's row on its device and
    ``local_segments`` its host ids. ``static_segments`` is the concrete
    layout when every rank has the same one (uniform packing), so a
    uniform layout reaches K1 and a robust aggregator may run.

    ``edge`` (a 1-D ``RankMesh``, or None) is set when each edge spans
    several ranks of a two-level tree, every rank's clients inside one
    edge (the train cell on a production mesh: one client a rank, 4 ranks
    an edge): the mesh of the ranks that share this rank's edge, over
    whose group the edge sync all-reduces (``_build_sharded_level_sync``)."""

    axis: str
    placement: ShardPlacement
    weights_table: Any  # np (num_shards, capacity) f32 permuted + padded weights
    mesh: Any = None  # dist.sharding.RankMesh (None: rank 0 on the weights' device)
    edge: Any = None  # dist.sharding.RankMesh of this rank's edge when edges span ranks
    _cache: Dict[Any, Any] = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def build(cls, axis: str, placement: ShardPlacement, weights, mesh=None, edge=None) -> "ClientSharding":
        w = weights.cpu().numpy() if isinstance(weights, torch.Tensor) else np.asarray(weights)
        table = placement.pad_weights(w).reshape(placement.num_shards, placement.capacity)
        return cls(axis=axis, placement=placement, weights_table=table, mesh=mesh, edge=edge)

    @property
    def rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.rank

    @property
    def device(self) -> torch.device:
        return torch.device("cpu") if self.mesh is None else self.mesh.device

    def local_weights(self) -> torch.Tensor:
        """(capacity,) f32: this rank's weights, phantoms at 0."""
        if "w" not in self._cache:
            self._cache["w"] = torch.as_tensor(self.weights_table[self.rank], dtype=torch.float32, device=self.device)
        return self._cache["w"]

    def _table(self, level: int) -> np.ndarray:
        key = ("seg", level)
        if key not in self._cache:
            self._cache[key] = self.placement.local_segments(level)
        return self._cache[key]

    def static_segments(self, level: int) -> Optional[np.ndarray]:
        """Concrete (capacity,) local ids when identical across ranks."""
        tab = self._table(level)
        return tab[0] if bool((tab == tab[0]).all()) else None

    def local_segments(self, level: int) -> np.ndarray:
        """(capacity,) this rank's local segment ids at ``level``."""
        return self._table(level)[self.rank]

    def local_num_segments(self, level: int) -> int:
        key = ("nseg", level)
        if key not in self._cache:
            self._cache[key] = self.placement.local_num_segments(level)
        return self._cache[key]

    def client_ids_table(self) -> np.ndarray:
        """(num_shards, capacity) original client ids (phantoms read 0)."""
        return self.placement.gather_index().reshape(self.placement.num_shards, self.placement.capacity)


def sharding_incompatibility(
    config: HierFAVGConfig,
    topology: Topology,
    num_shards: int,
    placement: Optional[ShardPlacement] = None,
) -> Optional[str]:
    """Why this schedule cannot run client-sharded over ``num_shards``
    ranks, or None when it can, in the JAX package's words
    (``repro/core/hierfavg.py:497-543``). The runner uses it for engine
    eligibility; ``build_sharded_super_round`` raises on a reason. Pass
    ``placement`` to validate the layout that will run."""
    spec = as_hierarchy(topology)
    if config.delta_cloud and config.sync_opt_state:
        return "delta_cloud + sync_opt_state do not compose (the opt tree has no anchor)"
    if placement is None:
        try:
            placement = plan_shard_placement(spec, num_shards)
        except ValueError as e:
            return str(e)
    elif placement.num_shards != num_shards or placement.spec != spec:
        return (
            f"placement was planned for {placement.num_shards} shard(s) over "
            f"{placement.spec.describe()}, not {num_shards} shard(s) over "
            f"{spec.describe()}"
        )
    if config.aggregators_active:
        if config.aggregators.depth != spec.depth:
            return (
                f"aggregators cover {config.aggregators.depth} level(s) but "
                f"the tree has depth {spec.depth}"
            )
        if not config.aggregators.aggregator(spec.depth).is_default:
            return (
                "a non-default top-level aggregator needs global order "
                "statistics across shards; only weighted_mean lowers to the "
                "cloud psum"
            )
        for lvl in range(1, spec.depth):
            if not config.aggregators.aggregator(lvl).is_default:
                tab = placement.local_segments(lvl)
                if not bool((tab == tab[0]).all()):
                    return (
                        f"the robust aggregator at level {lvl} needs an "
                        f"identical per-shard segment layout (this packing "
                        f"is ragged across shards)"
                    )
    return None


def map_stacked_fed_state(state: FedState, stacked_fn, other_fn, stacked_dim: int) -> FedState:
    """A ``FedState`` with ``stacked_fn`` applied to every params /
    opt_state / anchor / residual leaf that carries the leading
    ``stacked_dim`` client axis and ``other_fn`` to everything else
    (``step`` and ``rng`` are always "other"). The one place that knows which
    fields carry client rows: the slice helpers and the engine's permute,
    pad, slice and gather all go through it."""

    def leaf(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] == stacked_dim:
            return stacked_fn(x)
        return other_fn(x)

    sub = lambda t: tree_map(leaf, t)
    return FedState(
        step=other_fn(state.step),
        params=sub(state.params),
        opt_state=sub(state.opt_state),
        rng=other_fn(state.rng),
        anchor=None if state.anchor is None else sub(state.anchor),
        residual=None if state.residual is None else sub(state.residual),
    )


def fed_state_partition_specs(state: FedState, axis: str, stacked_dim: int) -> FedState:
    """The partition of a (padded) stacked ``FedState``: ``axis`` for leaves
    whose leading ``stacked_dim`` client axis is split over the ranks, ""
    for replicated ones (step, rng, scalar optimizer leaves), the
    counterpart of JAX's ``P(axis)`` / ``P()``. ``dist.sharding.
    fed_state_shardings`` turns them into this rank's slices."""
    return map_stacked_fed_state(state, lambda _: axis, lambda _: "", stacked_dim)


def _sharded_opt_leaves(opt_state) -> Tuple[list, list]:
    """(the optimizer's leaves, the indices of the stacked ones)."""
    flat = list(leaves(opt_state))
    return flat, [i for i, x in enumerate(flat) if isinstance(x, torch.Tensor) and x.dim() >= 1]


def _build_sharded_level_sync(spec: HierarchySpec, config: HierFAVGConfig, level: int, codec, robust,
                              shard: ClientSharding):
    """The ``shard`` lowering of ``build_level_sync``
    (``repro/core/hierfavg.py:672-797``): sub-top levels reduce entirely on
    this rank (the placement keeps their groups whole on one rank) through
    the staged segment means, K1 on equal blocks and K2 on ragged ones; the
    top level stages up to depth - 1 on the rank, then packs params (and,
    with ``sync_opt_state``, the stacked optimizer leaves) into one
    ``psum_weighted_mean``, one all-reduce. The codec's round trip (K4/K5 on
    each rank), the error-feedback residual, robust sub-top aggregators and
    the keep-dead rules are per client or per group and stay on the rank.
    Sub-top syncs add members in the single-device order; only the cloud
    sum reassociates. An edge that spans ranks (``shard.edge``: each rank's
    clients inside one edge of a two-level tree) takes the top's form over
    the edge's ranks: the rank's mean, then one all-reduce over them
    (counted as ``"edge_all_reduce"``), whose "had a survivor" the keep-dead
    rules reuse."""
    depth = spec.depth
    is_top = level == depth
    edge = None if is_top else shard.edge
    if robust is not None:
        if is_top:
            raise ValueError(
                "a non-default top-level aggregator cannot run client-sharded "
                "(global order statistics); see sharding_incompatibility"
            )
        if edge is not None:
            raise ValueError(
                f"a non-default aggregator at level {level} cannot run on edges that span ranks "
                "(order statistics over several ranks); see sharding_incompatibility"
            )
        if shard.static_segments(level) is None:
            raise ValueError(
                f"robust aggregator at level {level} needs an identical "
                f"per-shard segment layout; see sharding_incompatibility"
            )
    if is_top and config.delta_cloud and config.sync_opt_state:
        raise ValueError("delta_cloud + sync_opt_state cannot run client-sharded")
    # the rank's stages, built once: its segments are static per placement
    stages = tuple(aggregation._stage(shard.local_segments(l), shard.local_num_segments(l))
                   for l in range(1, (depth - 1 if is_top else level) + 1))
    dev = shard.device
    ids = None if is_top else torch.as_tensor(shard.local_segments(level), dtype=torch.long, device=dev)
    nseg = None if is_top else shard.local_num_segments(level)

    def level_sync(state: FedState, mask: Optional[torch.Tensor] = None) -> FedState:
        w_local = shard.local_weights()
        uploaded = state.params
        residual = state.residual
        if codec is not None:
            delta = tree_map(lambda x, a: x.to(torch.float32) - a.to(torch.float32), state.params, state.anchor)
            delta_hat, residual = codec.roundtrip(delta, residual)
            uploaded = tree_map(lambda a, d, x: (a.to(torch.float32) + d).to(x.dtype),
                                state.anchor, delta_hat, state.params)
        agg = None
        synced_opt = None
        alive = None  # a group on several ranks: "the group had a survivor"
        if is_top and config.delta_cloud and state.anchor is not None:
            params, alive = aggregation.psum_weighted_mean(uploaded, w_local, shard.mesh, mask,
                                                           anchor=state.anchor)
            anchor = _copy(params)
        elif is_top:
            # params (+ the synced optimizer leaves) in one packed all-reduce
            bundle: Dict[str, Any] = {"p": uploaded}
            if config.sync_opt_state:
                opt_flat, sync_ix = _sharded_opt_leaves(state.opt_state)
                bundle["o"] = [opt_flat[i] for i in sync_ix]
            staged = aggregation.staged_mean(bundle, w_local, stages, mask)
            out, alive = aggregation.psum_weighted_mean(staged, w_local, shard.mesh, mask)
            params = out["p"]
            if config.sync_opt_state:
                for i, new in zip(sync_ix, out["o"]):
                    opt_flat[i] = new
                synced_opt = unflatten(state.opt_state, opt_flat)
            anchor = _copy(params) if config.transport_active else state.anchor
        else:
            if robust is not None:
                static = shard.static_segments(level)
                agg = lambda t: robust.segment_call(t, static, nseg, mask)
            elif edge is not None:
                def agg(t):
                    nonlocal alive
                    out, alive = aggregation.psum_weighted_mean(aggregation.staged_mean(t, w_local, stages, mask),
                                                                w_local, edge, mask, counter="edge_all_reduce")
                    return out
            else:
                agg = lambda t: aggregation.staged_mean(t, w_local, stages, mask)
            params = agg(uploaded)
            anchor = _copy(params) if config.transport_active else state.anchor
        if codec is not None:
            # the single-device keep-dead rules; a group on several ranks (the
            # top's tree, a spanning edge) had a survivor if its all-reduce said so
            w_eff = w_local.to(torch.float32)
            if mask is not None:
                w_eff = w_eff * mask.to(torch.float32)
            if alive is not None:
                received = alive
            else:
                den = torch.zeros(nseg, dtype=torch.float32, device=w_eff.device).index_add_(0, ids, w_eff)
                received = (den > 0)[ids]
            sent = w_eff > 0

            def keep(flags, new, old):
                f = flags.reshape((-1,) + (1,) * (new.dim() - 1)) if flags.dim() else flags
                return torch.where(f, new, old.to(new.dtype))

            params = tree_map(lambda v, old: keep(received, v, old), params, state.params)
            anchor = tree_map(lambda v, old: keep(received, v, old), anchor, state.anchor)
            if residual is not None and state.residual is not None:
                residual = tree_map(lambda v, old: keep(sent, v, old), residual, state.residual)
        if synced_opt is not None:
            opt_state = synced_opt
        else:
            opt_state = _maybe_sync_opt_state(state.opt_state, agg, config.sync_opt_state and agg is not None)
        return state._replace(params=params, opt_state=opt_state, anchor=anchor, residual=residual)

    return level_sync


def _sharded_local_step(loss_fn: LossFn, optimizer: GradientTransformation, precision: Optional[PrecisionSpec],
                        grad_accum: int = 1, model=None):
    """``build_local_step`` with per-client metrics: ``local_step(state,
    batch) -> (state, losses (C,) f32, squared grad norms (C,) f32)``. The
    update is ``build_local_step``'s op for op; ``model`` as there."""
    grad_fn = _client_grads(loss_fn, precision, grad_accum)

    def local_step(state: FedState, batch):
        grads, losses = grad_fn(state.params, batch, state.rng)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        apply_updates(state.params, updates)
        sq = [torch.sum(torch.square(g.to(torch.float32)).reshape(g.shape[0], -1), dim=1) for g in leaves(grads)]
        gsq = sum(sq) if model is None else model.sum_sq(sq)
        return state._replace(step=state.step + 1, opt_state=opt_state), losses.to(torch.float32), gsq

    return local_step


def _sharded_rounds(local_step, level_syncs, schedule, k1: int):
    """The cloud interval of the sharded lowerings: per round kappa1 local
    steps and its sync; per-client metrics ``{"loss", "gsq"}`` (kappa2,
    kappa1, C) and ``"step"`` (kappa2,), on the device."""

    def rounds(state: FedState, batches, masks):
        losses, gsqs, steps = [], [], []
        for r, deepest in enumerate(schedule):
            batch_r = _step_slice(batches, r)
            ls, gs = [], []
            for j in range(k1):
                state, loss, gsq = local_step(state, _step_slice(batch_r, j))
                ls.append(loss)
                gs.append(gsq)
            state = level_syncs[deepest - 1](state, None if masks is None else masks[r])
            losses.append(torch.stack(ls))
            gsqs.append(torch.stack(gs))
            steps.append(state.step)
        return state, {"loss": torch.stack(losses), "gsq": torch.stack(gsqs), "step": torch.stack(steps)}

    return rounds


def build_sharded_super_round(
    loss_fn: LossFn,
    optimizer: GradientTransformation,
    topology: Topology,
    config: HierFAVGConfig,
    weights,
    *,
    mesh,
    axis: str = "clients",
    placement: Optional[ShardPlacement] = None,
    grad_accum: int = 1,
):
    """``build_super_round`` with the stacked client axis sharded over the
    ranks of ``mesh`` (a ``dist.sharding.RankMesh``;
    ``repro/core/hierfavg.py:1619-1771``): the hardware mirrors the
    client-edge-cloud tree.

        super_round(state, batches, masks=None) -> (state, metrics)

    Called on every rank with that rank's rows: the state's stacked leaves
    hold its ``placement.capacity`` positions of the placement order
    (``placement.gather_index()``, phantoms padded), batch leaves are
    (kappa2, kappa1, capacity, b, ...) (with ``grad_accum`` > 1 the
    microbatch axis comes first and the client dim is 3: (kappa2, kappa1,
    grad_accum, capacity, b, ...)) and ``masks`` an optional (kappa2,
    capacity) stack (``fed.engine`` owns the conversion). Every
    sub-top sync is rank-local and each cloud boundary is one all-reduce.
    Local steps and sub-top syncs match the single-device superround bit
    for bit; only the cloud sum reassociates. Metrics stay per client, so
    no collective is spent on them: ``{"loss": (kappa2, kappa1, capacity),
    "gsq": (kappa2, kappa1, capacity), "step": (kappa2,)}``, reduced on the
    host at flush (phantom columns dropped)."""
    spec = as_hierarchy(topology)
    depth = _check_levels(spec, config)
    num_shards = int(mesh.shape[axis])
    if placement is None:
        try:
            placement = plan_shard_placement(spec, num_shards)
        except ValueError as e:
            raise ValueError(f"schedule cannot run client-sharded: {e}") from None
    reason = sharding_incompatibility(config, spec, num_shards, placement=placement)
    if reason is not None:
        raise ValueError(f"schedule cannot run client-sharded: {reason}")
    shard = ClientSharding.build(axis, placement, weights, mesh=mesh)
    local_step = _sharded_local_step(loss_fn, optimizer, config.precision, grad_accum)
    level_syncs = [build_level_sync(spec, config, weights, lvl, shard=shard) for lvl in range(1, depth + 1)]
    rounds = _sharded_rounds(local_step, level_syncs, super_round_schedule(config), config.kappa1)

    def super_round(state: FedState, batches, masks: Optional[torch.Tensor] = None):
        return rounds(state, batches, masks)

    super_round.shard = shard
    return super_round


# ---------------------------------------------------------------------------
# Sharded cohort lowering (population scale x device scale)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class _CohortSharding(ClientSharding):
    """``ClientSharding`` over a sampled cohort's *slot* axis
    (``repro/core/hierfavg.py:1773-1794``). The slot layout, and so every
    local segment table, is static; the weights are the sampled cohort's
    columns, bound per interval (``bind_local_weights``) before any sync."""

    def bind_local_weights(self, w_local: torch.Tensor) -> None:
        self._cache["w"] = w_local

    def local_weights(self) -> torch.Tensor:
        w = self._cache.get("w")
        if w is None:
            raise RuntimeError(
                "cohort shard weights are bound per interval; call bind_local_weights first"
            )
        return w


def _cohort_quotas(spec: HierarchySpec, cohort_size: int) -> np.ndarray:
    """Per-level-1-node stratified slot quotas: the pure function of
    (topology, cohort_size) that placement-stable packing rests on."""
    if spec.depth == 1:
        return np.asarray([int(cohort_size)], np.int64)
    from repro_torch.fed.participation import stratified_quotas

    return stratified_quotas(spec.group_sizes(1), int(cohort_size))


def sharded_cohort_incompatibility(
    config: HierFAVGConfig,
    topology: Topology,
    cohort_size: int,
    num_shards: int,
    placement: Optional[ShardPlacement] = None,
) -> Optional[str]:
    """Why this schedule cannot run cohort-sampled AND client-sharded over
    ``num_shards`` ranks, or None, in the JAX package's words
    (``repro/core/hierfavg.py:1808-1854``): the one predicate
    ``build_sharded_cohort_super_round`` (raises) and the runner (reports)
    consult. Only the stratified sampler's per-edge quotas fix the
    slot -> rank layout."""
    spec = as_hierarchy(topology)
    reason = cohort_incompatibility(config, spec, cohort_size)
    if reason is not None:
        return reason
    part = config.participation
    if part is not None and getattr(part, "sampler", None) != "stratified" and spec.depth >= 2:
        return (
            f"sharded cohorts need the stratified sampler (placement-stable "
            f"per-edge quotas fix the slot->shard layout); got "
            f"{getattr(part, 'sampler', None)!r}"
        )
    if config.delta_cloud and config.sync_opt_state:
        return "delta_cloud + sync_opt_state do not compose (the opt tree has no anchor)"
    try:
        quotas = _cohort_quotas(spec, cohort_size)
    except ValueError as e:
        return str(e)
    if placement is None:
        try:
            plan_cohort_placement(spec, quotas, num_shards)
        except ValueError as e:
            return str(e)
    else:
        slot_spec = cohort_hierarchy(spec, quotas)
        if placement.num_shards != num_shards or placement.spec != slot_spec:
            return (
                f"placement was planned for {placement.num_shards} shard(s) over "
                f"{placement.spec.describe()}, not {num_shards} shard(s) over "
                f"the {slot_spec.describe()} cohort slot tree"
            )
    return None


def build_sharded_cohort_super_round(
    loss_fn: LossFn,
    optimizer: GradientTransformation,
    topology: Topology,
    config: HierFAVGConfig,
    *,
    cohort_size: int,
    mesh,
    axis: str = "clients",
    placement: Optional[ShardPlacement] = None,
    grad_accum: int = 1,
):
    """``build_cohort_super_round`` with the cohort's slot axis sharded over
    the ranks of ``mesh`` (``repro/core/hierfavg.py:1857-2013``).

        super_round(state, batches, weights, masks=None) -> (state, metrics)

    Under stratified sampling the per-edge quotas are a pure function of
    (topology, cohort_size), so the slot tree (slot j always reports to the
    same edge) and its placement are planned once and reused for every
    cohort: the rank-local segment tables are static (K1 on equal blocks,
    K2 on ragged ones), and only ``weights``, this rank's (capacity,) slice
    of the sampled cohort's weights in slot placement order (phantoms 0),
    changes per interval. The state, the blocks and ``masks`` are this
    rank's rows, as in ``build_sharded_super_round``; each cloud boundary
    is one all-reduce and the metrics are per slot."""
    spec = as_hierarchy(topology)
    depth = _check_levels(spec, config)
    num_shards = int(mesh.shape[axis])
    reason = sharded_cohort_incompatibility(config, spec, cohort_size, num_shards, placement=placement)
    if reason is not None:
        raise ValueError(f"schedule cannot run sharded-cohort: {reason}")
    if placement is None:
        placement = plan_cohort_placement(spec, _cohort_quotas(spec, cohort_size), num_shards)
    shard = _CohortSharding(axis=axis, placement=placement, weights_table=None, mesh=mesh)
    local_step = _sharded_local_step(loss_fn, optimizer, config.precision, grad_accum)
    # robust is always None: cohort_incompatibility rejects robust aggregators
    level_syncs = [_build_sharded_level_sync(placement.spec, config, lvl, _level_codec(config, lvl), None, shard)
                   for lvl in range(1, depth + 1)]
    rounds = _sharded_rounds(local_step, level_syncs, super_round_schedule(config), config.kappa1)

    def super_round(state: FedState, batches, weights: torch.Tensor, masks: Optional[torch.Tensor] = None):
        shard.bind_local_weights(weights.to(torch.float32))
        return rounds(state, batches, masks)

    super_round.shard = shard
    return super_round
