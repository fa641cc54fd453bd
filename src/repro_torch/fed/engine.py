"""Superround execution engine: one cloud interval per dispatch.

Port of the single-device ``SuperRoundEngine`` of ``repro.fed.engine``. The
paper's protocol needs the host only at cloud boundaries, so the engine
runs a whole cloud interval (kappa2_eff edge intervals of kappa1 local steps
plus their syncs) per ``build_super_round`` call and removes per-round host
costs:

* **State updated in place** — where the JAX engine donates the
  ``FedState`` to its jitted superround (``repro/fed/engine.py:146``), the
  port updates the stacked parameters in place (``optim.apply_updates``);
  the caller's state is consumed. A sync and the optimizer give fresh
  tensors, so each interval's stacked leaves are copied back into those
  of the state the caller passed (``_write_back``): a caller that keeps its
  ``state`` while ``run`` runs (``state = runner.run(state)``) holds the
  live state, not a second one beside it. A compressed transport's anchor
  and error-feedback residual ride along in the ``FedState``: each sync
  replaces them with fresh tensors, never views of the parameters that the
  next local step updates in place.
* **Async metrics** — per-round loss / grad-norm / step stay device tensors
  until ``_flush`` at an eval point or the end of the run, where one host
  fetch per cloud interval rebuilds the ``RoundRecord`` history.
* **Batch prefetch** — a ``data.pipeline.SuperBatchPrefetcher`` worker
  assembles interval r+1's (kappa2, kappa1, N, b, ...) block in pinned host
  memory while interval r computes.

With ``RunnerConfig.engine="megakernel"`` the engine builds the
client-blocked ``build_megakernel_super_round`` when the runner's
``_check_megakernel`` finds no reason against it (``uses_megakernel``), and
otherwise the superround, keeping the reason on ``megakernel_reason``: the
fallback is reported, never silent (``repro/fed/engine.py:92-137``).

Failure and straggler models give each round of an interval its survival
mask on the host (``_masks_for_interval``, through the runner's
``_mask_for_round``): one (kappa2, N) stack moves to the device once per
interval, the boundary eval scores the cloud model under the last round's
mask, and the alive counts go into the flushed records. Without a model
(and with the runner's own ``_mask_for_round``) the host work is skipped.
A ``checkpointer`` saves at cloud boundaries that land on
``checkpoint_every``, with the prefetcher's batcher snapshot for that
block.

Nothing in this path synchronises the device except those fetches, the
eval and the checkpoint saves.

``DeadlineEngine`` runs semi-synchronous cloud rounds: a host
``fed.deadline.SemiSyncScheduler`` plans each interval, trivial plans run
the stock superround and the others the gated
``build_deadline_super_round``.

``CohortEngine`` is the engine for sampled participation: only the C
sampled clients live on the device, their sticky optimizer and residual
rows swap in and out of the host ``ClientStateStore`` around each cloud
interval, and a ``CohortPrefetcher`` draws the cohorts and uploads their
blocks and aggregation tables ahead of time.

**Mesh execution** (``repro/fed/engine.py:80-190``, ``:525-670``). With a
runner mesh (``dist.sharding.RankMesh``) both engines run one process per
rank: ``SuperRoundEngine`` builds ``build_sharded_super_round`` over the
edge-aligned ``ShardPlacement`` and ``CohortEngine``
``build_sharded_cohort_super_round`` over the cohort's slot placement.
Each rank keeps only its rows of the placement-ordered state (``_shard``),
uploads only its columns of each block and mask stack (the host pipeline
builds the whole block on every rank, deterministic from the seed, and
keeps the rank's part) and makes one all-reduce per cloud interval. The
per-client metrics are gathered and reduced on the host at flush. At an
eval the cloud model is scored from one packed all-reduce of the ranks'
partial sums (``aggregation.psum_cloud_model``, counted apart from the
cloud interval's one as ``eval_all_reduce``), at a checkpoint
and at the end of ``run_intervals`` the rows of every rank are gathered
back into the caller's canonical (N, ...) tensors on every rank
(``_unshard``), and only rank 0 writes the checkpoint while the others
wait at a barrier.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.checkpoint.reshard import to_mesh
from repro_torch.core import aggregation
from repro_torch.core.hierarchy import as_hierarchy, plan_cohort_placement, plan_shard_placement
from repro_torch.core.hierfavg import (
    FedState,
    _cohort_quotas,
    build_cohort_super_round,
    build_deadline_super_round,
    build_megakernel_super_round,
    build_sharded_cohort_super_round,
    build_sharded_super_round,
    build_super_round,
    map_stacked_fed_state,
)
from repro_torch.data.pipeline import CohortPrefetcher, SuperBatchPrefetcher
from repro_torch.dist import sharding as dist_sharding
from repro_torch.fed.client_store import _to_host, sticky_rows
from repro_torch.tree import leaves, tree_map, unflatten


def _write_back(into: FedState, new: FedState) -> FedState:
    """``new``'s stacked leaves copied into ``into``'s, and ``into``'s tree
    back. A leaf that is no stacked tensor in both (a scalar such as the
    step count, the generator), or whose shape, dtype or device changed, is
    ``new``'s. Where storage is shared (two leaves of ``into``, or a leaf
    of ``new`` and one of ``into``) a copy could overwrite a value still
    to be read: then nothing is copied and ``new`` comes back."""
    old, spec = tree_flatten(into)
    fresh, fresh_spec = tree_flatten(new)
    if fresh_spec != spec:
        return new
    storage = lambda t: t.untyped_storage().data_ptr()
    held = [storage(x) for x in old if isinstance(x, torch.Tensor)]
    if len(set(held)) < len(held) or any(
            isinstance(y, torch.Tensor) and y is not x and storage(y) in held for x, y in zip(old, fresh)):
        return new
    out = []
    for x, y in zip(old, fresh):
        if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor) and x.dim() > 0 and (
                x.shape == y.shape and x.dtype == y.dtype and x.device == y.device):
            out.append(x.copy_(y) if x is not y else x)
        else:
            out.append(y)
    return tree_unflatten(out, spec)


class _MeshLayout:
    """One rank's view of a placement-ordered client axis: which canonical
    rows (``gather``) and real positions (``valid``) it holds, and the
    conversions between the caller's canonical state and the rank's rows,
    all through ``dist.sharding``'s ``RowSharding`` helpers over ``gather``."""

    def __init__(self, mesh, placement, num_rows: int):
        self.mesh = mesh
        self.placement = placement
        self.num_rows = num_rows  # canonical rows: N, or the cohort's C
        self.capacity = placement.capacity
        rows = mesh.rows(placement.capacity)
        self.gather = placement.gather_index()[rows]  # (capacity,) canonical rows, phantoms read 0
        self.valid = placement.valid()  # (padded,) over every rank's positions
        self.local_valid = self.valid[rows]
        self.positions = torch.as_tensor(placement.positions(), dtype=torch.long)
        self._block = dist_sharding.batch_block_sharding(mesh, index=self.gather)
        self._masks = dist_sharding.mask_stack_sharding(mesh, index=self.gather)
        self._rows = dist_sharding.RowSharding(mesh, 0, self.gather)
        self.gather_seconds = 0.0  # host time of the state gathers (``canonical``)

    def shard(self, state: FedState) -> FedState:
        """Canonical (num_rows, ...) state -> this rank's rows on its device."""
        return to_mesh(state, dist_sharding.fed_state_shardings(
            self.mesh, self.mesh.axis, state, self.num_rows, index=self.gather))

    def canonical(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of one stacked leaf, gathered, in canonical order."""
        t0 = time.perf_counter()
        full = dist_sharding.gather_rows(x, self.mesh)
        out = full.index_select(0, self.positions.to(full.device))
        self.gather_seconds += time.perf_counter() - t0
        return out

    def unshard(self, state: FedState, into: Optional[FedState] = None) -> FedState:
        """This rank's rows -> the canonical state on every rank, gathered
        leaf by leaf and copied into ``into``'s tensors where their shapes
        match (the caller's state: the engine's write-back)."""
        held: list = []
        if into is not None:
            map_stacked_fed_state(into, held.append, lambda x: x, self.num_rows)
        local: list = []
        map_stacked_fed_state(state, local.append, lambda x: x, self.capacity)
        pairs = iter(held if len(held) == len(local) else [None] * len(local))

        def stacked(x):
            y = self.canonical(x)
            h = next(pairs)
            if isinstance(h, torch.Tensor) and h.shape == y.shape and h.dtype == y.dtype and h.device == y.device:
                return h.copy_(y)
            return y

        return map_stacked_fed_state(state, stacked, lambda x: x, self.capacity)

    def masks(self, stack: Optional[np.ndarray]) -> Optional[torch.Tensor]:
        """(kappa2, num_rows) host masks -> this rank's (kappa2, capacity)
        columns on its device, phantoms 0."""
        if stack is None:
            return None
        cols = self._masks.take(stack) * self.local_valid[None, :].astype(stack.dtype)
        return torch.as_tensor(cols, dtype=torch.float32).to(self.mesh.device)

    def block(self, x: np.ndarray) -> np.ndarray:
        """A host (kappa2, kappa1, num_rows, ...) block -> this rank's columns."""
        return self._block.take(x)

    def weights(self, w: np.ndarray) -> np.ndarray:
        """Canonical (num_rows,) host weights -> this rank's, phantoms 0."""
        return self._rows.take(w) * self.local_valid.astype(w.dtype)

    def cloud_model(self, params, weights: torch.Tensor, mask: Optional[torch.Tensor]):
        """``aggregation.cloud_model`` of the canonical params from this
        rank's rows: one packed all-reduce of the partial sums
        (``psum_cloud_model``, counted as an eval collective), not a gather
        of the stacked params. ``weights`` and ``mask`` are the
        canonical (num_rows,) ones. No survivor anywhere scores canonical
        row 0, as ``cloud_model`` does (its rows are gathered then)."""
        w = self._rows(weights) * torch.as_tensor(self.local_valid, dtype=weights.dtype, device=self.mesh.device)
        local_mask = None if mask is None else self._rows(mask)
        means, alive = aggregation.psum_cloud_model(params, w, self.mesh, local_mask)
        if not bool(alive):
            return tree_map(lambda x: self.canonical(x)[0], params)
        return means

    def reduce_metrics(self, metrics: dict) -> Tuple[np.ndarray, np.ndarray, List[int]]:
        """Per-client device metrics of one interval, gathered from every rank
        in one collective and reduced over the real clients: (loss (kappa2,),
        grad_norm (kappa2,), step)."""
        both = torch.stack([metrics["loss"], metrics["gsq"]]).movedim(-1, 0).contiguous()  # (cap, 2, k2, k1)
        vals = dist_sharding.gather_rows(both, self.mesh).cpu().numpy()[self.valid]  # (N_real, 2, k2, k1)
        loss = vals[:, 0].mean(axis=(0, 2))
        gnorm = np.sqrt(vals[:, 1].sum(axis=0)).mean(axis=1)
        return loss, gnorm, metrics["step"].tolist()


class SuperRoundEngine:
    """Drives a ``FederatedRunner`` one cloud interval per call. Built (and
    cached) by the runner; appends the same per-round history the per-round
    path would. With a runner mesh it runs this rank's rows of the
    client-sharded superround (module docstring)."""

    def __init__(self, runner):
        self.runner = runner
        hier = runner.hier_config
        self.k1 = hier.kappa1
        self.k2 = hier.kappa2_effective
        self.uses_megakernel = False
        self.megakernel_reason: Optional[str] = None
        self.mesh = getattr(runner, "mesh", None)
        self.placement = None
        self._layout: Optional[_MeshLayout] = None
        build = build_super_round
        if runner.cfg.engine == "megakernel":
            self.megakernel_reason = runner._check_megakernel()
            if self.megakernel_reason is None:
                build, self.uses_megakernel = build_megakernel_super_round, True
        if self.mesh is not None:
            axis = dist_sharding.client_axis_of(self.mesh)
            num_shards = int(self.mesh.shape[axis])
            # the runner plans (and caches) the placement for eligibility;
            # replan only for an engine built directly
            self.placement = getattr(runner, "_placement", None)
            if self.placement is None or self.placement.num_shards != num_shards:
                self.placement = plan_shard_placement(as_hierarchy(runner.topology), num_shards)
            self._super = build_sharded_super_round(
                runner.loss_fn, runner.optimizer, runner.topology, hier, runner.weights,
                mesh=self.mesh, axis=axis, placement=self.placement, grad_accum=runner.grad_accum)
            self._layout = _MeshLayout(self.mesh, self.placement, runner.topology.num_clients)
        else:
            self._super = build(runner.loss_fn, runner.optimizer, runner.topology, hier, runner.weights,
                                grad_accum=runner.grad_accum)
        # [(round_base, alive counts (k2,), device metrics {"loss",
        # "grad_norm","step"} each (k2,), or the mesh path's per-client ones)]
        self._pending: List[Tuple[int, List[int], dict]] = []

    def _masks_for_interval(self) -> Tuple[Optional[np.ndarray], List[int], Optional[np.ndarray]]:
        """kappa2 host-side survival masks stacked to (kappa2, N): returns
        (stack or None, alive count per round, the last round's mask for
        the boundary eval). Calls the failure detector once per round, the
        per-round loop's host sequence."""
        r = self.runner
        n = r.topology.num_clients
        masks = [r._mask_for_round() for _ in range(self.k2)]
        if all(m is None for m in masks):
            return None, [n] * self.k2, None
        stack = np.stack([m if m is not None else np.ones(n, np.float32) for m in masks])
        return stack, [int(row.sum()) for row in stack], stack[-1]

    def _flush(self, wire_per_step: float) -> None:
        """Pending device metrics -> RoundRecords, one host fetch per
        outstanding cloud interval, through the runner's shared helper."""
        r = self.runner
        for round_base, alive, metrics in self._pending:
            if self._layout is not None:
                loss, gnorm, step = self._layout.reduce_metrics(metrics)
                vals = {"loss": loss.tolist(), "grad_norm": gnorm.tolist(), "step": step}
            else:
                vals = {k: v.tolist() for k, v in metrics.items()}
            for j in range(self.k2):
                r._record_round(
                    round_base + j, int(vals["step"][j]), float(vals["loss"][j]),
                    float(vals["grad_norm"][j]), alive[j], wire_per_step,
                    wall_clock_s=self._wall_clock_for(round_base + j),
                )
        self._pending.clear()

    # -- seams that DeadlineEngine overrides (repro/fed/engine.py:234-264) --
    def _dispatch_interval(self, state: FedState, block, mask_stack: Optional[np.ndarray], round_base: int):
        """Run one cloud interval: upload the (kappa2, N) mask stack and
        call the superround."""
        if self._layout is not None:
            return self._super(state, block, self._layout.masks(mask_stack))
        masks = None if mask_stack is None else torch.as_tensor(mask_stack).to(self.runner.device)
        return self._super(state, block, masks)

    def _eval_mask(self, last_mask: Optional[np.ndarray]) -> Optional[np.ndarray]:
        """The mask of the cloud model the boundary eval scores."""
        return last_mask

    def _wall_clock_for(self, round_index: int) -> float:
        """Event-clock seconds at a round's close (0.0: the synchronous
        engine has no event clock)."""
        return 0.0

    def _checkpoint_meta(self, end_round: int, batcher_state: dict) -> dict:
        return self.runner._checkpoint_meta(end_round, batcher_state)

    def run_intervals(self, state: FedState, *, start_round: int, num_intervals: int) -> Tuple[FedState, bool]:
        """Run ``num_intervals`` cloud intervals from a cloud-aligned
        ``start_round``. Returns (state, stopped_early)."""
        r = self.runner
        if start_round % self.k2:
            raise ValueError(
                f"superround engine must start at a cloud boundary: "
                f"start_round={start_round} is not a multiple of {self.k2}"
            )
        wire_per_step = r._wire_bytes_per_step(state)
        stopped = False
        from repro_torch.fed.runner import FederatedRunner

        # no failure model: the all-alive triple is the same every interval
        # (an overridden _mask_for_round is a live seam and is polled)
        no_failures = (
            r.failures is None
            and r.stragglers is None
            and getattr(r._mask_for_round, "__func__", None) is FederatedRunner._mask_for_round
        )
        static_masks = (None, [r.topology.num_clients] * self.k2, None)
        layout = self._layout
        prefetcher = SuperBatchPrefetcher(
            r.batcher,
            rounds_per_block=self.k2,
            steps_per_round=self.k1,
            device=r.device,
            num_blocks=num_intervals,
            transform=None if layout is None else layout.block,
        )
        held = state  # the caller's: each interval's result goes back into its tensors
        if layout is not None:
            state = layout.shard(state)
        try:
            for q in range(num_intervals):
                round_base = start_round + q * self.k2
                block = prefetcher.get()
                mask_stack, alive, last_mask = static_masks if no_failures else self._masks_for_interval()
                state, metrics = self._dispatch_interval(state, block, mask_stack, round_base)
                if layout is None:
                    state = _write_back(held, state)
                self._pending.append((round_base, alive, metrics))
                end_round = round_base + self.k2
                do_eval = r.eval_fn is not None and r.cfg.eval_every and end_round % r.cfg.eval_every == 0
                do_ckpt = r.checkpointer is not None and r.cfg.checkpoint_every and (
                    end_round % r.cfg.checkpoint_every == 0)
                if do_eval or do_ckpt:
                    self._flush(wire_per_step)
                acc = None
                if do_eval:
                    mask_eval = r._mask_to_device(self._eval_mask(last_mask))
                    if layout is None:
                        cloud = r.eval_model(state.params, mask_eval)
                    else:
                        cloud = layout.cloud_model(state.params, r.weights, mask_eval)
                    acc = float(r.eval_fn(cloud))
                    r.history[-1].accuracy = acc
                if do_ckpt:
                    saved = state if layout is None else layout.unshard(state, held)
                    r._save_checkpoint(r.history[-1].step, saved, self._checkpoint_meta(end_round, prefetcher.snapshot))
                if acc is not None and r.cfg.target_accuracy and acc >= r.cfg.target_accuracy:
                    stopped = True
                    break
            self._flush(wire_per_step)
        finally:
            prefetcher.stop()
        if layout is not None:
            state = layout.unshard(state, held)
        return state, stopped


class DeadlineEngine(SuperRoundEngine):
    """Semi-synchronous cloud rounds (``repro/fed/engine.py:356-480``): the
    superround engine driven by the runner's ``fed.deadline.SemiSyncScheduler``.

    Per cloud interval the scheduler advances every edge's upload clock on
    the host and closes the round at its deadline or quorum, returning a
    ``RoundPlan``. A trivial plan (every edge folded on time at weight 1)
    dispatches the stock superround with the stock inputs, so the barrier
    is bit-exact to ``SuperRoundEngine`` by construction; any other plan
    dispatches ``build_deadline_super_round`` with the plan's (N,) gate,
    uploaded with the interval's masks in one copy (pinned and
    non-blocking on the card: planning never waits for the device).

    The unit that talks to the cloud is the top-minus-one tier: edges on a
    two-level tree, regions on ``three_level``, the whole client set when
    clients report straight to the cloud. The scheduler plans from host
    masks only: the outage channel of the runner's last mask composition
    marks dead units, which are reweighted instead of waited for; late
    stragglers are not dead, their upload is still coming.

    Each record gets ``wall_clock_s`` from the event clock (rounds inside
    an interval interpolate linearly to its close), the boundary eval
    scores the model over the folded units only, and checkpoints carry the
    scheduler's state under ``meta["deadline"]``.
    """

    def __init__(self, runner):
        if getattr(runner, "mesh", None) is not None:
            raise ValueError(
                "the deadline engine is single-device (the gated cloud sync "
                "selects per-edge over the whole client axis); drop the mesh"
            )
        if runner.cfg.engine == "megakernel":
            raise ValueError("the deadline engine and the megakernel lowering do not compose")
        super().__init__(runner)
        self.scheduler = runner.deadline
        if self.scheduler is None:
            raise ValueError("DeadlineEngine needs runner.deadline (a SemiSyncScheduler)")
        spec = as_hierarchy(runner.topology)
        if spec.depth >= 2:
            self._gate_segments = np.asarray(spec.segments(spec.depth - 1))
            num_units = spec.num_nodes(spec.depth - 1)
        else:
            self._gate_segments = np.zeros(spec.num_clients, np.int64)
            num_units = 1
        if self.scheduler.num_edges != num_units:
            raise ValueError(
                f"scheduler models {self.scheduler.num_edges} edge(s) but the "
                f"tree has {num_units} cloud-facing unit(s)"
            )
        self._gated = build_deadline_super_round(
            runner.loss_fn, runner.optimizer, runner.topology, runner.hier_config, runner.weights,
            grad_accum=runner.grad_accum)
        self._wall: dict = {}  # round index -> event-clock seconds at its close
        self._last_plan = None
        self.gated_intervals = 0  # intervals dispatched through the gated superround

    def _dead_units(self, mask_stack: Optional[np.ndarray]) -> Optional[np.ndarray]:
        """(E,) bool: units with no surviving client at the interval's cloud
        boundary, from the outage channel when the runner tracked one."""
        r = self.runner
        parts = r._last_mask_parts
        dead_clients = None
        if parts is not None and parts.dead is not None:
            dead_clients = parts.dead  # 1 = outage; the straggler channel is not dead
        elif mask_stack is not None and r.stragglers is None:
            dead_clients = (mask_stack[-1] == 0).astype(np.float32)
        if dead_clients is None:
            return None
        alive_per_unit = np.zeros(self.scheduler.num_edges, np.float64)
        np.add.at(alive_per_unit, self._gate_segments, 1.0 - dead_clients)
        return alive_per_unit == 0

    def _upload(self, mask_stack: Optional[np.ndarray], gate: np.ndarray):
        """(masks or None, gate) on the device from one host block."""
        rows = [gate] if mask_stack is None else [*mask_stack, gate]
        block = torch.from_numpy(np.stack(rows).astype(np.float32))
        device = self.runner.device
        block = block.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else block.to(device)
        return (None if mask_stack is None else block[:-1]), block[-1]

    def _dispatch_interval(self, state, block, mask_stack, round_base):
        plan = self.scheduler.next_round(dead=self._dead_units(mask_stack))
        self._last_plan = plan
        for j in range(self.k2):
            self._wall[round_base + j] = plan.start + (plan.close - plan.start) * (j + 1) / self.k2
        if plan.is_trivial:
            return super()._dispatch_interval(state, block, mask_stack, round_base)
        self.gated_intervals += 1
        masks, gate = self._upload(mask_stack, plan.client_gate(self._gate_segments))
        return self._gated(state, block, gate, masks)

    def _eval_mask(self, last_mask):
        plan = self._last_plan
        if plan is None or plan.is_trivial:
            return last_mask
        folded = plan.folded[self._gate_segments].astype(np.float32)
        return folded if last_mask is None else last_mask * folded

    def _wall_clock_for(self, round_index: int) -> float:
        return float(self._wall.get(round_index, 0.0))

    def _checkpoint_meta(self, end_round: int, batcher_state: dict) -> dict:
        return {**super()._checkpoint_meta(end_round, batcher_state), "deadline": self.scheduler.state_dict()}


class CohortEngine:
    """The superround engine for sampled participation
    (``repro/fed/engine.py:481-795``).

    Per cloud interval: take the prefetched ``(ids, cohort, block)`` (see
    ``CohortPrefetcher``), copy the cohort's sticky rows (stacked optimizer
    leaves and the EF residual) from the host ``ClientStateStore`` into the
    state's own leaves, run the cohort superround, and write the rows back
    by original client id. Model params and anchors never touch the store:
    control returns only at cloud boundaries, where every stacked row is the
    fresh broadcast. Device memory grows with C; the (N, ...) population
    exists only on the host (store, sampler, batcher cursors).

    The swap goes through one pinned (C, ...) staging buffer per sticky
    leaf: the gathered rows are copied into the leaves without blocking
    (``_load_cohort``), and ``_writeback`` waits for the interval's device
    work, copies the rows back and scatters them, so the store is current
    before the next interval's optimizer steps and at every checkpoint.
    ``swap_seconds`` adds up the host time of the swaps, without the wait.

    Cadences are cloud-interval granular (the runner checks them first).
    Checkpoints hold ``{"fed": state, "store": store.state()}`` with the
    prefetcher's batcher and sampler snapshots in the metadata, so a resumed
    run replays the same cohorts and batches.

    With a runner mesh the stratified cohort's slot placement is planned
    once (the runner's ``_plan_cohort_placement``) and every interval runs
    ``build_sharded_cohort_super_round`` on this rank's slots. The rank's
    store touches only the rows of the clients of its own edges
    (``gather_placed`` / ``scatter_placed`` over its positions); at a
    checkpoint rank 0 collects the other ranks' touched rows, so the file
    holds JAX's logical (N, ...) store.
    """

    def __init__(self, runner):
        self.runner = runner
        hier = runner.hier_config
        self.k1 = hier.kappa1
        self.k2 = hier.kappa2_effective
        self.cohort_size = int(hier.participation.cohort_size)
        self.spec = as_hierarchy(runner.topology)
        self._weights_np = runner.weights.cpu().numpy()
        self.mesh = getattr(runner, "mesh", None)
        self.placement = None
        self._layout: Optional[_MeshLayout] = None
        if self.mesh is not None:
            axis = dist_sharding.client_axis_of(self.mesh)
            num_shards = int(self.mesh.shape[axis])
            self.placement = getattr(runner, "_cohort_placement", None)
            if self.placement is None or self.placement.num_shards != num_shards:
                self.placement = plan_cohort_placement(
                    self.spec, _cohort_quotas(self.spec, self.cohort_size), num_shards)
            self._super = build_sharded_cohort_super_round(
                runner.loss_fn, runner.optimizer, runner.topology, hier, cohort_size=self.cohort_size,
                mesh=self.mesh, axis=axis, placement=self.placement, grad_accum=runner.grad_accum)
            self._layout = _MeshLayout(self.mesh, self.placement, self.cohort_size)
            # the clients whose store rows live on this rank: those of the
            # edges its slots report to (stratified quotas fix slots to
            # edges). A depth-1 tree's slots take any client, so there each
            # rank keeps the whole store, written from every rank's rows.
            slots = [p for p in self.placement.perm[self.mesh.rows(self.placement.capacity)] if p >= 0]
            self._global_store = self.spec.depth == 1 and self.mesh.size > 1
            if self.spec.depth >= 2:
                edges = np.unique(self.placement.spec.segments(1)[slots])
                self._own_clients = np.isin(self.spec.segments(1), edges)
        else:
            self._super = build_cohort_super_round(
                runner.loss_fn, runner.optimizer, runner.topology, hier, cohort_size=self.cohort_size,
                grad_accum=runner.grad_accum)
        self._pending: List[Tuple[int, List[int], dict]] = []
        self._staging: Optional[List[torch.Tensor]] = None
        self.swap_seconds = 0.0

    def _segments_table(self) -> np.ndarray:
        """(depth-1, N) host table of each client's sub-top ancestor ids;
        the prefetcher takes the cohort's columns."""
        depth = self.spec.depth
        if depth == 1:
            return np.zeros((0, self.spec.num_clients), np.int32)
        return np.stack([np.asarray(self.spec.segments(lvl), np.int32) for lvl in range(1, depth)])

    def _masks_for_interval(self, ids: np.ndarray):
        """kappa2 survival draws over the population, columned at the
        sampled ids: (the (kappa2, C) stack or None, alive counts per round,
        the last round's columns for the boundary eval)."""
        r = self.runner
        masks = [r._mask_for_round() for _ in range(self.k2)]
        if all(m is None for m in masks):
            return None, [self.cohort_size] * self.k2, None
        n = r.topology.num_clients
        stack = np.stack([m if m is not None else np.ones(n, np.float32) for m in masks])
        cols = stack[:, ids]
        return cols, [int(row.sum()) for row in cols], cols[-1]

    def _buffers(self, rows: List[torch.Tensor]) -> List[torch.Tensor]:
        """The pinned staging buffers (host dtype: bf16 rows as int16 bits)."""
        if self._staging is None:
            pin = rows[0].device.type == "cuda"
            self._staging = [
                torch.empty(tuple(x.shape), dtype=torch.int16 if x.dtype == torch.bfloat16 else x.dtype,
                            pin_memory=pin)
                for x in rows
            ]
        return self._staging

    @property
    def _state_rows(self) -> int:
        """The live state's stacked rows: C, or this rank's slot capacity."""
        return self.cohort_size if self._layout is None else self._layout.capacity

    def _load_cohort(self, state: FedState, ids: np.ndarray) -> None:
        """Copy the sampled clients' sticky rows from the store into the
        state's leaves (in place: no leaf is rebound)."""
        store = self.runner.client_store
        if store.is_empty:
            return
        t0 = time.perf_counter()
        rows = list(leaves(sticky_rows(state, self._state_rows)))
        bufs = self._buffers(rows)
        # a rank reads its slots' clients (phantoms read slot 0's): the
        # gather_placed rows of its positions, into the staging buffers
        store.gather_into(ids if self._layout is None else ids[self._layout.gather], [b.numpy() for b in bufs])
        for x, b in zip(rows, bufs):
            x.copy_(b.view(x.dtype), non_blocking=True)
        self.swap_seconds += time.perf_counter() - t0

    def _writeback(self, state: FedState, ids: np.ndarray) -> None:
        """Persist the cohort's post-interval sticky rows by original id.
        Waits for the interval's device work first: the sync point that
        keeps the store current before the next interval's in-place steps."""
        store = self.runner.client_store
        if store.is_empty:
            return
        rows = list(leaves(sticky_rows(state, self._state_rows)))
        cuda = rows[0].device.type == "cuda"
        if cuda:
            torch.cuda.current_stream(rows[0].device).synchronize()
        t0 = time.perf_counter()
        bufs = self._buffers(rows)
        for x, b in zip(rows, bufs):
            b.copy_(x.view(b.dtype), non_blocking=cuda)
        if cuda:
            torch.cuda.current_stream(rows[0].device).synchronize()
        if self._layout is None:
            store.scatter(ids, [b.numpy() for b in bufs])
        elif self._global_store:
            full = [dist_sharding.gather_rows(x, self.mesh) for x in rows]
            store.scatter_placed(ids, self.placement, [_to_host(x) for x in full])
        else:
            store.scatter_placed(ids, self.placement, [b.numpy() for b in bufs],
                                 positions=self.mesh.rows(self._layout.capacity))
        self.swap_seconds += time.perf_counter() - t0

    def _merged_store(self):
        """The logical store for a checkpoint: rank 0's, with the touched
        rows of every other rank's own clients scattered in (they never meet
        rank 0's slots, so rank 0's own rows stay its own); on the other
        ranks their own store."""
        store = self.runner.client_store
        if self.mesh is None or self.mesh.size == 1 or store.is_empty or self._global_store:
            return store.state()
        for src in range(1, self.mesh.size):
            mine = None
            if self.mesh.rank == src:
                touched = np.flatnonzero(store._touched & self._own_clients)
                mine = (touched, [a[touched] for a in store._arrays])
            touched, rows = dist_sharding.broadcast_object(mine, src, self.mesh)
            if self.mesh.rank == 0:
                store.scatter(touched, unflatten(store._template, rows))
        return store.state()

    def _flush(self, wire_per_step: float) -> None:
        r = self.runner
        for round_base, alive, metrics in self._pending:
            if self._layout is not None:
                loss, gnorm, step = self._layout.reduce_metrics(metrics)
                vals = {"loss": loss.tolist(), "grad_norm": gnorm.tolist(), "step": step}
            else:
                vals = {k: v.tolist() for k, v in metrics.items()}
            for j in range(self.k2):
                r._record_round(
                    round_base + j, int(vals["step"][j]), float(vals["loss"][j]),
                    float(vals["grad_norm"][j]), alive[j], wire_per_step,
                )
        self._pending.clear()

    def run_intervals(self, state: FedState, *, start_round: int, num_intervals: int) -> Tuple[FedState, bool]:
        """Run ``num_intervals`` cloud intervals from a cloud-aligned
        ``start_round``. Returns (state, stopped_early)."""
        r = self.runner
        if start_round % self.k2:
            raise ValueError(
                f"cohort engine must start at a cloud boundary: "
                f"start_round={start_round} is not a multiple of {self.k2}"
            )
        r._ensure_client_store(state)
        wire_per_step = r._wire_bytes_per_step(state)
        stopped = False
        from repro_torch.fed.runner import FederatedRunner

        no_failures = (
            r.failures is None
            and r.stragglers is None
            and getattr(r._mask_for_round, "__func__", None) is FederatedRunner._mask_for_round
        )
        static_masks = (None, [self.cohort_size] * self.k2, None)
        layout = self._layout
        prefetcher = CohortPrefetcher(
            r.batcher,
            r._cohort_sampler(),
            segments=self._segments_table(),
            weights=self._weights_np,
            rounds_per_block=self.k2,
            steps_per_round=self.k1,
            device=r.device,
            num_blocks=num_intervals,
            layout=layout,
        )
        held = state
        if layout is not None:
            state = layout.shard(state)
        try:
            for q in range(num_intervals):
                round_base = start_round + q * self.k2
                ids, cohort, block = prefetcher.get()
                mask_stack, alive, last_mask = static_masks if no_failures else self._masks_for_interval(ids)
                self._load_cohort(state, ids)
                if layout is None:
                    state, metrics = self._super(state, block, cohort, r._mask_to_device(mask_stack))
                else:
                    state, metrics = self._super(state, block, cohort["weights"], layout.masks(mask_stack))
                self._writeback(state, ids)
                self._pending.append((round_base, alive, metrics))
                end_round = round_base + self.k2
                do_eval = r.eval_fn is not None and r.cfg.eval_every and end_round % r.cfg.eval_every == 0
                do_ckpt = r.checkpointer is not None and r.cfg.checkpoint_every and (
                    end_round % r.cfg.checkpoint_every == 0)
                if do_eval or do_ckpt:
                    self._flush(wire_per_step)
                acc = None
                if do_eval:
                    # the cohort-weighted cloud model: at C = N the runner's
                    # full-population eval, bit for bit
                    if layout is None:
                        cloud = aggregation.cloud_model(state.params, cohort["weights"], r._mask_to_device(last_mask))
                    else:
                        cloud = layout.cloud_model(state.params, torch.as_tensor(self._weights_np[ids], device=r.device),
                                                   r._mask_to_device(last_mask))
                    acc = float(r.eval_fn(cloud))
                    r.history[-1].accuracy = acc
                if do_ckpt:
                    meta = {**r._checkpoint_meta(end_round, prefetcher.snapshot["batcher"]),
                            "sampler": prefetcher.snapshot["sampler"]}
                    fed = state if layout is None else layout.unshard(state, held)
                    r._save_checkpoint(r.history[-1].step, {"fed": fed, "store": self._merged_store()}, meta)
                if acc is not None and r.cfg.target_accuracy and acc >= r.cfg.target_accuracy:
                    stopped = True
                    break
            self._flush(wire_per_step)
        finally:
            prefetcher.stop()
        if layout is not None:
            state = layout.unshard(state, held)
        return state, stopped
