"""Superround execution engine: one cloud interval per dispatch.

Port of the single-device ``SuperRoundEngine`` of ``repro.fed.engine``. The
paper's protocol needs the host only at cloud boundaries, so the engine
runs a whole cloud interval (kappa2_eff edge intervals of kappa1 local steps
plus their syncs) per ``build_super_round`` call and removes per-round host
costs:

* **State updated in place** — where the JAX engine donates the
  ``FedState`` to its jitted superround (``repro/fed/engine.py:146``), the
  port updates the stacked parameters in place (``optim.apply_updates``);
  the caller's state is consumed. A compressed transport's anchor and
  error-feedback residual ride along in the ``FedState``: each sync
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
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import aggregation
from repro_torch.core.hierarchy import as_hierarchy
from repro_torch.core.hierfavg import (
    FedState,
    build_cohort_super_round,
    build_deadline_super_round,
    build_megakernel_super_round,
    build_super_round,
)
from repro_torch.data.pipeline import CohortPrefetcher, SuperBatchPrefetcher
from repro_torch.fed.client_store import sticky_rows
from repro_torch.tree import leaves


class SuperRoundEngine:
    """Drives a ``FederatedRunner`` one cloud interval per call. Built (and
    cached) by the runner; appends the same per-round history the per-round
    path would."""

    def __init__(self, runner):
        self.runner = runner
        hier = runner.hier_config
        self.k1 = hier.kappa1
        self.k2 = hier.kappa2_effective
        self.uses_megakernel = False
        self.megakernel_reason: Optional[str] = None
        build = build_super_round
        if runner.cfg.engine == "megakernel":
            self.megakernel_reason = runner._check_megakernel()
            if self.megakernel_reason is None:
                build, self.uses_megakernel = build_megakernel_super_round, True
        self._super = build(runner.loss_fn, runner.optimizer, runner.topology, hier, runner.weights)
        # [(round_base, alive counts (k2,), device metrics {"loss",
        # "grad_norm","step"} each (k2,))]
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
        prefetcher = SuperBatchPrefetcher(
            r.batcher,
            rounds_per_block=self.k2,
            steps_per_round=self.k1,
            device=r.device,
            num_blocks=num_intervals,
        )
        try:
            for q in range(num_intervals):
                round_base = start_round + q * self.k2
                block = prefetcher.get()
                mask_stack, alive, last_mask = static_masks if no_failures else self._masks_for_interval()
                state, metrics = self._dispatch_interval(state, block, mask_stack, round_base)
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
                    acc = float(r.eval_fn(r.eval_model(state.params, mask_eval)))
                    r.history[-1].accuracy = acc
                if do_ckpt:
                    r.checkpointer.save(r.history[-1].step, state, self._checkpoint_meta(end_round, prefetcher.snapshot))
                if acc is not None and r.cfg.target_accuracy and acc >= r.cfg.target_accuracy:
                    stopped = True
                    break
            self._flush(wire_per_step)
        finally:
            prefetcher.stop()
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
            runner.loss_fn, runner.optimizer, runner.topology, runner.hier_config, runner.weights)
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
    """The superround engine for sampled participation, single device
    (``repro/fed/engine.py:481-795`` without its mesh branch, which comes
    with ROADMAP.md Queue 1 item 12).

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
    """

    def __init__(self, runner):
        self.runner = runner
        hier = runner.hier_config
        self.k1 = hier.kappa1
        self.k2 = hier.kappa2_effective
        self.cohort_size = int(hier.participation.cohort_size)
        self.spec = as_hierarchy(runner.topology)
        self._weights_np = runner.weights.cpu().numpy()
        self._super = build_cohort_super_round(
            runner.loss_fn, runner.optimizer, runner.topology, hier, cohort_size=self.cohort_size)
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

    def _load_cohort(self, state: FedState, ids: np.ndarray) -> None:
        """Copy the sampled clients' sticky rows from the store into the
        state's leaves (in place: no leaf is rebound)."""
        store = self.runner.client_store
        if store.is_empty:
            return
        t0 = time.perf_counter()
        rows = list(leaves(sticky_rows(state, self.cohort_size)))
        bufs = self._buffers(rows)
        store.gather_into(ids, [b.numpy() for b in bufs])
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
        rows = list(leaves(sticky_rows(state, self.cohort_size)))
        cuda = rows[0].device.type == "cuda"
        if cuda:
            torch.cuda.current_stream(rows[0].device).synchronize()
        t0 = time.perf_counter()
        bufs = self._buffers(rows)
        for x, b in zip(rows, bufs):
            b.copy_(x.view(b.dtype), non_blocking=cuda)
        if cuda:
            torch.cuda.current_stream(rows[0].device).synchronize()
        store.scatter(ids, [b.numpy() for b in bufs])
        self.swap_seconds += time.perf_counter() - t0

    def _flush(self, wire_per_step: float) -> None:
        r = self.runner
        for round_base, alive, metrics in self._pending:
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
        prefetcher = CohortPrefetcher(
            r.batcher,
            r._cohort_sampler(),
            segments=self._segments_table(),
            weights=self._weights_np,
            rounds_per_block=self.k2,
            steps_per_round=self.k1,
            device=r.device,
            num_blocks=num_intervals,
        )
        try:
            for q in range(num_intervals):
                round_base = start_round + q * self.k2
                ids, cohort, block = prefetcher.get()
                mask_stack, alive, last_mask = static_masks if no_failures else self._masks_for_interval(ids)
                self._load_cohort(state, ids)
                state, metrics = self._super(state, block, cohort, r._mask_to_device(mask_stack))
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
                    cloud = aggregation.cloud_model(state.params, cohort["weights"], r._mask_to_device(last_mask))
                    acc = float(r.eval_fn(cloud))
                    r.history[-1].accuracy = acc
                if do_ckpt:
                    meta = {**r._checkpoint_meta(end_round, prefetcher.snapshot["batcher"]),
                            "sampler": prefetcher.snapshot["sampler"]}
                    r.checkpointer.save(r.history[-1].step, {"fed": state, "store": r.client_store.state()}, meta)
                if acc is not None and r.cfg.target_accuracy and acc >= r.cfg.target_accuracy:
                    stopped = True
                    break
            self._flush(wire_per_step)
        finally:
            prefetcher.stop()
        return state, stopped
