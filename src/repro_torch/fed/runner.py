"""Federated round runner: the host-side training orchestrator.

Port of ``repro.fed.runner`` for the main path. By default
(``RunnerConfig.engine="auto"``) every whole cloud interval goes to the
superround engine (``fed.engine``), with batch prefetch and metrics kept on
the device until an eval point; ``engine="megakernel"`` runs those
intervals through the client-blocked lowering where the schedule allows
(``_check_megakernel``) and names the reason where it does not. The per-round loop below runs the
remainder (a partial trailing cloud interval), or everything when
``eval_every`` needs finer granularity than a cloud interval. Both loops
append the same ``RoundRecord`` history, with the paper's T/E accounting
(``core.cost_model``) and the uplink bytes per client (``wire_mb``). When
``hier_config.transport`` names per-level codecs, both are accounted on the
compressed wire: T/E through ``WorkloadCosts.with_bits`` (edge hop = level
1, cloud hop = the top level) and ``wire_mb`` at each level's bits per
parameter.

Failure and straggler models (``fed.failures``, host-side numpy) give each
round a survival mask (``_mask_for_round``): the round's syncs and its eval
take it, and ``RoundRecord.mask_alive`` counts its survivors. A
``checkpointer`` (``checkpoint.CheckpointManager``) saves the state every
``checkpoint_every`` rounds with the round, the batcher's cursors and the
failure models' states; ``restore_or_init`` resumes from the latest.

Under sampled participation (``hier_config.participation`` with a
positive cohort size) every cloud interval goes to the cohort engine
(``fed.engine.CohortEngine``): the state stacks the C sampled clients, and
their sticky optimizer and residual rows live in a host
``ClientStateStore`` between intervals. There is no per-round fallback
(the full-population state it needs never exists), so a schedule or
cadence the cohort engine cannot run is an error that names the reason
(``_cohort_reason``). Cohort checkpoints hold the state and the store, with
the cohort sampler's state beside the batcher's.

With a ``deadline`` scheduler (``fed.deadline.SemiSyncScheduler``) every
cloud interval goes to ``fed.engine.DeadlineEngine``, again with no
fallback: a schedule or cadence it cannot run raises with the reason
(``_deadline_reason``), in the JAX package's words. Its records carry the
event clock in ``wall_clock_s``, and its checkpoints the scheduler's state.

The runner consumes the ``FedState`` it is given: stacked parameters are
updated in place (see ``optim.apply_updates``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import aggregation
from repro_torch.core import cost_model as cm
from repro_torch.core.hierarchy import as_hierarchy
from repro_torch.core.hierfavg import (
    FedState,
    HierFAVGConfig,
    Params,
    Topology,
    build_hier_round,
    cohort_incompatibility,
    deadline_incompatibility,
    init_cohort_state,
    init_state,
    megakernel_incompatibility,
)
from repro_torch.data.pipeline import to_device
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist import collectives
from repro_torch.fed.client_store import ClientStateStore, sticky_rows
from repro_torch.fed.failures import FailureSimulator, StragglerModel, compose_masks
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass
class RunnerConfig:
    num_rounds: int  # edge intervals to run (= K / kappa1)
    eval_every: int = 0  # rounds between evals (0 = never)
    checkpoint_every: int = 0  # rounds between checkpoints (0 = never)
    target_accuracy: float = 0.0  # stop early when reached (0 = never)
    # the straggler deadline: this percentile of the latency model (times
    # StragglerModel.deadline_for's slack); at the default 95 the masks are
    # the JAX runner's, which ignores the field
    straggler_deadline_pct: float = 95.0
    # "auto": superround engine for every whole cloud interval whose
    # boundaries satisfy the eval cadence, per-round otherwise;
    # "superround" forces the engine (raises if ineligible); "megakernel"
    # is the opt-in client-blocked path (falls back to the superround with
    # a named reason when the schedule is not block-separable); "per_round"
    # forces the one-edge-interval-at-a-time loop.
    engine: str = "auto"

    def __post_init__(self):
        if self.engine not in ("auto", "superround", "megakernel", "per_round"):
            raise ValueError(
                f"RunnerConfig.engine must be auto|superround|megakernel|per_round, got {self.engine!r}"
            )


@dataclasses.dataclass
class RoundRecord:
    round: int
    step: int
    loss: float
    mask_alive: int
    sim_time_s: float
    sim_energy_j: float
    accuracy: Optional[float] = None
    wire_mb: float = 0.0  # cumulative uplink MB/client
    grad_norm: Optional[float] = None  # mean stacked-gradient norm over the round
    # event-clock seconds at the round's close under the deadline engine
    # (0.0 for the synchronous loops, which have no event clock)
    wall_clock_s: float = 0.0


class FederatedRunner:
    def __init__(
        self,
        *,
        loss_fn,
        optimizer,
        topology: Topology,  # FedTopology or a ragged HierarchySpec
        hier_config: HierFAVGConfig,
        data_sizes: np.ndarray,
        batcher,  # data.pipeline.FederatedBatcher
        runner_config: RunnerConfig,
        eval_fn: Optional[Callable[[Params], float]] = None,
        costs: Optional[cm.WorkloadCosts] = None,
        failures: Optional[FailureSimulator] = None,
        stragglers: Optional[StragglerModel] = None,
        deadline=None,  # fed.deadline.SemiSyncScheduler (semi-synchronous cloud)
        checkpointer=None,  # checkpoint.CheckpointManager
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.topology = topology
        self.hier_config = hier_config
        self.weights = torch.as_tensor(np.asarray(data_sizes), dtype=torch.float32).to(self.device)
        self.batcher = batcher
        self.cfg = runner_config
        self.eval_fn = eval_fn
        self.costs = costs
        self.transport = hier_config.transport
        if self.costs is not None and self.transport is not None:
            self.costs = self.costs.with_bits(
                self.transport.bits_per_param(1), self.transport.bits_per_param(self.transport.depth)
            )
        self.failures = failures
        self.stragglers = stragglers
        self.deadline = deadline
        # the last mask composition's channels (dead vs late), kept apart:
        # the deadline engine reweights dead units instead of waiting
        self._last_mask_parts = None
        self.checkpointer = checkpointer
        self._engine = None  # lazily built (and cached) SuperRoundEngine / DeadlineEngine / CohortEngine
        self._megakernel_reason: Optional[str] = None
        # sampled participation: the active ParticipationSpec (or None), the
        # host store (built from the first state seen, which fixes the
        # sticky-row template) and the run's one cohort sampler
        self.participation = hier_config.participation if hier_config.participation_active else None
        self.client_store: Optional[ClientStateStore] = None
        self._sampler = None
        # the per-round lowering never runs under sampled participation
        self._round = None if self.participation is not None else build_hier_round(
            loss_fn, optimizer, topology, hier_config, self.weights)
        self.history: List[RoundRecord] = []

    def init(self, rng: torch.Generator, params: Params) -> FedState:
        """Stacked initial state from unstacked ``params`` (moved to the
        runner's device): N rows, or C under sampled participation."""
        params = tree_map(lambda v: v.to(self.device), params)
        if self.participation is not None:
            return init_cohort_state(rng, params, self.optimizer, self.hier_config, self.participation.cohort_size)
        return init_state(rng, params, self.optimizer, self.topology, self.hier_config)

    def _restore_meta(self, meta: dict) -> int:
        """Load the batcher, sampler and failure-model states saved beside a
        checkpoint; returns its round."""
        if "batcher" in meta:
            self.batcher.load_state_dict(meta["batcher"])
        if self.participation is not None and "sampler" in meta:
            self._cohort_sampler().load_state_dict(meta["sampler"])
        if self.failures is not None and "failures" in meta:
            self.failures.load_state_dict(meta["failures"])
        if self.stragglers is not None and "stragglers" in meta:
            self.stragglers.load_state_dict(meta["stragglers"])
        if self.deadline is not None and "deadline" in meta:
            # the event queue and staleness state: the resumed run replays
            # the uninterrupted run's event sequence
            self.deadline.load_state_dict(meta["deadline"])
        return int(meta.get("round", 0))

    def restore_or_init(self, rng: torch.Generator, params: Params) -> tuple:
        """(state, start_round): the latest checkpoint if any, else a fresh
        ``init``. Restores the batcher's cursors, the cohort sampler's state
        and the failure and straggler models' states saved beside it; a
        cohort checkpoint is ``{"fed": state, "store": store.state()}``."""
        state = self.init(rng, params)
        if self.checkpointer is None:
            return state, 0
        if self.participation is not None:
            store = self._ensure_client_store(state)
            restored = self.checkpointer.restore_latest({"fed": state, "store": store.state()})
            if restored is None:
                return state, 0
            payload, meta = restored
            store.load(payload["store"])
            return payload["fed"], self._restore_meta(meta)
        restored = self.checkpointer.restore_latest(state)
        if restored is None:
            return state, 0
        state, meta = restored
        return state, self._restore_meta(meta)

    def _cohort_sampler(self):
        """The run's one cohort sampler (cached: its random stream is the
        cohort sequence)."""
        if self._sampler is None:
            self._sampler = self.participation.build_sampler(as_hierarchy(self.topology))
        return self._sampler

    def _ensure_client_store(self, state: FedState) -> ClientStateStore:
        """Build (once) the host store from the cohort state's sticky rows:
        the stacked optimizer leaves and the EF residual."""
        if self.client_store is None:
            rows = sticky_rows(state, int(self.participation.cohort_size))
            self.client_store = ClientStateStore.from_rows(self.topology.num_clients, rows)
        return self.client_store

    def _mask_for_round(self) -> Optional[np.ndarray]:
        """The round's (N,) survival mask on the host (None without failure
        models): the product of every model's mask, with the dead (outage)
        and late (deadline miss) channels kept on ``_last_mask_parts``."""
        dead, late = [], []
        if self.failures is not None:
            dead.append(self.failures.step())
        if self.stragglers is not None:
            k1 = self.hier_config.kappa1
            deadline = self.stragglers.deadline_for(k1, percentile=self.cfg.straggler_deadline_pct)
            late.append(self.stragglers.survivors(k1, deadline)[0])
        parts = compose_masks(dead=dead, late=late)
        self._last_mask_parts = parts
        return parts.effective

    def _mask_to_device(self, mask: Optional[np.ndarray]) -> Optional[torch.Tensor]:
        return None if mask is None else torch.as_tensor(mask, dtype=torch.float32).to(self.device)

    def _checkpoint_meta(self, end_round: int, batcher_state: dict) -> dict:
        meta = {"round": end_round, "batcher": batcher_state}
        if self.failures is not None:
            meta["failures"] = self.failures.state_dict()
        if self.stragglers is not None:
            meta["stragglers"] = self.stragglers.state_dict()
        return meta

    def eval_model(self, params: Params, mask: Optional[torch.Tensor] = None) -> Params:
        """The single cloud model the eval path scores: the weighted mean of
        the client models without the (N, ...) broadcast, or, where the
        schedule sets a non-default top-level aggregator, that statistic
        (the model the cloud would publish)."""
        cfg = self.hier_config
        if cfg.aggregators_active:
            top = cfg.aggregators.aggregator(cfg.num_levels)
            if not top.is_default:
                spec = as_hierarchy(self.topology)
                return tree_map(lambda x: x[0], top(params, self.weights, spec, spec.depth, mask))
        return aggregation.cloud_model(params, self.weights, mask)

    def _wire_bytes_per_step(self, state: FedState) -> float:
        """Summed per-level uplink bytes per local step for one client, at
        the transport's per-level bits per parameter."""
        per_client = sum(x.numel() // x.shape[0] * x.element_size() for x in leaves(state.params))
        bits = self.transport.bits_vector() if self.transport is not None else None
        traffic = collectives.hierarchy_traffic_per_step(
            float(per_client), as_hierarchy(self.topology), self.hier_config.kappa_vector, bits_per_param=bits
        )
        return float(sum(traffic))

    def _record_round(
        self,
        round_index: int,
        step: int,
        loss: float,
        grad_norm: float,
        mask_alive: int,
        wire_per_step: float,
        accuracy: Optional[float] = None,
        wall_clock_s: float = 0.0,
    ) -> RoundRecord:
        """Assemble and append one round's record — the one site both
        loops share, so their histories match field for field."""
        sim_t = sim_e = 0.0
        if self.costs is not None:
            k1 = self.hier_config.kappa1
            k2 = self.hier_config.kappa2_effective
            sim_t = cm.time_at_step(self.costs, k1, k2, step)
            sim_e = cm.energy_at_step(self.costs, k1, k2, step)
        record = RoundRecord(
            round=round_index,
            step=step,
            loss=loss,
            mask_alive=mask_alive,
            sim_time_s=sim_t,
            sim_energy_j=sim_e,
            accuracy=accuracy,
            wire_mb=step * wire_per_step / 1e6,
            grad_norm=grad_norm,
            wall_clock_s=wall_clock_s,
        )
        self.history.append(record)
        return record

    def _check_megakernel(self) -> Optional[str]:
        """None if whole cloud intervals can run through the client-blocked
        lowering, else why the engine falls back to the superround; cached
        on ``_megakernel_reason`` so the fallback is named, not silent.
        Runner-level seams first (failure masks, an overridden failure
        detector; a mesh and microbatching come with ROADMAP.md items 12
        and 4), then the schedule-level predicate, in JAX's words."""
        if self.failures is not None or self.stragglers is not None:
            reason = "failure/straggler masks need the scan-fused survival plumbing"
        elif getattr(self._mask_for_round, "__func__", None) is not FederatedRunner._mask_for_round:
            reason = "an overridden failure detector is a live per-round mask seam"
        else:
            reason = megakernel_incompatibility(self.hier_config, self.topology)
        self._megakernel_reason = reason
        return reason

    def _superround_eligible(self, start_round: int) -> bool:
        """The engine returns to the host at cloud boundaries only, so the
        start and the eval and checkpoint cadences must land on them."""
        k2 = self.hier_config.kappa2_effective
        if start_round % k2:
            return False
        return not any(every and every % k2 for every in (self.cfg.eval_every, self.cfg.checkpoint_every))

    def _flush_rounds(self, pending: list, wire_per_step: float) -> None:
        """Per-round metrics to records, one host fetch per round."""
        for r, step, metrics, alive in pending:
            self._record_round(
                r, int(step), float(metrics["loss"]), float(metrics["grad_norm"]), alive, wire_per_step
            )
        pending.clear()

    def _cadence_reason(self, start_round: int) -> Optional[str]:
        """Why whole cloud intervals cannot cover the run from
        ``start_round`` (the cohort and deadline engines have no per-round
        fallback), or None, in the JAX runner's words."""
        k2 = self.hier_config.kappa2_effective
        if start_round % k2:
            return f"start_round {start_round} is not a cloud boundary (kappa2_eff={k2})"
        if (self.cfg.num_rounds - start_round) % k2:
            return f"num_rounds {self.cfg.num_rounds} is not a whole number of cloud intervals"
        for name, every in (("eval_every", self.cfg.eval_every), ("checkpoint_every", self.cfg.checkpoint_every)):
            if every and every % k2 != 0:
                return f"{name}={every} is finer than a cloud interval (kappa2_eff={k2})"
        return None

    def _cohort_reason(self, start_round: int) -> Optional[str]:
        """None if the run can go cohort-sampled end to end, else why not,
        in the JAX runner's words (its mesh reasons come with ROADMAP.md
        Queue 1 item 12). Every constraint is an error, not a fallback."""
        reason = cohort_incompatibility(self.hier_config, self.topology, self.participation.cohort_size)
        if reason is not None:
            return reason
        if self.cfg.engine == "per_round":
            return "engine='per_round' has no cohort lowering"
        return self._cadence_reason(start_round)

    def _deadline_reason(self, start_round: int) -> Optional[str]:
        """None if the run can go through the deadline engine, else why
        not, in the JAX runner's words (its mesh reasons come with ROADMAP.md
        Queue 1 item 12). A scheduler was configured, so running synchronous
        instead would change the experiment: every constraint is an error."""
        if self.participation is not None:
            return "sampled participation runs through the cohort engine"
        reason = deadline_incompatibility(self.hier_config, self.topology)
        if reason is not None:
            return reason
        if self.cfg.engine == "per_round":
            return "engine='per_round' has no deadline lowering"
        if self.cfg.engine == "megakernel":
            return "the deadline engine and the megakernel lowering do not compose"
        return self._cadence_reason(start_round)

    def _run_whole_intervals(self, state: FedState, start_round: int, engine_cls, reason: Optional[str],
                             what: str) -> FedState:
        """Every cloud interval from ``start_round`` through ``engine_cls``
        (built once), or raise ``reason``."""
        if reason is not None:
            raise ValueError(f"{what} cannot run: {reason}")
        intervals = (self.cfg.num_rounds - start_round) // self.hier_config.kappa2_effective
        if intervals <= 0:
            return state
        if self._engine is None:
            self._engine = engine_cls(self)
        state, _ = self._engine.run_intervals(state, start_round=start_round, num_intervals=intervals)
        return state

    def run(self, state: FedState, *, start_round: int = 0) -> FedState:
        from repro_torch.fed.engine import CohortEngine, DeadlineEngine, SuperRoundEngine

        mode = self.cfg.engine
        if self.participation is not None:
            return self._run_whole_intervals(state, start_round, CohortEngine, self._cohort_reason(start_round),
                                             "sampled participation")
        if self.deadline is not None:
            return self._run_whole_intervals(state, start_round, DeadlineEngine, self._deadline_reason(start_round),
                                             "the deadline engine")
        k2 = self.hier_config.kappa2_effective
        if mode != "per_round":
            full = (self.cfg.num_rounds - start_round) // k2 if self._superround_eligible(start_round) else 0
            if mode in ("superround", "megakernel") and full <= 0:
                raise ValueError(
                    f"engine={mode!r} needs a cloud-aligned start_round, eval_every/"
                    f"checkpoint_every multiples of kappa2_effective={k2}, and at least "
                    "one whole cloud interval of rounds"
                )
            if full > 0:
                if self._engine is None:
                    self._engine = SuperRoundEngine(self)
                state, stopped = self._engine.run_intervals(state, start_round=start_round, num_intervals=full)
                if stopped:
                    return state
                start_round += full * k2
        # per-round path: the remainder (partial trailing interval), or
        # everything when the eval cadence is finer than a cloud interval.
        # Metrics stay on the device until an eval or checkpoint point or the
        # end.
        k1 = self.hier_config.kappa1
        n = self.topology.num_clients
        wire_per_step = self._wire_bytes_per_step(state)
        pending: list = []
        for r in range(start_round, self.cfg.num_rounds):
            batches = to_device(self.batcher.next_batches(k1), self.device)
            mask = self._mask_for_round()
            mask_dev = self._mask_to_device(mask)
            alive = int(mask.sum()) if mask is not None else n
            state, metrics = self._round(state, batches, r, mask_dev)
            pending.append((r, state.step, metrics, alive))
            do_eval = self.eval_fn is not None and self.cfg.eval_every and (r + 1) % self.cfg.eval_every == 0
            do_ckpt = self.checkpointer is not None and self.cfg.checkpoint_every and (
                (r + 1) % self.cfg.checkpoint_every == 0)
            if do_eval or do_ckpt:
                self._flush_rounds(pending, wire_per_step)
            acc = None
            if do_eval:
                acc = float(self.eval_fn(self.eval_model(state.params, mask_dev)))
                self.history[-1].accuracy = acc
            if do_ckpt:
                self.checkpointer.save(int(state.step), state, self._checkpoint_meta(r + 1, self.batcher.state_dict()))
            if acc is not None and self.cfg.target_accuracy and acc >= self.cfg.target_accuracy:
                break
        self._flush_rounds(pending, wire_per_step)
        return state

    def records_to_dict(self) -> Dict[str, list]:
        """Column-major history, one key per ``RoundRecord`` field."""
        return {f.name: [getattr(h, f.name) for h in self.history] for f in dataclasses.fields(RoundRecord)}
