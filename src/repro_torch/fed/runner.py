"""Federated round runner: the host-side training orchestrator.

Port of ``repro.fed.runner`` for the main path. By default
(``RunnerConfig.engine="auto"``) every whole cloud interval goes to the
superround engine (``fed.engine``), with batch prefetch and metrics kept on
the device until an eval point. The per-round loop below runs the
remainder (a partial trailing cloud interval), or everything when
``eval_every`` needs finer granularity than a cloud interval. Both loops
append the same ``RoundRecord`` history, with the paper's T/E accounting
(``core.cost_model``) and the uplink bytes per client (``wire_mb``). When
``hier_config.transport`` names per-level codecs, both are accounted on the
compressed wire: T/E through ``WorkloadCosts.with_bits`` (edge hop = level
1, cloud hop = the top level) and ``wire_mb`` at each level's bits per
parameter.

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
    init_state,
    unported,
)
from repro_torch.data.pipeline import to_device
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist import collectives


@dataclasses.dataclass
class RunnerConfig:
    num_rounds: int  # edge intervals to run (= K / kappa1)
    eval_every: int = 0  # rounds between evals (0 = never)
    target_accuracy: float = 0.0  # stop early when reached (0 = never)
    # "auto": superround engine for every whole cloud interval whose
    # boundaries satisfy the eval cadence, per-round otherwise;
    # "superround" forces the engine (raises if ineligible); "per_round"
    # forces the one-edge-interval-at-a-time loop.
    engine: str = "auto"

    def __post_init__(self):
        if self.engine == "megakernel":
            raise unported("engine='megakernel'", 6)
        if self.engine not in ("auto", "superround", "per_round"):
            raise ValueError(f"RunnerConfig.engine must be auto|superround|per_round, got {self.engine!r}")


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
    wall_clock_s: float = 0.0  # event clock of the deadline engine (0.0 here)


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
        self._engine = None  # lazily built (and cached) SuperRoundEngine
        self._round = build_hier_round(loss_fn, optimizer, topology, hier_config, self.weights)
        self.history: List[RoundRecord] = []

    def init(self, rng: torch.Generator, params: Params) -> FedState:
        """Stacked initial state from unstacked ``params`` (moved to the
        runner's device)."""
        params = {k: v.to(self.device) for k, v in params.items()}
        return init_state(rng, params, self.optimizer, self.topology, self.hier_config)

    def eval_model(self, params: Params, mask: Optional[torch.Tensor] = None) -> Params:
        """The single cloud model the eval path scores: the weighted mean of
        the client models, without the (N, ...) broadcast."""
        return aggregation.cloud_model(params, self.weights, mask)

    def _wire_bytes_per_step(self, state: FedState) -> float:
        """Summed per-level uplink bytes per local step for one client, at
        the transport's per-level bits per parameter."""
        per_client = sum(x.numel() // x.shape[0] * x.element_size() for x in state.params.values())
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
        )
        self.history.append(record)
        return record

    def _superround_eligible(self, start_round: int) -> bool:
        """The engine returns to the host at cloud boundaries only, so the
        start and the eval cadence must land on them."""
        k2 = self.hier_config.kappa2_effective
        if start_round % k2:
            return False
        return not (self.cfg.eval_every and self.cfg.eval_every % k2)

    def _flush_rounds(self, pending: list, wire_per_step: float) -> None:
        """Per-round metrics to records, one host fetch per round."""
        n = self.topology.num_clients
        for r, step, metrics in pending:
            self._record_round(
                r, int(step), float(metrics["loss"]), float(metrics["grad_norm"]), n, wire_per_step
            )
        pending.clear()

    def run(self, state: FedState, *, start_round: int = 0) -> FedState:
        mode = self.cfg.engine
        k2 = self.hier_config.kappa2_effective
        if mode != "per_round":
            full = (self.cfg.num_rounds - start_round) // k2 if self._superround_eligible(start_round) else 0
            if mode == "superround" and full <= 0:
                raise ValueError(
                    "engine='superround' needs a cloud-aligned start_round, eval_every "
                    f"a multiple of kappa2_effective={k2}, and at least one whole cloud "
                    "interval of rounds"
                )
            if full > 0:
                if self._engine is None:
                    from repro_torch.fed.engine import SuperRoundEngine

                    self._engine = SuperRoundEngine(self)
                state, stopped = self._engine.run_intervals(state, start_round=start_round, num_intervals=full)
                if stopped:
                    return state
                start_round += full * k2
        # per-round path: the remainder (partial trailing interval), or
        # everything when the eval cadence is finer than a cloud interval.
        # Metrics stay on the device until an eval point or the end.
        k1 = self.hier_config.kappa1
        wire_per_step = self._wire_bytes_per_step(state)
        pending: list = []
        for r in range(start_round, self.cfg.num_rounds):
            batches = to_device(self.batcher.next_batches(k1), self.device)
            state, metrics = self._round(state, batches, r, None)
            pending.append((r, state.step, metrics))
            if self.eval_fn is not None and self.cfg.eval_every and (r + 1) % self.cfg.eval_every == 0:
                self._flush_rounds(pending, wire_per_step)
                acc = float(self.eval_fn(self.eval_model(state.params)))
                self.history[-1].accuracy = acc
                if self.cfg.target_accuracy and acc >= self.cfg.target_accuracy:
                    break
        self._flush_rounds(pending, wire_per_step)
        return state

    def records_to_dict(self) -> Dict[str, list]:
        """Column-major history, one key per ``RoundRecord`` field."""
        return {f.name: [getattr(h, f.name) for h in self.history] for f in dataclasses.fields(RoundRecord)}
