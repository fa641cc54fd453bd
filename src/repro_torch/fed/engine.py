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

Nothing in this path synchronises the device except those fetches and the
eval.
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.core.hierfavg import FedState, build_super_round
from repro_torch.data.pipeline import SuperBatchPrefetcher


class SuperRoundEngine:
    """Drives a ``FederatedRunner`` one cloud interval per call. Built (and
    cached) by the runner; appends the same per-round history the per-round
    path would."""

    def __init__(self, runner):
        self.runner = runner
        hier = runner.hier_config
        self.k1 = hier.kappa1
        self.k2 = hier.kappa2_effective
        self._super = build_super_round(runner.loss_fn, runner.optimizer, runner.topology, hier, runner.weights)
        # [(round_base, device metrics {"loss","grad_norm","step"} each (k2,))]
        self._pending: List[Tuple[int, dict]] = []

    def _flush(self, wire_per_step: float) -> None:
        """Pending device metrics -> RoundRecords, one host fetch per
        outstanding cloud interval, through the runner's shared helper."""
        r = self.runner
        n = r.topology.num_clients
        for round_base, metrics in self._pending:
            vals = {k: v.tolist() for k, v in metrics.items()}
            for j in range(self.k2):
                r._record_round(
                    round_base + j, int(vals["step"][j]), float(vals["loss"][j]),
                    float(vals["grad_norm"][j]), n, wire_per_step,
                )
        self._pending.clear()

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
                state, metrics = self._super(state, prefetcher.get())
                self._pending.append((round_base, metrics))
                end_round = round_base + self.k2
                if r.eval_fn is not None and r.cfg.eval_every and end_round % r.cfg.eval_every == 0:
                    self._flush(wire_per_step)
                    acc = float(r.eval_fn(r.eval_model(state.params)))
                    r.history[-1].accuracy = acc
                    if r.cfg.target_accuracy and acc >= r.cfg.target_accuracy:
                        stopped = True
                        break
            self._flush(wire_per_step)
        finally:
            prefetcher.stop()
        return state, stopped
