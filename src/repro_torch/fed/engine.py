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
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.hierfavg import FedState, build_megakernel_super_round, build_super_round
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
                masks = None if mask_stack is None else torch.as_tensor(mask_stack).to(r.device)
                state, metrics = self._super(state, block, masks)
                self._pending.append((round_base, alive, metrics))
                end_round = round_base + self.k2
                do_eval = r.eval_fn is not None and r.cfg.eval_every and end_round % r.cfg.eval_every == 0
                do_ckpt = r.checkpointer is not None and r.cfg.checkpoint_every and (
                    end_round % r.cfg.checkpoint_every == 0)
                if do_eval or do_ckpt:
                    self._flush(wire_per_step)
                acc = None
                if do_eval:
                    acc = float(r.eval_fn(r.eval_model(state.params, r._mask_to_device(last_mask))))
                    r.history[-1].accuracy = acc
                if do_ckpt:
                    r.checkpointer.save(r.history[-1].step, state, r._checkpoint_meta(end_round, prefetcher.snapshot))
                if acc is not None and r.cfg.target_accuracy and acc >= r.cfg.target_accuracy:
                    stopped = True
                    break
            self._flush(wire_per_step)
        finally:
            prefetcher.stop()
        return state, stopped
