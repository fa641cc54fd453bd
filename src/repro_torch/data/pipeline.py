"""Federated batching: per-client iterators -> stacked (N, b, ...) batches,
and the background prefetch of superround blocks onto the device.

``FederatedBatcher`` is a copy-port of ``repro.data.pipeline``'s (numpy):
same per-client, per-epoch shuffles, so its blocks are byte-identical to
the JAX package's. Batches are flat dicts of numpy arrays; a ``batch_fn``
maps the gathered sample arrays to them (the LM's maps its token rows to
``inputs`` / ``targets``, kept int32 as JAX keeps them: the embedding
lookup and the loss's gather index with int32 on the device).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

Batch = Dict[str, np.ndarray]


@dataclasses.dataclass
class ClientCursor:
    epoch: int = 0
    pos: int = 0


class FederatedBatcher:
    """Stateful, restart-safe federated batcher over a dict of sample arrays
    (first axis = sample). ``batch_fn`` maps each gathered dict of
    (N, b, ...) arrays to the model's batch dict (default: identity)."""

    def __init__(
        self,
        arrays: Dict[str, np.ndarray],
        client_indices: Sequence[np.ndarray],
        batch_size: int,
        *,
        seed: int = 0,
        batch_fn: Optional[Callable[[Batch], Batch]] = None,
    ):
        self.arrays = arrays
        self.client_indices = [np.asarray(ix) for ix in client_indices]
        self.batch_size = batch_size
        self.seed = seed
        self.batch_fn = batch_fn or (lambda d: d)
        self.cursors = [ClientCursor() for _ in client_indices]
        self._orders: List[np.ndarray] = [self._order(i) for i in range(len(client_indices))]

    @property
    def num_clients(self) -> int:
        return len(self.client_indices)

    @property
    def data_sizes(self) -> np.ndarray:
        return np.array([ix.shape[0] for ix in self.client_indices], np.float64)

    def _order(self, client: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, client, self.cursors[client].epoch))
        return rng.permutation(self.client_indices[client])

    def _next_for(self, client: int) -> np.ndarray:
        cur = self.cursors[client]
        order = self._orders[client]
        b = self.batch_size
        if cur.pos + b > order.shape[0]:
            cur.epoch += 1
            cur.pos = 0
            self._orders[client] = order = self._order(client)
        take = order[cur.pos : cur.pos + b]
        cur.pos += b
        return take

    def next_batch(self) -> Batch:
        """One stacked batch: leaves (N, b, ...)."""
        idx = np.stack([self._next_for(i) for i in range(self.num_clients)])  # (N, b)
        return self.batch_fn({k: v[idx] for k, v in self.arrays.items()})

    def next_batches(self, count: int) -> Batch:
        """``count`` stacked batches with a leading step axis: (count, N, b, ...)."""
        outs = [self.next_batch() for _ in range(count)]
        return {k: np.stack([o[k] for o in outs]) for k in outs[0]}

    def state_dict(self) -> Dict[str, Any]:
        """The cursors (restart safety)."""
        return {"seed": self.seed, "cursors": [(c.epoch, c.pos) for c in self.cursors]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.seed = state["seed"]
        for c, (e, p) in zip(self.cursors, state["cursors"]):
            c.epoch, c.pos = e, p
        self._orders = [self._order(i) for i in range(self.num_clients)]


def to_device(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``. A synchronous copy: the
    per-round path and tests use it; the engine goes through the prefetcher."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


class SuperBatchPrefetcher:
    """Background assembly of superround batch blocks.

    The superround engine consumes one (rounds_per_block, steps_per_round,
    N, b, ...) block per cloud interval. A worker thread builds interval
    r+1's numpy block (the host gathers) and, on a CUDA device, copies it
    into pinned host memory while interval r computes; the queue holds one
    ready block.

    The host-to-device copy is issued by ``get()`` on the *consumer's*
    current stream, with ``non_blocking=True`` from the pinned buffer. It is
    therefore ordered before every kernel the consumer enqueues afterwards,
    with no side stream and no event to get wrong; the host does not wait
    for it. (The copy does not overlap the previous interval's kernels; a
    block is about 1 MB at the full-width MLP shape, far below one interval's
    device time.)

    ``num_blocks`` bounds total production so the batcher is left positioned
    exactly after the engine's rounds (a per-round remainder continues from
    it). The worker is the sole batcher consumer while the prefetcher is
    active.

    Restart safety: the worker runs ahead of the computation, so after each
    ``get()`` the batcher's ``state_dict`` as of the end of the block just
    returned is on ``snapshot``; checkpoints store that, never
    ``batcher.state_dict()`` itself.
    """

    _OK = "ok"
    _ERR = "err"

    def __init__(
        self,
        batcher: FederatedBatcher,
        *,
        rounds_per_block: int,
        steps_per_round: int,
        device: torch.device,
        num_blocks: Optional[int] = None,
    ):
        self.batcher = batcher
        self.rounds_per_block = int(rounds_per_block)
        self.steps_per_round = int(steps_per_round)
        self.device = torch.device(device)
        self.num_blocks = num_blocks
        self._produced = 0
        self._consumed = 0
        self.snapshot: Optional[Dict[str, Any]] = None
        self._queue: queue.Queue = queue.Queue(maxsize=1)  # double buffering
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, name="super-batch-prefetch", daemon=True)
        self._thread.start()

    def _make_host_block(self) -> Dict[str, torch.Tensor]:
        flat = self.batcher.next_batches(self.rounds_per_block * self.steps_per_round)
        lead = (self.rounds_per_block, self.steps_per_round)
        block = {k: torch.from_numpy(v.reshape(lead + v.shape[1:])) for k, v in flat.items()}
        if self.device.type == "cuda":
            block = {k: v.pin_memory() for k, v in block.items()}
        return block

    def _worker(self) -> None:
        try:
            while not self._stop.is_set() and (
                self.num_blocks is None or self._produced < self.num_blocks
            ):
                block = self._make_host_block()
                item = (self._OK, (block, self.batcher.state_dict()))
                self._produced += 1
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # surface worker failures at the next get()
            self._queue.put((self._ERR, e))

    def get(self) -> Dict[str, torch.Tensor]:
        """The next block on the device. Blocks until the host block is
        ready; the device copy is enqueued on the current stream."""
        if self.num_blocks is not None and self._consumed >= self.num_blocks:
            raise RuntimeError(f"prefetcher exhausted: all {self.num_blocks} blocks consumed")
        kind, item = self._queue.get()
        if kind == self._ERR:
            raise RuntimeError("super-batch prefetch worker failed") from item
        block, self.snapshot = item
        self._consumed += 1
        return {k: v.to(self.device, non_blocking=True) for k, v in block.items()}

    def stop(self) -> None:
        """Stop the worker (idempotent). Call when abandoning blocks early."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
