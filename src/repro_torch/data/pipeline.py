"""Federated batching: per-client iterators -> stacked (N, b, ...) batches,
and the background prefetch of superround blocks onto the device.

``FederatedBatcher`` and ``VirtualClientBatcher`` are copy-ports of
``repro.data.pipeline``'s (numpy): same per-client, per-epoch shuffles (and
a virtual client's shard from the same seeds), so their blocks are
byte-identical to the JAX package's. ``CohortPrefetcher`` adds sampled
participation to ``SuperBatchPrefetcher``. Batches are flat dicts of numpy
arrays; a ``batch_fn`` maps the gathered sample arrays to them (the LM's
maps its token rows to ``inputs`` / ``targets``, kept int32 as JAX keeps
them: the embedding lookup and the loss's gather index with int32 on the
device).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import aggregation

Batch = Dict[str, np.ndarray]


def split_microbatches(batch_fn: Callable[[Batch], Batch], grad_accum: int) -> Callable[[Batch], Batch]:
    """``batch_fn`` whose (N, b, ...) leaves come back as (grad_accum, N,
    b // grad_accum, ...): each client's batch cut into ``grad_accum``
    consecutive microbatches, the layout ``FederatedRunner(grad_accum=)``
    and the JAX package's accumulating local step take."""

    def split(d: Batch) -> Batch:
        out = {}
        for k, v in batch_fn(d).items():
            n, b = v.shape[:2]
            if b % grad_accum:
                raise ValueError(f"batch of {b} does not split into {grad_accum} microbatches")
            out[k] = np.ascontiguousarray(np.swapaxes(v.reshape((n, grad_accum, b // grad_accum) + v.shape[2:]), 0, 1))
        return out

    return split


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

    def next_batch_for(self, ids: Sequence[int]) -> Batch:
        """One cohort batch: leaves (C, b, ...); advances only the sampled
        clients' cursors. With ids == range(N) this is ``next_batch``
        exactly (the same per-client draw order)."""
        idx = np.stack([self._next_for(int(i)) for i in ids])  # (C, b)
        return self.batch_fn({k: v[idx] for k, v in self.arrays.items()})

    def next_batches_for(self, ids: Sequence[int], count: int) -> Batch:
        """``count`` cohort batches with a leading step axis: (count, C, b, ...)."""
        outs = [self.next_batch_for(ids) for _ in range(count)]
        return {k: np.stack([o[k] for o in outs]) for k in outs[0]}

    def state_dict(self) -> Dict[str, Any]:
        """The cursors (restart safety)."""
        return {"seed": self.seed, "cursors": [(c.epoch, c.pos) for c in self.cursors]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.seed = state["seed"]
        for c, (e, p) in zip(self.cursors, state["cursors"]):
            c.epoch, c.pos = e, p
        self._orders = [self._order(i) for i in range(self.num_clients)]


class VirtualClientBatcher:
    """A population of N *virtual* clients over a shared sample pool
    (``repro/data/pipeline.py:126-236``).

    A client's shard is a pure function of ``(seed, client_id)``:
    ``samples_per_client`` bootstrap draws from the pool, realized only
    when the client is sampled into a cohort; its per-epoch order comes
    from ``(seed, client_id, epoch)``. The cursors hold only the clients
    that ever participated, so host memory grows with the participants, not
    with N. The draws are the JAX package's generator for generator, so
    the batches are bit-equal to its.
    """

    _SHARD_NS = 0x5A4D  # namespaces the shard draw away from the order draw

    def __init__(
        self,
        arrays: Dict[str, np.ndarray],
        *,
        num_clients: int,
        samples_per_client: int,
        batch_size: int,
        seed: int = 0,
        batch_fn: Optional[Callable[[Batch], Batch]] = None,
    ):
        self.arrays = arrays
        self.num_clients = int(num_clients)
        self.samples_per_client = int(samples_per_client)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.batch_fn = batch_fn or (lambda d: d)
        self.num_samples = int(next(iter(arrays.values())).shape[0])
        if self.samples_per_client < self.batch_size:
            raise ValueError(f"samples_per_client {self.samples_per_client} < batch_size {self.batch_size}")
        self.cursors: Dict[int, ClientCursor] = {}

    @property
    def data_sizes(self) -> np.ndarray:
        return np.full(self.num_clients, self.samples_per_client, np.float64)

    def _shard(self, client: int) -> np.ndarray:
        """(samples_per_client,) pool indices: the client's virtual dataset."""
        rng = np.random.default_rng((self.seed, self._SHARD_NS, client))
        return rng.integers(0, self.num_samples, self.samples_per_client)

    def _order(self, client: int, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, client, epoch))
        return rng.permutation(self.samples_per_client)

    def _take_rows(self, client: int, nbatches: int) -> np.ndarray:
        """(nbatches, b) pool indices; advances the client's cursor, with
        ``FederatedBatcher._next_for``'s epochs (no partial batch: the
        epoch reshuffles instead)."""
        cur = self.cursors.setdefault(client, ClientCursor())
        shard = self._shard(client)
        b = self.batch_size
        order = None
        out = np.empty((nbatches, b), np.int64)
        for j in range(nbatches):
            if cur.pos + b > self.samples_per_client:
                cur.epoch += 1
                cur.pos = 0
                order = None
            if order is None:
                order = self._order(client, cur.epoch)
            out[j] = shard[order[cur.pos : cur.pos + b]]
            cur.pos += b
        return out

    def next_batch_for(self, ids: Sequence[int]) -> Batch:
        """One cohort batch: leaves (C, b, ...)."""
        rows = np.stack([self._take_rows(int(c), 1)[0] for c in ids])  # (C, b)
        return self.batch_fn({k: v[rows] for k, v in self.arrays.items()})

    def next_batches_for(self, ids: Sequence[int], count: int) -> Batch:
        """``count`` cohort batches with a leading step axis: (count, C, b, ...)."""
        rows = np.stack([self._take_rows(int(c), count) for c in ids], axis=1)
        return self.batch_fn({k: v[rows] for k, v in self.arrays.items()})

    def next_batch(self) -> Batch:
        """Full-population batch (small N only)."""
        return self.next_batch_for(range(self.num_clients))

    def next_batches(self, count: int) -> Batch:
        outs = [self.next_batch() for _ in range(count)]
        return {k: np.stack([o[k] for o in outs]) for k in outs[0]}

    def state_dict(self) -> Dict[str, Any]:
        # string keys: the dict rides checkpoint metadata through JSON,
        # which stringifies int keys
        return {"seed": self.seed, "cursors": {str(c): (cur.epoch, cur.pos) for c, cur in self.cursors.items()}}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.seed = int(state["seed"])
        self.cursors = {int(c): ClientCursor(epoch=int(e), pos=int(p)) for c, (e, p) in state["cursors"].items()}


def _pinned(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` in pinned host memory when it is bound for a CUDA device, so
    the copy can be non-blocking."""
    return t.pin_memory() if device.type == "cuda" else t


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

    ``transform`` is an optional host (numpy) hook on each (rounds, steps,
    N, b, ...) leaf before it is pinned: a rank of a client mesh keeps its
    own clients' columns in placement order (``fed.engine``), so only they
    are copied to its device.
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
        transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ):
        self.batcher = batcher
        self.transform = transform
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

    def _host_block(self, flat: Batch) -> Dict[str, torch.Tensor]:
        """(count, ...) batches -> the (rounds, steps, ...) block, pinned
        for a CUDA device."""
        lead = (self.rounds_per_block, self.steps_per_round)
        keep = self.transform or (lambda a: a)
        return {k: _pinned(torch.from_numpy(keep(v.reshape(lead + v.shape[1:]))), self.device) for k, v in flat.items()}

    def _produce(self):
        """Worker side: (host item, the snapshot a checkpoint at its end
        records)."""
        block = self._host_block(self.batcher.next_batches(self.rounds_per_block * self.steps_per_round))
        return block, self.batcher.state_dict()

    def _upload(self, block):
        """Consumer side: the host item on the device, on the current stream."""
        return {k: v.to(self.device, non_blocking=True) for k, v in block.items()}

    def _worker(self) -> None:
        try:
            while not self._stop.is_set() and (
                self.num_blocks is None or self._produced < self.num_blocks
            ):
                item = (self._OK, self._produce())
                self._produced += 1
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # surface worker failures at the next get()
            self._queue.put((self._ERR, e))

    def get(self):
        """The next block on the device. Blocks until the host block is
        ready; the device copy is enqueued on the current stream."""
        if self.num_blocks is not None and self._consumed >= self.num_blocks:
            raise RuntimeError(f"prefetcher exhausted: all {self.num_blocks} blocks consumed")
        kind, item = self._queue.get()
        if kind == self._ERR:
            raise RuntimeError("super-batch prefetch worker failed") from item
        host, self.snapshot = item
        self._consumed += 1
        return self._upload(host)

    def stop(self) -> None:
        """Stop the worker (idempotent). Call when abandoning blocks early."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


class CohortPrefetcher(SuperBatchPrefetcher):
    """``SuperBatchPrefetcher`` for sampled participation
    (``repro/data/pipeline.py:372-466``, single device).

    The worker also draws the next cloud interval's cohort from a
    ``fed.participation`` sampler and builds everything that is a pure
    function of the cohort ids: the (kappa2, kappa1, C, b, ...) batch
    block, the cohort's (C,) weights, and its staged-mean stages
    (``core.aggregation.cohort_stages``: each level's ids compacted to the
    nodes present, with K2's offsets table where the ids are ragged), all
    in pinned host memory, so sampling, the gathers and the tables overlap
    the previous interval's compute; ``get()`` copies them to the device
    without blocking. The clients' sticky optimizer rows are not
    prefetched: consecutive cohorts may overlap, so the engine swaps them
    after the previous interval's write-back.

    ``get()`` returns ``(ids, cohort, block)``: the host-side int64 ids,
    ``{"segments": (depth-1, C) host ids, "weights": (C,), "stages": ...}``
    on the device, and the block. Restart safety: ``snapshot`` is then
    ``{"batcher": ..., "sampler": ...}`` as of that block's end (both run
    ahead of the computation).

    With a ``layout`` (a rank's view of a sharded cohort's slot placement,
    ``fed.engine._MeshLayout``), the worker keeps the rank's slot columns of
    the block in slot placement order (phantom slots repeat slot 0's batch)
    and the cohort carries only ``"weights"``, the rank's weights (phantoms
    0): placement-stable packing makes every segment table static, so none
    is built or uploaded.
    """

    def __init__(
        self,
        batcher,
        sampler,
        *,
        segments: np.ndarray,
        weights: np.ndarray,
        rounds_per_block: int,
        steps_per_round: int,
        device: torch.device,
        num_blocks: Optional[int] = None,
        layout=None,
    ):
        # fields first: the base __init__ starts the worker
        self.sampler = sampler
        self._segments = np.ascontiguousarray(np.asarray(segments, np.int32))
        self._weights = np.asarray(weights, np.float32)
        self._layout = layout
        super().__init__(batcher, rounds_per_block=rounds_per_block, steps_per_round=steps_per_round,
                         device=device, num_blocks=num_blocks, transform=None if layout is None else layout.block)

    def _produce(self):
        ids = np.asarray(self.sampler.sample(), np.int64)
        block = self._host_block(
            self.batcher.next_batches_for(ids, self.rounds_per_block * self.steps_per_round))
        snapshot = {"batcher": self.batcher.state_dict(), "sampler": self.sampler.state_dict()}
        if self._layout is not None:
            w = self._layout.weights(self._weights[ids])
            return (ids, None, _pinned(torch.from_numpy(w), self.device), None, None, block), snapshot
        segments = self._segments[:, ids]
        stages = aggregation.cohort_stages(segments, ids.shape[0])
        pin = lambda a: _pinned(torch.from_numpy(a), self.device)
        tables = [tuple(None if a is None else pin(a) for a in aggregation.stage_host_tables(st)) for st in stages]
        host = (ids, segments, pin(np.ascontiguousarray(self._weights[ids])), stages, tables, block)
        return host, snapshot

    def _upload(self, host):
        ids, segments, weights, stages, tables, block = host
        if stages is None:  # a sharded cohort's rank: its weights only
            return ids, {"weights": weights.to(self.device, non_blocking=True)}, super()._upload(block)
        cohort = {
            "segments": segments,
            "weights": weights.to(self.device, non_blocking=True),
            "stages": aggregation.stages_to_device(stages, tables, self.device, non_blocking=True),
        }
        return ids, cohort, super()._upload(block)


def global_batch_iterator(arrays: Dict[str, np.ndarray], batch_size: int, *, seed: int = 0) -> Iterator[Batch]:
    """Simple epoch-shuffled global iterator (non-federated paths): the
    same batches as ``repro.data.pipeline.global_batch_iterator`` for the
    same seed (one ``default_rng((seed, epoch))`` permutation an epoch, the
    tail that does not fill a batch dropped)."""
    n = next(iter(arrays.values())).shape[0]
    epoch = 0
    while True:
        order = np.random.default_rng((seed, epoch)).permutation(n)
        for s in range(0, n - batch_size + 1, batch_size):
            take = order[s:s + batch_size]
            yield {k: v[take] for k, v in arrays.items()}
        epoch += 1
