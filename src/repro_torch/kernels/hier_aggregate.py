"""K1 ``grouped_mean`` and K2 ``segment_mean``: the aggregation operator on
hand-written CUDA kernels (``csrc/hier_aggregate.cu``), each beside its
plain PyTorch version; and K6 ``segment_dequant_mean``, K2 over int8
transport payloads decoded on the fly.

They replace the Pallas TPU kernels ``grouped_mean_pallas`` and
``segment_mean_pallas`` of ``repro/kernels/hier_aggregate.py`` and compute
the same function: x (N, D) stacked parameters of one leaf (f32 or bf16),
w (N,) f32 weights with the survival mask already folded in; each group's
weighted mean, accumulated in f32, broadcast back to its rows in x's type;
a group whose weights sum to zero keeps its rows bit for bit. K1 takes
equal contiguous groups, K2 groups given by sorted segment ids. K6
(``segment_dequant_mean_pallas``) takes K2's groups over int8 codes (N, D)
and f32 block scales (N, D / qblock), the row layout of
``kernels.quantize.quantize_stacked``, and returns f32; a dead group keeps
its decoded rows. The source notes what bounds the kernels on the card and
how they are laid out.

The wrappers choose K1/K2's schedule from the shape alone (``_schedule``:
one pass, or a tall group's rows split over blocks in two kernels) and
the C entry points execute it; K2's split reads its work items from the
level's ``segment_table``, built once with the offsets. Groups run on
grid.x, so every group count the int32 sizes admit is taken; a shape
beyond a limit is refused with a message that names it.

Dispatch is by the tensor's device alone: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel on the current stream (no
synchronisation) or raises. There is no fallback from one to the other. A
fake tensor (``opcount.is_fake``: the dry run's) charges ``analysis.opcount``
with the kernel's work and returns an empty output, neither built nor
launched.
``LAUNCHES`` counts wrapper calls that launched (one per call, whether
the schedule runs one device kernel or two), so a run can show that it
went through the kernels.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.analysis import opcount
from repro_torch.kernels import _build

LAUNCHES: Dict[str, int] = {"grouped_mean": 0, "segment_mean": 0, "segment_dequant_mean": 0}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- plain versions ------------------------------------------------------------


def grouped_mean_plain(x: torch.Tensor, w: torch.Tensor, num_groups: int) -> torch.Tensor:
    """K1's function in plain PyTorch, as the reshape/sum/where of
    ``repro.kernels.ref.grouped_mean_ref``."""
    n, d = x.shape
    c = n // num_groups
    xg = x.reshape(num_groups, c, d).to(torch.float32)
    wg = w.reshape(num_groups, c, 1).to(torch.float32)
    num = torch.sum(xg * wg, dim=1, keepdim=True)
    den = torch.sum(wg, dim=1, keepdim=True)
    mean = num / torch.where(den > 0, den, torch.ones_like(den))
    out = torch.where(den > 0, mean.expand_as(xg), xg)
    return out.reshape(n, d).to(x.dtype)


def segment_mean_plain(x: torch.Tensor, w: torch.Tensor, segment_ids, num_segments: int) -> torch.Tensor:
    """K2's function in plain PyTorch: segment sums with ``index_add_``,
    the means gathered back to the members, dead segments kept."""
    n, d = x.shape
    seg = torch.as_tensor(np.asarray(segment_ids), dtype=torch.long).to(x.device)
    wf = w.to(torch.float32)
    den = torch.zeros(num_segments, dtype=torch.float32, device=x.device).index_add_(0, seg, wf)
    sums = torch.zeros(num_segments, d, dtype=torch.float32, device=x.device)
    sums.index_add_(0, seg, x.to(torch.float32) * wf[:, None])
    mean = sums / torch.where(den > 0, den, torch.ones_like(den))[:, None]
    keep = (den > 0)[seg][:, None]
    return torch.where(keep, mean[seg], x.to(torch.float32)).to(x.dtype)


def segment_dequant_mean_plain(
    q: torch.Tensor, scales: torch.Tensor, w: torch.Tensor, segment_ids, num_segments: int
) -> torch.Tensor:
    """K6's function in plain PyTorch: decode ``q * scale`` per block (the
    math of ``repro.kernels.ref.segment_dequant_mean_ref``), then K2's plain
    version in f32."""
    n, d = q.shape
    nb = scales.shape[1]
    x = (q.to(torch.float32).reshape(n, nb, d // nb) * scales[..., None]).reshape(n, d)
    return segment_mean_plain(x, w, segment_ids, num_segments)


# -- the schedule ----------------------------------------------------------------

THREADS = 256  # threads per block (kThreads in csrc/hier_aggregate.cu)
SMS = 132  # streaming multiprocessors of an H100 SXM
FILL_BLOCKS = 2 * SMS  # a split aims at two blocks per SM
SPLIT_ABOVE = 64  # a group of at most this many rows always takes one pass
SPLIT_LANES = 32  # column slots per tile of a split: 512 contiguous bytes of f32 a row
SPLIT_ROWS = 16  # row threads per block of a split, at most
GRID_LIMIT = 2**31 - 1  # blocks on grid.x


class Schedule(NamedTuple):
    """How K1/K2 cover an (N, D) leaf, chosen on the host from the shape
    alone (``_schedule``); the C entry points execute it. A block holds
    ``groups_per_block`` groups x ``rows`` row threads x ``lanes`` column
    slots; a slot is ``vec`` columns (16 bytes, or one column where D is no
    multiple of 16 bytes). ``chunks`` > 1 splits each group into work items
    of ``chunk_rows`` rows and takes two kernels (partial sums, then the
    combine and the stores); 1 takes one kernel."""

    vec: int
    lanes: int
    rows: int
    groups_per_block: int
    tiles: int
    chunk_rows: int
    chunks: int

    @property
    def threads(self) -> int:
        return self.lanes * self.rows * self.groups_per_block

    @property
    def kernels(self) -> int:
        """Device kernels one call runs."""
        return 1 if self.chunks == 1 else 2

    def blocks(self, groups: int, items: Optional[int] = None) -> int:
        """Blocks of each kernel (on grid.x): the work items (K1: groups x
        chunks; K2: its table's) or the blocks of groups, times the tiles."""
        if self.chunks > 1:
            return (groups * self.chunks if items is None else items) * self.tiles
        return -(-groups // self.groups_per_block) * self.tiles


def _layout(d: int, itemsize: int, rows_per_group: int, groups: int, split: bool):
    """(vec, lanes, rows, groups_per_block, tiles). One pass: a tile spans up
    to 256 slots with one row thread each (row threads and their tree in
    shared memory made mlp307k's cloud mean slower on an H100), a narrow leaf
    (D = 10, 48) gets row threads, and short groups share a block, so no
    warp idles. Split: tiles of at most 32 slots and up to 16 row threads
    (256 threads at 16 or more slots; a narrow leaf's block stays small, so
    its rows spread over more blocks)."""
    vec = 16 // itemsize if d % (16 // itemsize) == 0 else 1
    slots = d // vec
    if split:
        lanes = min(slots, SPLIT_LANES)
        rows, per_block = min(THREADS // lanes, SPLIT_ROWS), 1
    else:
        lanes = min(slots, THREADS)
        rows = max(1, min(rows_per_group, THREADS // lanes))
        per_block = max(1, min(groups, THREADS // (lanes * rows)))
    return vec, lanes, rows, per_block, -(-slots // lanes)


@functools.lru_cache(maxsize=256)
def _schedule(rows_per_group: int, d: int, groups: int, itemsize: int,
              chunk_rows: Optional[int] = None) -> Schedule:
    """K1's schedule for ``groups`` groups of ``rows_per_group`` rows over
    ``d`` columns of ``itemsize`` bytes; a pure function of the shape. A
    group of more than ``SPLIT_ABOVE`` rows is split when one pass would
    give fewer than ``FILL_BLOCKS`` blocks: into enough chunks for that
    many, each of at least as many rows as the block has row threads (and
    at least 2 chunks). ``chunk_rows``, when given, fixes the chunk instead
    (K2: its table's, ``_segment_chunk_rows``)."""
    if chunk_rows is None:
        chunk_rows = rows_per_group
        if rows_per_group > SPLIT_ABOVE:
            *_, per_block, tiles = _layout(d, itemsize, rows_per_group, groups, False)
            if -(-groups // per_block) * tiles < FILL_BLOCKS:
                *_, rows, _, tiles = _layout(d, itemsize, rows_per_group, groups, True)
                want = -(-FILL_BLOCKS // (groups * tiles))
                chunks = max(2, min(want, rows_per_group // rows))
                chunk_rows = -(-rows_per_group // chunks)
    chunks = -(-rows_per_group // chunk_rows)
    vec, lanes, rows, per_block, tiles = _layout(d, itemsize, rows_per_group, groups, chunks > 1)
    return Schedule(vec, lanes, rows, per_block, tiles, chunk_rows, chunks)


def _segment_schedule(n: int, d: int, num_segments: int, itemsize: int, items: int) -> Schedule:
    """K2's schedule over ``n`` rows: a split's layout over its table's
    ``items`` work items, or (no items) one pass at the segments' mean
    height."""
    if items:
        return _schedule(n, d, num_segments, itemsize, chunk_rows=_segment_chunk_rows(n))
    rows = -(-n // num_segments)
    return _schedule(rows, d, num_segments, itemsize, chunk_rows=rows)


def _segment_chunk_rows(n: int) -> int:
    """Rows per work item in K2's table over ``n`` rows: a segment longer
    than this is split. It depends on ``n`` alone, so a level's table
    serves every leaf: a power of two at least twice sqrt(n) (at most
    n / chunk_rows^2 <= 1/4 of a segment's bytes re-read as partials), or
    ``n`` where no segment can exceed ``SPLIT_ABOVE`` rows."""
    if n <= SPLIT_ABOVE:
        return max(n, 1)
    r = 32
    while r * r < 4 * n:
        r *= 2
    return r


# -- kernel wrappers -------------------------------------------------------------


def _check_cuda(x: torch.Tensor, w: torch.Tensor, what: str, dtypes=tuple(_DTYPE_CODES)) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: tensors must be on the CPU (plain version) or CUDA, got {x.device}")
    if x.device != w.device:
        raise ValueError(f"{what}: x on {x.device} but weights on {w.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{what}: x is on {x.device} but the current CUDA device is {torch.cuda.current_device()}")
    if x.dim() != 2 or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"{what}: x must be a non-empty (N, D) matrix, got shape {tuple(x.shape)}")
    if x.dtype not in dtypes:
        names = " or ".join(str(t).removeprefix("torch.") for t in dtypes)
        raise ValueError(f"{what}: x dtype must be {names}, got {x.dtype}")
    if w.dtype != torch.float32 or tuple(w.shape) != (x.shape[0],):
        raise ValueError(f"{what}: weights must be float32 of shape ({x.shape[0]},), got {w.dtype} {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{what}: x and weights must be contiguous")
    if x.numel() >= 2**31:
        raise ValueError(f"{what}: x has {x.numel()} elements; the kernel indexes with int32 sizes (limit 2^31 - 1)")


def _check_grid(blocks: int, what: str, shape) -> None:
    if blocks > GRID_LIMIT:
        raise ValueError(f"{what}: shape {tuple(shape)} needs {blocks} blocks, beyond grid.x's limit of 2^31 - 1")


def _run(sched: Schedule, x: torch.Tensor, out: torch.Tensor, items: int):
    """(scratch for a split's partials, or None; the 16-byte-aligned flag)."""
    scratch = None
    if sched.chunks > 1:
        scratch = torch.empty(items * (x.shape[1] + 1), dtype=torch.float32, device=x.device)
    return scratch, int(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)


def grouped_mean(x: torch.Tensor, w: torch.Tensor, num_groups: int) -> torch.Tensor:
    """K1: per equal contiguous group, the f32 weighted mean of the rows of
    ``x`` (N, D), broadcast back; zero-weight groups keep their rows."""
    n = x.shape[0]
    if num_groups <= 0 or n % num_groups:
        raise ValueError(f"N={n} not divisible by num_groups={num_groups}")
    if x.device.type == "cpu":
        return grouped_mean_plain(x, w, num_groups)
    cost = opcount.grouped_mean_work(n, x.shape[1] if x.dim() == 2 else 0, x.element_size())
    if opcount.is_fake(x):  # the dry run's: charged, neither built nor launched
        opcount.charge("grouped_mean", *cost)
        return torch.empty_like(x)
    _check_cuda(x, w, "grouped_mean")
    d = x.shape[1]
    sched = _schedule(n // num_groups, d, num_groups, x.element_size())
    _check_grid(sched.blocks(num_groups), "grouped_mean", x.shape)
    with opcount.kernel_region("grouped_mean", *cost):
        out = torch.empty_like(x)
        scratch, aligned = _run(sched, x, out, num_groups * sched.chunks)
        err = _build.load("hier_aggregate").hier_grouped_mean(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(), n, d,
            num_groups, _DTYPE_CODES[x.dtype], sched.vec, sched.lanes, sched.rows, sched.groups_per_block,
            sched.chunk_rows, aligned, torch.cuda.current_stream().cuda_stream,
        )
    _build.raise_on_error(err, "grouped_mean", f"x {tuple(x.shape)} {x.dtype}, {num_groups} groups, {sched}")
    LAUNCHES["grouped_mean"] += 1
    return out


def segment_offsets(segment_ids, num_segments: int) -> np.ndarray:
    """(G+1,) int32 row offsets of each segment for sorted ids in [0, G):
    segment g owns rows [offsets[g], offsets[g+1]). Raises on unsorted or
    out-of-range ids."""
    ids = np.asarray(segment_ids)
    if ids.ndim != 1 or ids.size == 0:
        raise ValueError(f"segment_ids must be a non-empty vector, got shape {ids.shape}")
    if np.any(np.diff(ids) < 0):
        raise ValueError("segment_ids must be sorted (the members of a group are contiguous)")
    if ids[0] < 0 or ids[-1] >= num_segments:
        raise ValueError(f"segment_ids must lie in [0, {num_segments}), got [{ids[0]}, {ids[-1]}]")
    return np.searchsorted(ids, np.arange(num_segments + 1), side="left").astype(np.int32)


def segment_table(segment_ids, num_segments: int) -> np.ndarray:
    """K2's int32 table for sorted ids: their ``segment_offsets``; and, when
    a segment holds more than ``_segment_chunk_rows(N)`` rows, the work
    items of the split appended: the (G+1) first item of each segment (a
    segment has ceil(rows / chunk) items), then the segment of each item.
    K6 reads only the offsets."""
    offsets = segment_offsets(segment_ids, num_segments)
    counts = -(-np.diff(offsets) // _segment_chunk_rows(int(offsets[-1])))
    if counts.max() <= 1:
        return offsets
    first = np.concatenate([[0], np.cumsum(counts)])
    return np.concatenate([offsets, first, np.repeat(np.arange(num_segments), counts)]).astype(np.int32)


def table_items(table_size: int, num_segments: int) -> int:
    """Work items in a segment table of ``table_size`` entries (0: no
    segment is split)."""
    return 0 if table_size == num_segments + 1 else table_size - 2 * (num_segments + 1)


@functools.lru_cache(maxsize=64)
def _device_table(ids_bytes: bytes, num_segments: int, device: torch.device) -> torch.Tensor:
    """The segment table on ``device``, built once per (tree level, device):
    a fresh host-to-device copy per sync would stall the stream."""
    table = segment_table(np.frombuffer(ids_bytes, np.int64), num_segments)
    return torch.from_numpy(table).to(device)


def segment_mean(x: torch.Tensor, w: torch.Tensor, segment_ids, num_segments: int, *,
                 offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: per segment of sorted ``segment_ids`` (host-side, (N,)), the f32
    weighted mean of the rows of ``x`` (N, D), broadcast back; zero-weight
    segments keep their rows. ``offsets``, when given, is the ids'
    ``segment_table`` already on x's device (a sampled cohort's ids change
    every interval, so its table comes uploaded with the cohort rather than
    from the per-level cache); a bare ``segment_offsets`` table takes one
    pass whatever the segments' heights."""
    ids = np.asarray(segment_ids, np.int64)
    if ids.shape != (x.shape[0],):
        raise ValueError(f"segment_ids shape {ids.shape} != ({x.shape[0]},)")
    if x.device.type == "cpu":
        return segment_mean_plain(x, w, ids, num_segments)
    cost = opcount.segment_mean_work(x.shape[0], x.shape[1] if x.dim() == 2 else 0, x.element_size())
    if opcount.is_fake(x):  # the dry run's: charged, neither built nor launched
        opcount.charge("segment_mean", *cost)
        return torch.empty_like(x)
    _check_cuda(x, w, "segment_mean")
    g = int(num_segments)
    if offsets is None:
        offsets = _device_table(ids.tobytes(), g, x.device)
    elif (offsets.dtype != torch.int32 or offsets.dim() != 1 or offsets.device != x.device
          or not (offsets.numel() == g + 1 or offsets.numel() > 2 * (g + 1))):
        raise ValueError(f"segment_mean: offsets must be an int32 segment_table of {g} segments on {x.device} "
                         f"(G+1 = {g + 1} entries, or more than {2 * (g + 1)}), "
                         f"got {offsets.dtype} {tuple(offsets.shape)} on {offsets.device}")
    n, d = x.shape
    items = table_items(offsets.numel(), g)
    sched = _segment_schedule(n, d, g, x.element_size(), items)
    _check_grid(sched.blocks(g, items), "segment_mean", x.shape)
    with opcount.kernel_region("segment_mean", *cost):
        out = torch.empty_like(x)
        scratch, aligned = _run(sched, x, out, items)
        err = _build.load("hier_aggregate").hier_segment_mean(
            x.data_ptr(), w.data_ptr(), offsets.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), n, d, g, items, _DTYPE_CODES[x.dtype], sched.vec,
            sched.lanes, sched.rows, sched.groups_per_block, sched.chunk_rows, aligned,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.raise_on_error(err, "segment_mean", f"x {tuple(x.shape)} {x.dtype}, {g} segments, {items} work items, "
                                               f"{sched}")
    LAUNCHES["segment_mean"] += 1
    return out


def segment_dequant_mean(
    q: torch.Tensor, scales: torch.Tensor, w: torch.Tensor, segment_ids, num_segments: int
) -> torch.Tensor:
    """K6: per segment of sorted ``segment_ids`` (host-side, (N,)), the f32
    weighted mean of the decoded rows ``q * scale`` (q (N, D) int8, scales
    (N, D / qblock) f32), broadcast back; zero-weight segments keep their
    decoded rows."""
    n, d = q.shape
    if scales.dim() != 2 or scales.shape[0] != n or scales.shape[1] == 0 or d % scales.shape[1]:
        raise ValueError(f"scales shape {tuple(scales.shape)} incompatible with q {tuple(q.shape)}")
    ids = np.asarray(segment_ids, np.int64)
    if ids.shape != (n,):
        raise ValueError(f"segment_ids shape {ids.shape} != ({n},)")
    if q.device.type == "cpu":
        return segment_dequant_mean_plain(q, scales, w, ids, num_segments)
    _check_cuda(q, w, "segment_dequant_mean", dtypes=(torch.int8,))
    if scales.dtype != torch.float32 or scales.device != q.device or not scales.is_contiguous():
        raise ValueError("segment_dequant_mean: scales must be contiguous float32 on the device of q")
    offsets = _device_table(ids.tobytes(), int(num_segments), q.device)
    out = torch.empty((n, d), dtype=torch.float32, device=q.device)
    err = _build.load("hier_aggregate").hier_segment_dequant_mean(
        q.data_ptr(), scales.data_ptr(), w.data_ptr(), offsets.data_ptr(), out.data_ptr(), n, d,
        d // scales.shape[1], int(num_segments), torch.cuda.current_stream().cuda_stream,
    )
    _build.raise_on_error(err, "segment_dequant_mean", f"q {tuple(q.shape)}, {num_segments} segments")
    LAUNCHES["segment_dequant_mean"] += 1
    return out
