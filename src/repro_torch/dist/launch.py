"""Run a function on K local ranks: the launch recipe of the client mesh.

``spawn(fn, world_size, backend)`` starts K processes under the ``spawn``
start method, gives each an initialised ``torch.distributed`` process
group (``tcp://127.0.0.1:<free port>``, rank r of K, ``LOCAL_RANK`` r) and
calls ``fn(rank, world_size, *args)`` in it; it returns the K return
values in rank order and raises, with the rank's traceback, if any rank
raised. ``fn`` must be importable by name (a module-level function), and
its arguments and return value picklable. ``torchrun --nproc-per-node K``
with ``dist.init_process_group`` in the script is the other recipe.

Each rank runs one intra-op thread (``torch.set_num_threads(1)``), so K ranks
neither oversubscribe the CPU nor let the intra-op thread count, and with
it the rounding of a product, depend on the load. The CUDA kernels are
built before the ranks start when a card is present (``kernels._build``
also holds a file lock around its builds), so K ranks never run ``nvcc``
on the same source.
"""
from __future__ import annotations

import os
import socket
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    """A TCP port on the loopback interface that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world_size: int, backend: str, port: int, fn: Callable, args: Sequence[Any],
               results) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world_size)
    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world_size)
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # the parent re-raises it with the rank's traceback
        results.put((rank, False, traceback.format_exc()))


TIMEOUT_S = 3600.0  # the longest a world may run before the parent gives up


def spawn(fn: Callable, world_size: int, backend: str = "gloo", args: Sequence[Any] = ()) -> List[Any]:
    """``fn(rank, world_size, *args)`` on ``world_size`` ranks; their return
    values in rank order."""
    if torch.cuda.is_available():
        from repro_torch.kernels import _build

        _build.build_all()
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world_size, backend, port, fn, tuple(args), results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out: dict = {}
    failed = []
    try:
        for _ in range(world_size):
            rank, ok, value = _get(results, procs)
            if ok:
                out[rank] = value
            else:
                failed.append((rank, value))
                break
    finally:
        # every rank has reported, or one failed (the others may wait on it
        # in a collective): stop what is left
        for p in procs:
            p.join(timeout=60.0 if len(out) == world_size else 5.0)
            if p.is_alive():
                p.terminate()
                p.join()
    if failed:
        rank, tb = failed[0]
        raise RuntimeError(f"rank {rank} of {world_size} failed:\n{tb}")
    return [out[r] for r in range(world_size)]


def _get(results, procs):
    """The next result; raises if every process has exited without one."""
    deadline = time.monotonic() + TIMEOUT_S
    while True:
        if not results.empty():
            return results.get()
        if all(not p.is_alive() for p in procs) and results.empty():
            codes = [p.exitcode for p in procs]
            raise RuntimeError(f"the ranks exited without a result (exit codes {codes})")
        if time.monotonic() > deadline:
            raise TimeoutError(f"no rank reported within {TIMEOUT_S} s")
        time.sleep(0.01)
