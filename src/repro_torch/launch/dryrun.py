"""The dry run: every (arch x shape) cell on the production meshes, counted
for one rank, with no device: the port of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --mesh single

JAX lowers and compiles each cell for 256 or 512 placeholder devices and
parses the HLO. Here the process makes a world of 256 or 512 ranks on
``torch.testing``'s "fake" process group (no collective moves a byte),
runs as rank 0 (the ranks of an SPMD cell are alike), lays
``launch.mesh.make_production_mesh`` over it (presented as NCCL, so NCCL's
program is what is counted) and runs ``launch.steps.build_cell``'s
function on the rank's arguments as tensors on the meta device (shapes
and dtypes, no data: torch's own fake tensors, whose ops run C++ shape
functions) under ``analysis.opcount``'s counter on the meta device,
under which meta tensors stand for the card's (``opcount.is_fake``,
``models.layers._on_card``); the meta device asks the CUDA runtime
nothing, so the dry run touches no card. (A ``FakeTensor`` on a fake CUDA device
cannot be indexed where torch was built without CUDA: Python indexing asks
for CUDA's device guard; and its Python dispatch made a train cell three
times slower.) It counts the FLOPs, the HBM bytes, each collective with
its mesh axis, and the arguments', outputs' and peak temporaries' bytes.
The routes take the card's path: K7 in the prefill, K8 in the RG-LRU
scan, K1 in the syncs, charged with their work functions, not built. For
``train`` cells on the single-pod mesh the edge and cloud syncs are
counted as cells of their own and amortised by kappa1 and kappa1 kappa2
(``analysis.roofline.hierfavg_step_terms``). A decode cell's caches are
what the rank's prefill would return (its requests and KV heads: JAX's
cache specs split the scanned layer dim).

One JSON per cell under ``--out`` (default ``artifacts/dryrun_torch/``),
with JAX's keys, ``hlo`` named ``ops``, ``compile_s`` named ``trace_s``,
``rank`` and ``counted`` added, XLA's ``cost_analysis`` dropped; a cell
that the port or JAX refuses (a head count the model axis does not split,
a client count the client axes do not divide) writes a record with
``refused`` and the words, counted apart from failures. Only failures set
the exit code. ``repro_torch.experiments.roofline_report`` prints the
table. Numbers are counts, not measurements. ``--jobs N`` counts N cells
side by side, each in a process and a fake world of its own (this process
counts a train cell while N - 1 spawned ones count the rest); ``--smoke``
and ``--host-mesh D,M`` count the smoke configs on a small mesh (tests,
probes).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.analysis import opcount
from repro_torch.analysis import roofline as rl
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke
from repro_torch.dist import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.tree import tree_map

COUNTED = "meta tensors, no device"
FAKE_DEVICE = "meta"  # stands for the card: ``models.layers._on_card``
MESHES = {False: "single_pod_16x16", True: "multi_pod_2x16x16"}


@contextlib.contextmanager
def fake_world(world_size: int):
    """A "fake" process group of ``world_size`` ranks with this process as
    rank 0; destroyed, and the hint mesh cleared, on the way out."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        sharding.set_hint_mesh(None)
        dist.destroy_process_group()


def _leaf(x, spec, mesh, device):
    """The rank's part of a stand-in ``x`` as a fresh tensor on ``device``.
    A 0-d integer leaf (the step count, which the host reads) holds the
    value 0 for the host to read (``opcount.hold_value``)."""
    if not isinstance(x, torch.Tensor):
        return x
    part = x if spec is None else spec.shard(x, mesh)
    out = torch.empty(tuple(part.shape), dtype=x.dtype, device=device)
    if x.dim() == 0 and not x.dtype.is_floating_point:
        opcount.hold_value(out, 0)
    return out


def rank_args(cell: steps.Cell, mesh, cfg, device) -> tuple:
    """This rank's arguments of ``cell`` on ``device``: each stand-in cut by
    its spec (``steps.shard_args``' cut, on shapes alone); under an
    "ep_data" mesh the params keep this rank's experts; a decode cell's
    caches are fresh ones of the rank's requests and KV heads, as its
    prefill returns them."""
    structs = list(cell.arg_structs)
    if cell.meta.get("ep_mode") == "ep_data":
        structs[0] = sharding.expert_rows(structs[0], mesh)
    args = [tree_map(lambda x, s: _leaf(x, s, mesh, device), a, tree_map(lambda _: None, a) if s is None else s)
            for a, s in zip(structs, cell.arg_specs)]
    if cell.meta["kind"] == "decode":
        params, tokens = args[0], args[2]
        with sharding.using_hint_mesh(mesh):
            args[1] = transformer.init_decode_caches(params, cfg, tokens.shape[0], cell.meta["cache_len"], device)
    return tuple(args)


def counted(cell: steps.Cell, mesh, cfg, device):
    """(the rank's arguments, the ``OpSummary`` of one call of the cell)."""
    args = rank_args(cell, mesh, cfg, device)
    _, summary = opcount.count(cell.fn, *args, mesh=mesh, device=torch.device(device).type)
    return args, summary


def run_cell(cfg, shape: ShapeSpec, mesh, mesh_name: str, *, phases: bool, device=FAKE_DEVICE) -> dict:
    """One cell's artifact (``refused`` with the words when a builder
    refuses it)."""
    chips = mesh.size
    t0 = time.time()
    try:
        cell = steps.build_cell(cfg, shape, mesh)
    except ValueError as e:
        return {"arch": cfg.name, "shape": shape.name, "kind": shape.kind, "mesh": mesh_name, "chips": chips,
                "rank": mesh.rank, "counted": COUNTED, "refused": str(e)}
    args, summary = counted(cell, mesh, cfg, device)
    del args
    mf = rl.model_flops(cfg, shape)
    local = rl.from_summary(f"{cfg.name}/{shape.name}/{mesh_name}", summary, chips, model_flops_global=mf)
    out = {
        "arch": cfg.name, "shape": shape.name, "kind": shape.kind, "mesh": mesh_name, "chips": chips,
        "rank": mesh.rank, "counted": COUNTED, "trace_s": time.time() - t0, "memory": summary.memory,
        "ops": summary.to_dict(), "meta": cell.meta, "roofline": local.to_dict(),
    }
    if phases and shape.kind == "train":
        edge_cell, cloud_cell = steps.build_aggregation_cells(cfg, mesh)
        _, e_sum = counted(edge_cell, mesh, cfg, device)
        _, c_sum = counted(cloud_cell, mesh, cfg, device)
        e_terms = rl.from_summary("edge", e_sum, chips)
        c_terms = rl.from_summary("cloud", c_sum, chips)
        k1, k2 = cfg.fed.kappa1, cfg.fed.kappa2
        amort = rl.hierfavg_step_terms(f"{cfg.name}/{shape.name}/{mesh_name}/amortized", local, e_terms,
                                       c_terms, k1, k2)
        out["phases"] = {"edge": e_terms.to_dict(), "cloud": c_terms.to_dict(), "edge_ops": e_sum.to_dict(),
                         "cloud_ops": c_sum.to_dict(), "amortized_step": amort.to_dict(), "kappa1": k1,
                         "kappa2": k2}
        out["trace_s"] = time.time() - t0
    return out


def _line(rec: dict) -> str:
    r, m = rec["roofline"], rec["memory"]
    return (f"  OK {rec['trace_s']:.1f}s traced | mem/rank: arg {m['argument_size_in_bytes'] / 1e9:.2f}GB "
            f"temp {m['temp_size_in_bytes'] / 1e9:.2f}GB | compute {r['compute_s'] * 1e3:.2f}ms "
            f"memory {r['memory_s'] * 1e3:.2f}ms collective {r['collective_s'] * 1e3:.2f}ms -> {r['dominant']}")


def _mesh_specs(args):
    """(mesh name, shape, axes, whether its train cells count their phases)
    of each mesh to count on."""
    if args.host_mesh:
        shape = tuple(int(x) for x in args.host_mesh.split(","))
        axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
        return [("host_" + "x".join(map(str, shape)), shape, axes, True)]
    multis = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    return [(MESHES[m], (2, 16, 16) if m else (16, 16), ("pod", "data", "model") if m else ("data", "model"), not m)
            for m in multis]


def count_cells(mesh_spec, cells, out_dir: str, smoke: bool, phases: bool) -> list:
    """Count ``cells`` ((arch, shape name) pairs) on one mesh in a fake
    world of its own, writing each artifact: [(tag, "ok" | "refused" |
    "failed", the line to print)]."""
    name, shape, axes, with_phases = mesh_spec
    done = []
    with fake_world(math.prod(shape)):
        if name in MESHES.values():
            mesh = mesh_mod.make_production_mesh(multi_pod=len(shape) == 3, device=FAKE_DEVICE)
        else:
            mesh = mesh_mod.make_host_mesh(shape, axes, device=FAKE_DEVICE)
        for arch, shape_name in cells:
            cfg = get_smoke(arch) if smoke else get_config(arch)
            cell_shape = next(s for s in cfg.input_shapes if s.name == shape_name)
            tag = f"{arch}__{shape_name}__{name}"
            try:
                rec = run_cell(cfg, cell_shape, mesh, name, phases=phases and with_phases)
            except Exception as e:  # noqa: BLE001 - a failed cell is reported and counted
                done.append((tag, "failed", f"  FAIL: {e!r}\n{traceback.format_exc()}"))
                continue
            with open(os.path.join(out_dir, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
            if "refused" in rec:
                done.append((tag, "refused", rec["refused"]))
            else:
                done.append((tag, "ok", _line(rec)))
    return done


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all", help="comma-separated arch ids, or all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--force", action="store_true", help="count cells whose artifact exists")
    ap.add_argument("--no-phases", action="store_true")
    ap.add_argument("--smoke", action="store_true", help="the archs' smoke configs (tests, probes)")
    ap.add_argument("--host-mesh", default=None,
                    help='a small ("data", "model") mesh, e.g. 2,2, in place of the production ones')
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes counting cells side by side, this one among them (one cell each)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    work = []  # (mesh spec, [(arch, shape)])
    heavy = []  # per cell, in order: whether it is a train cell
    for spec in _mesh_specs(args):
        cells = []
        for arch in archs:
            cfg = get_smoke(arch) if args.smoke else get_config(arch)
            for skipped in cfg.skipped_shapes:
                if args.shape in ("all", skipped) and spec[3]:
                    print(f"[skip] {arch} x {skipped}: full attention")
            for shape in cfg.input_shapes:
                if args.shape not in ("all", shape.name):
                    continue
                tag = f"{arch}__{shape.name}__{spec[0]}"
                if os.path.exists(os.path.join(args.out, tag + ".json")) and not args.force:
                    print(f"[cached] {tag}")
                    continue
                cells.append((arch, shape.name))
                heavy.append(shape.kind == "train")
        work.append((spec, cells))
    t_all = time.time()
    phases = not args.no_phases
    tasks = [(spec, cell) for spec, cells in work for cell in cells]
    if args.jobs > 1 and len(tasks) > 1:
        import concurrent.futures
        import multiprocessing

        # this process counts one cell (a train cell, the longest) while
        # the spawned workers import torch and count the rest
        own = heavy.index(True) if True in heavy else 0
        with concurrent.futures.ProcessPoolExecutor(min(args.jobs - 1, len(tasks) - 1),
                                                    mp_context=multiprocessing.get_context("spawn")) as ex:
            futures = {i: ex.submit(count_cells, spec, [cell], args.out, args.smoke, phases)
                       for i, (spec, cell) in enumerate(tasks) if i != own}
            mine = count_cells(tasks[own][0], [tasks[own][1]], args.out, args.smoke, phases)
            results = [r for i in range(len(tasks)) for r in (mine if i == own else futures[i].result())]
    else:
        results = [r for spec, cells in work for r in count_cells(spec, cells, args.out, args.smoke, phases)]
    for tag, status, line in results:
        print(f"[trace+count] {tag} ...\n" + (f"  REFUSED: {line}" if status == "refused" else line), flush=True)
    failures = [(t, line) for t, status, line in results if status == "failed"]
    refused = [(t, line) for t, status, line in results if status == "refused"]
    done = sum(status == "ok" for _, status, _ in results)
    print(f"\n{'=' * 60}\ndry run complete in {time.time() - t_all:.1f}s; {done} counted, {len(refused)} refused, "
          f"{len(failures)} failures")
    for tag, why in refused:
        print(f"  REFUSED {tag}: {why[:200]}")
    for tag, err in failures:
        print(f"  FAIL {tag}: {err.strip().splitlines()[0][:200]}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
