"""Shared harness for the paper's figure and table scripts: thin wrappers
over the declarative ``repro_torch.fed.api`` spec layer.

The paper's experiments are MNIST and CIFAR CNNs on 50 clients and 5
edges. The stand-in keeps the topology and the partition protocols with
the synthetic 10-class data (``data.synthetic``) and a small MLP; the cost
model keeps the paper's Table I constants, so T_alpha and E_alpha are the
paper's accounting. Every helper assembles an ``ExperimentSpec`` and runs
it through ``run_spec``.

Every run takes ``device`` (``cuda`` unless the caller names one; without a
GPU and without a device it raises) and ``init``, a function of the spec
that returns the unstacked initial parameters in place of the spec's own
init (a JAX init carried across with ``spec.params_from_numpy``, say).
``recorded_runs`` collects the runner of every run made while it is open.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, List, Optional

import torch

from repro_torch.device import DeviceLike
from repro_torch.fed.api import (
    AggregatorSpec,
    CostSpec,
    DataSpec,
    ExperimentSpec,
    ModelSpec,
    RunSpec,
    ScheduleSpec,
    TopologySpec,
    TransportSpec,
)

Init = Optional[Callable[[ExperimentSpec], dict]]
_RECORDERS: List[list] = []


@contextlib.contextmanager
def recorded_runs():
    """``with recorded_runs() as runs:`` appends to ``runs`` the runner of
    every ``run_spec`` call made inside the block, in order."""
    runs: list = []
    _RECORDERS.append(runs)
    try:
        yield runs
    finally:
        _RECORDERS.remove(runs)


def run_spec(spec: ExperimentSpec, *, device: DeviceLike = None, init: Init = None, resume: bool = False):
    """Train ``spec`` on ``device``: ``(runner, final_state)``."""
    params = None if init is None else init(spec)
    runner, state = spec.run_experiment(device=device, params=params, resume=resume)
    for runs in _RECORDERS:
        runs.append(runner)
    return runner, state


def _levels_text(spec_or_text, default: str) -> str:
    """Accept a codec/aggregator string or a built per-level spec object."""
    if spec_or_text is None:
        return default
    if isinstance(spec_or_text, str):
        return spec_or_text
    return spec_or_text.describe()


def bench_spec(kappa1, kappa2, *, partition="edge_iid", rounds=None, seed=0,
               workload="mnist", eval_every=1, lr=0.15, class_sep=3.5,
               transport=None, aggregators=None, fanouts="", kappas=None) -> ExperimentSpec:
    """The stand-in problem as a spec: 50 clients on 5 edges (or the
    ``fanouts`` tree), exponential-decay SGD, the paper's cost constants."""
    kv = tuple(kappas) if kappas is not None else (kappa1, kappa2)
    if rounds is None:
        rounds = max(240 // kv[0], 6)
    return ExperimentSpec(
        name=f"bench_k{'_'.join(map(str, kv))}_{partition}",
        topology=TopologySpec(fanouts=fanouts) if fanouts
        else TopologySpec(num_edges=5, clients_per_edge=10),
        schedule=ScheduleSpec(kappas=kv),
        data=DataSpec(partition=partition, class_sep=class_sep, seed=seed),
        model=ModelSpec(lr=lr, lr_schedule="exponential"),
        transport=TransportSpec(levels=_levels_text(transport, "identity")),
        aggregators=AggregatorSpec(levels=_levels_text(aggregators, "weighted_mean")),
        cost=CostSpec(workload=workload),
        run=RunSpec(num_rounds=rounds, eval_every=eval_every, seed=seed),
    )


def run_schedule(kappa1, kappa2, *, partition="edge_iid", rounds=None, seed=0,
                 workload="mnist", eval_every=1, lr=0.15, class_sep=3.5,
                 transport=None, aggregators=None, device: DeviceLike = None, init: Init = None):
    """Train one (kappa1, kappa2) schedule; returns the runner (its history
    has loss, accuracy, T and E per round). ``transport`` (a
    ``fed.transport.TransportSpec`` or a codec string like 'identity/int8')
    compresses the uplinks; ``aggregators`` (a
    ``core.aggregation.AggregatorSpec`` or a string like
    'trimmed_mean:0.1/weighted_mean') swaps the per-level statistic."""
    spec = bench_spec(
        kappa1, kappa2, partition=partition, rounds=rounds, seed=seed,
        workload=workload, eval_every=eval_every, lr=lr, class_sep=class_sep,
        transport=transport, aggregators=aggregators,
    )
    return run_spec(spec, device=device, init=init)[0]


def run_hierarchy_schedule(spec, kappas, *, partition="edge_iid", rounds=None, seed=0,
                           workload="mnist", eval_every=1, lr=0.15, class_sep=3.5,
                           transport=None, aggregators=None, device: DeviceLike = None, init: Init = None):
    """Train one kappa-vector schedule on a (possibly ragged)
    ``core.hierarchy.HierarchySpec``; returns the runner. The two-level
    uniform call is ``run_schedule`` on the matching topology."""
    exp = bench_spec(
        kappas[0], kappas[1] if len(kappas) > 1 else 1, kappas=tuple(kappas),
        fanouts=spec.fanouts_text(), partition=partition, rounds=rounds,
        seed=seed, workload=workload, eval_every=eval_every, lr=lr,
        class_sep=class_sep, transport=transport, aggregators=aggregators,
    )
    return run_spec(exp, device=device, init=init)[0]


def first_reach(runner, alpha):
    """(steps, T, E) when the accuracy first reached alpha; None if never."""
    for h in runner.history:
        if h.accuracy is not None and h.accuracy >= alpha:
            return h.step, h.sim_time_s, h.sim_energy_j
    return None


def merge_write_json(path, results, *, skip_empty=()):
    """Merge-preserving JSON write to ``path``: load the file if it exists,
    overwrite only the keys in ``results``, keep everything else. A key in
    ``skip_empty`` whose new value is falsy keeps its recorded value, so a
    partial run (``--smoke``, one section) does not clobber another's
    sweep. Returns the merged dict as written."""
    merged = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                merged = json.load(f)
        except (OSError, ValueError):
            merged = {}
    if not isinstance(merged, dict):
        merged = {}
    for key, val in results.items():
        if key in skip_empty and not val and key in merged:
            continue
        merged[key] = val
    with open(path, "w") as f:
        json.dump(merged, f, indent=2)
    return merged


def _synchronize() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn, *args, iters=5, warmup=2):
    """(mean seconds a call over ``iters`` calls after ``warmup``, the last
    output), each call ending in a device synchronise."""
    for _ in range(warmup):
        fn(*args)
        _synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
        _synchronize()
    return (time.perf_counter() - t0) / iters, out


def add_device_argument(ap) -> None:
    """The scripts' ``--device`` flag: the card unless it names another."""
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu; without a GPU and without it, "
                    "the script raises")
