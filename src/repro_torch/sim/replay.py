"""Event-queue replay of the round DAG -> time and energy *distributions*.

Copy-port of ``repro.sim.replay`` (host numpy), held to it bit for bit by
``tests/test_torch_sim.py``. Every draw is
made in the JAX package's order, so a replay from the same seed is
bit-identical to its replay.

The pipeline:

    dag   = build_round_dag(tree, kappas, ...)          # sim.dag
    costs = calibrate.from_workload(paper_workload(..)) # sim.calibrate
    net   = NetworkSpec(...).build(tree)                # sim.distributions
    res   = simulate_round(dag, costs, net, trials=200)
    res.summary()   # p50/p90/p99 round time, per-client energy, ...

Durations are assembled in two stages so that every consumer shares one
random world:

1. ``draw_jitter_tables`` draws per-trial jitter keyed by *canonical*
   ids — (trial, interval, step, client) for compute, (trial, interval,
   client) for uplinks, (trial, interval, node) for higher hops — from
   the ``NetworkModel``'s checkpointable streams. The tables cover the
   full population whether or not a client participates, so a draw never
   depends on cohorts, masks, or the client→edge assignment.
2. ``assemble_durations`` is a pure function (dag, costs, net, tables)
   -> (trials, nodes) float64. Candidate associations re-assemble against
   the *same* tables — common random numbers, so the optimizer compares
   assignments, not noise.

Replay itself comes in two provably identical forms: ``sweep`` (a
vectorized forward pass over the topological order, all trials at once —
the workhorse) and ``replay_once`` (a heap-based event queue for one
trial — the readable reference, used for per-node timelines). Both
consume the same duration matrix, so given a seed the output is
bit-identical run to run (the CI determinism gate).

Zero-variance parity: deterministic distributions never touch an RNG and
multiply by exactly 1.0, so the duration of every node is exactly its
calibrated base cost and the sweep reduces to the analytic schedule
algebra (``tests/test_sim.py`` pins both claims).
"""
from __future__ import annotations

import dataclasses
import heapq
from math import prod
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.sim.calibrate import SimCosts
from repro_torch.sim.dag import AGG, HOP, STEP, RoundDag, build_round_dag
from repro_torch.sim.distributions import NetworkModel, NetworkSpec

__all__ = [
    "JitterTables",
    "draw_jitter_tables",
    "assemble_durations",
    "sweep",
    "replay_once",
    "ReplayResult",
    "simulate_round",
    "simulate_spec",
]


# ---------------------------------------------------------------------------
# Stage 1: canonical jitter tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class JitterTables:
    """Per-trial multiplicative jitter, canonically keyed.

    compute   (T, R, k1, N) at step granularity, (T, R, N) at interval
              granularity (one factor shared by the interval's k1 steps —
              the ``StragglerModel.interval_latency`` shape)
    link      (T, R, N)   per client uplink
    backhaul  level -> (T, R, n_nodes(level-1)) for levels >= 2
    """

    trials: int
    granularity: str
    compute: np.ndarray
    link: np.ndarray
    backhaul: Dict[int, np.ndarray]


def _draw(dist, trials: int, num_intervals: int, inner: Tuple[int, ...]) -> np.ndarray:
    """Draw (trials, R, *inner) preserving stream order: trial-major,
    interval-inner — one ``sample`` call per (trial, interval), which for
    the straggler calibration is exactly one ``normal(0, sigma, N)`` per
    interval (the ``interval_latency`` stream)."""
    count = int(prod(inner))
    if dist.is_deterministic:
        return np.full((trials, num_intervals) + inner, dist.sample(1)[0], np.float64)
    out = np.empty((trials, num_intervals) + inner, np.float64)
    for t in range(trials):
        for r in range(num_intervals):
            out[t, r] = dist.sample(count).reshape(inner)
    return out


def draw_jitter_tables(net: NetworkModel, tree, kappas, trials: int) -> JitterTables:
    """Consume the net's jitter streams into canonical tables (advances the
    checkpointable RNG state; deterministic from a fresh ``spec.build``)."""
    kv = tuple(int(k) for k in kappas)
    num_intervals = prod(kv[1:]) if len(kv) > 1 else 1
    n = tree.num_clients
    gran = net.jitter_granularity
    inner = (kv[0], n) if gran == "step" else (n,)
    compute = _draw(net.compute_jitter, trials, num_intervals, inner)
    link = _draw(net.link_jitter, trials, num_intervals, (n,))
    backhaul: Dict[int, np.ndarray] = {}
    for ell in range(2, tree.depth + 1):
        backhaul[ell] = _draw(
            net.backhaul_jitter, trials, num_intervals, (tree.num_nodes(ell - 1),)
        )
    return JitterTables(
        trials=trials, granularity=gran, compute=compute, link=link, backhaul=backhaul
    )


# ---------------------------------------------------------------------------
# Stage 2: pure duration assembly
# ---------------------------------------------------------------------------


def assemble_durations(
    dag: RoundDag,
    costs: SimCosts,
    net: Optional[NetworkModel] = None,
    tables: Optional[JitterTables] = None,
    *,
    client_ids: Optional[np.ndarray] = None,
    capacity: Optional[np.ndarray] = None,
) -> np.ndarray:
    """(trials, nodes) float64 durations. Pure — re-assembling against the
    same tables gives identical rows (the common-random-numbers contract).

    client_ids  canonical id of each of the dag spec's client slots
                (identity unless the tree was re-sorted by the association
                optimizer); nets and tables are keyed by canonical ids
    capacity    per-edge nominal uplink capacity for the contention term
                ``n_e / cap_e`` (default: the current per-edge load, i.e.
                a factor of exactly 1 — the parity-safe reading)
    """
    if costs.depth != dag.spec.depth:
        raise ValueError(
            f"SimCosts has {costs.depth} levels, tree has depth {dag.spec.depth}"
        )
    trials = tables.trials if tables is not None else 1
    n = dag.num_nodes
    dur = np.zeros((trials, n), np.float64)
    if client_ids is None:
        canon = dag.client.astype(np.int64)  # already canonical
    else:
        client_ids = np.asarray(client_ids, np.int64)
        canon = np.where(dag.client >= 0, client_ids[np.maximum(dag.client, 0)], -1)

    steps = np.where(dag.kind == STEP)[0]
    if steps.size:
        c = canon[steps]
        r = dag.interval[steps].astype(np.int64)
        base = costs.t_step * (net.client_speed[c] if net is not None else 1.0)
        if tables is not None:
            if tables.granularity == "step":
                s = dag.step[steps].astype(np.int64)
                base = base * tables.compute[:, r, s, c]
            else:
                base = base * tables.compute[:, r, c]
        dur[:, steps] = base

    seg1 = dag.spec.segments(1)
    up = np.where((dag.kind == HOP) & (dag.level == 1))[0]
    if up.size:
        c = canon[up]
        slot = dag.entity[up].astype(np.int64)
        e = seg1[dag.cohort[slot]]  # edge under the *current* assignment
        base = np.full(up.size, costs.link_t[0], np.float64)
        if net is not None:
            base = base * net.client_link[c] * net.edge_uplink[e]
            if net.contention:
                load = np.bincount(seg1[dag.cohort], minlength=dag.spec.num_nodes(1))
                cap = (
                    load.astype(np.float64)
                    if capacity is None
                    else np.asarray(capacity, np.float64)
                )
                if np.any(cap <= 0):
                    raise ValueError("edge capacities must be positive")
                base = base * (load[e] / cap[e])
        if tables is not None:
            r = dag.interval[up].astype(np.int64)
            base = base * tables.link[:, r, c]
        dur[:, up] = base

    for ell in range(2, dag.spec.depth + 1):
        hops = np.where((dag.kind == HOP) & (dag.level == ell))[0]
        if not hops.size:
            continue
        src = dag.entity[hops].astype(np.int64)  # global tier-(ell-1) id
        base = np.full(hops.size, costs.link_t[ell - 1], np.float64)
        if net is not None and ell == 2:
            base = base * net.edge_backhaul[src]
        if tables is not None:
            r = dag.interval[hops].astype(np.int64)
            base = base * tables.backhaul[ell][:, r, src]
        dur[:, hops] = base

    for ell in range(1, dag.spec.depth + 1):
        aggs = np.where((dag.kind == AGG) & (dag.level == ell))[0]
        if aggs.size:
            dur[:, aggs] = costs.agg_t[ell - 1]
    return dur


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------


def sweep(dag: RoundDag, durations: np.ndarray) -> np.ndarray:
    """Vectorized forward pass over the topological order: all trials at
    once; ``finish[:, i] = max(finish[:, preds_i]) + dur[:, i]``."""
    trials, n = durations.shape
    fin = np.zeros((trials, n), np.float64)
    for i, ps in enumerate(dag.preds):
        start = fin[:, ps].max(axis=1) if ps.size else np.zeros(trials)
        fin[:, i] = start + durations[:, i]
    return fin


def replay_once(dag: RoundDag, durations_row: np.ndarray) -> np.ndarray:
    """Heap-based discrete-event replay of one trial — the reference
    implementation ``sweep`` must match bit-for-bit (tested). Returns the
    (nodes,) finish times."""
    n = dag.num_nodes
    succs: List[List[int]] = [[] for _ in range(n)]
    indeg = np.zeros(n, np.int64)
    for i, ps in enumerate(dag.preds):
        indeg[i] = ps.size
        for p in ps:
            succs[int(p)].append(i)
    ready = np.zeros(n, np.float64)  # max finish over resolved preds
    fin = np.zeros(n, np.float64)
    heap = [(float(durations_row[i]), i) for i in range(n) if indeg[i] == 0]
    heapq.heapify(heap)
    done = 0
    while heap:
        t, i = heapq.heappop(heap)
        fin[i] = t
        done += 1
        for j in succs[i]:
            ready[j] = max(ready[j], t)
            indeg[j] -= 1
            if indeg[j] == 0:
                heapq.heappush(heap, (float(ready[j] + durations_row[j]), j))
    if done != n:
        raise RuntimeError("cycle in round DAG")  # pragma: no cover
    return fin


def _node_energy(dag: RoundDag, costs: SimCosts, durations: np.ndarray) -> np.ndarray:
    """(trials, nodes) device energy: constant-power scaling, so a node
    that runs ``dur/base`` times longer burns that much more energy — and
    at factor exactly 1 each node costs exactly its calibrated joules
    (the energy half of the parity contract). Only client compute and the
    level-1 radio upload draw device energy (the Table II reading)."""
    e = np.zeros_like(durations)
    steps = np.where(dag.kind == STEP)[0]
    if steps.size and costs.e_step > 0.0:
        if costs.t_step > 0.0:
            e[:, steps] = costs.e_step * (durations[:, steps] / costs.t_step)
        else:
            e[:, steps] = costs.e_step
    up = np.where((dag.kind == HOP) & (dag.level == 1))[0]
    if up.size and costs.e_uplink > 0.0:
        if costs.link_t[0] > 0.0:
            e[:, up] = costs.e_uplink * (durations[:, up] / costs.link_t[0])
        else:
            e[:, up] = costs.e_uplink
    return e


@dataclasses.dataclass
class ReplayResult:
    """One cloud interval replayed over ``trials`` random worlds."""

    dag: RoundDag
    durations: np.ndarray  # (T, n)
    finish: np.ndarray  # (T, n)
    energy: np.ndarray  # (T, n)

    @property
    def trials(self) -> int:
        return self.durations.shape[0]

    @property
    def round_time(self) -> np.ndarray:
        """(T,) cloud-interval wall-clock — the sink's finish time."""
        return self.finish[:, self.dag.sink]

    @property
    def client_energy(self) -> np.ndarray:
        """(T, C) device energy per cohort slot."""
        t, c = self.trials, int(self.dag.cohort.size)
        acc = np.zeros((c, t), np.float64)
        owned = np.where(
            (self.dag.kind == STEP) | ((self.dag.kind == HOP) & (self.dag.level == 1))
        )[0]
        if owned.size:
            np.add.at(acc, self.dag.entity[owned].astype(np.int64), self.energy[:, owned].T)
        return acc.T

    def percentiles(self, qs=(50.0, 90.0, 99.0)) -> Dict[str, float]:
        rt = self.round_time
        out = {f"p{q:g}_s": float(np.percentile(rt, q)) for q in qs}
        out["mean_s"] = float(rt.mean())
        out["max_s"] = float(rt.max())
        return out

    def summary(self) -> Dict[str, object]:
        ce = self.client_energy
        per_client = ce.sum(axis=0) / max(self.trials, 1)  # mean over trials
        return {
            "trials": self.trials,
            "nodes": self.dag.counts(),
            "round_time": self.percentiles(),
            "energy_per_client_j": {
                "mean": float(per_client.mean()),
                "max": float(per_client.max()),
                "p99_pooled": float(np.percentile(ce, 99.0)) if ce.size else 0.0,
            },
        }

    def cdf(self, points: int = 32) -> Dict[str, list]:
        """The round-time CDF at evenly spaced quantiles — plot-ready."""
        qs = np.linspace(0.0, 100.0, points)
        return {
            "quantile": [float(q) / 100.0 for q in qs],
            "round_time_s": [float(v) for v in np.percentile(self.round_time, qs)],
        }

    def timeline(self, trial: int = 0) -> List[Dict[str, object]]:
        """Per-node (start, finish) for one trial — gantt-style debugging."""
        kinds = {STEP: "step", HOP: "hop", AGG: "agg"}
        fin = self.finish[trial]
        dur = self.durations[trial]
        return [
            {
                "node": i,
                "kind": kinds[int(self.dag.kind[i])],
                "level": int(self.dag.level[i]),
                "entity": int(self.dag.entity[i]),
                "client": int(self.dag.client[i]),
                "interval": int(self.dag.interval[i]),
                "start": float(fin[i] - dur[i]),
                "finish": float(fin[i]),
            }
            for i in range(self.dag.num_nodes)
        ]


def simulate_round(
    dag: RoundDag,
    costs: SimCosts,
    net: Optional[NetworkModel] = None,
    *,
    trials: int = 1,
    tables: Optional[JitterTables] = None,
    client_ids: Optional[np.ndarray] = None,
    capacity: Optional[np.ndarray] = None,
) -> ReplayResult:
    """Replay one cloud interval ``trials`` times. Draws fresh jitter
    tables from ``net`` unless given pre-drawn ``tables`` (the
    common-random-numbers path used by the association optimizer)."""
    if tables is None and net is not None:
        tables = draw_jitter_tables(net, dag.spec, dag.kappas, trials)
    dur = assemble_durations(
        dag, costs, net, tables, client_ids=client_ids, capacity=capacity
    )
    fin = sweep(dag, dur)
    return ReplayResult(dag=dag, durations=dur, finish=fin, energy=_node_energy(dag, costs, dur))


def simulate_spec(spec, *, trials: int = 1) -> ReplayResult:
    """Convenience: replay an ``ExperimentSpec`` — tree and κ from its
    topology/schedule, transport bits from its transport section, the cost
    workload from its cost section, network distributions from its
    ``network`` section, and the interval-0 cohort from participation."""
    from repro_torch.core.hierarchy import as_hierarchy
    from repro_torch.sim import calibrate

    tree = as_hierarchy(spec.topology.build())
    kappas = tuple(spec.schedule.kappas)
    costs = spec.cost.build()
    if costs is None:
        raise ValueError("cost.workload='none' — nothing to calibrate the replay from")
    transport = spec.transport.build(tree.depth)  # None when trivial (fp32)
    bits = transport.bits_vector() if transport is not None else None
    sim_costs = calibrate.from_workload(costs, tree.depth, bits_per_param=bits)
    net = spec.network.build(tree) if spec.network.is_active else None
    cohort = None
    if spec.participation.is_active:
        cohort = np.asarray(spec.participation.build_sampler(tree).sample(), np.int64)
    dag = build_round_dag(tree, kappas, cohort=cohort)
    return simulate_round(dag, sim_costs, net, trials=trials)
