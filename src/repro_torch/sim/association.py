"""HFEL-style client→edge association on top of the replay simulator.

Copy-port of ``repro.sim.association`` (host numpy), held to it bit for bit by
``tests/test_torch_sim.py``.

Once per-client and per-edge cost distributions exist (``NetworkSpec``),
which edge a client reports to stops being an accident of the tree and
becomes an optimizable resource-allocation knob — the core observation of
HFEL (arXiv 2002.11343): move clients off slow/congested edges, trade
uplink contention against link quality, and the tail round time drops.

This module searches assignments with the replay itself as the objective
(no surrogate model): greedy initialization by expected chain cost, then
local search over the bottleneck clients. Every candidate is evaluated
under **common random numbers** — one set of canonically-keyed jitter
tables drawn up front (``draw_jitter_tables``), every assignment
re-assembled against it — so the optimizer compares assignments, not
noise, and the reported before/after numbers are paired.

Constraints, per HFEL: a per-edge capacity ``cap_e`` (default: the
incumbent group sizes, so the incumbent is always feasible) and every
edge keeps at least one client (``HierarchySpec`` requires dense parent
ids — an emptied edge would change the tree shape under the schedule).

The result plugs straight back into the hierarchy: ``HierarchySpec``
requires non-decreasing parent ids, so a new assignment implies a client
*permutation* (``client_order``: canonical id per new slot). Data/state
stores keyed by client id must be re-indexed through it — the sim keys
its nets and tables canonically for exactly this reason.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.hierarchy import HierarchySpec, as_hierarchy
from repro_torch.sim.calibrate import SimCosts
from repro_torch.sim.dag import build_round_dag
from repro_torch.sim.distributions import NetworkModel
from repro_torch.sim.replay import JitterTables, assemble_durations, draw_jitter_tables, sweep

__all__ = ["AssociationResult", "assignment_to_spec", "optimize_association"]


def assignment_to_spec(
    assignment: np.ndarray, base: HierarchySpec
) -> Tuple[HierarchySpec, np.ndarray]:
    """(assignment[c] = edge id per canonical client) -> a valid sorted
    ``HierarchySpec`` plus ``client_order`` (canonical id per new slot).

    Stable sort by edge keeps within-edge canonical order, so the default
    assignment round-trips to the identity permutation."""
    assignment = np.asarray(assignment, np.int64)
    n_edges = base.num_nodes(1)
    if assignment.shape != (base.num_clients,):
        raise ValueError(f"assignment must be ({base.num_clients},), got {assignment.shape}")
    if assignment.min() < 0 or assignment.max() >= n_edges:
        raise ValueError(f"edge ids must be in 0..{n_edges - 1}")
    if np.unique(assignment).size != n_edges:
        raise ValueError("every edge must keep at least one client")
    order = np.argsort(assignment, kind="stable")
    parents0 = tuple(int(e) for e in assignment[order])
    spec = HierarchySpec(parents=(parents0,) + base.parents[1:])
    return spec, order


@dataclasses.dataclass
class AssociationResult:
    assignment: np.ndarray  # (N,) edge id per canonical client
    spec: HierarchySpec  # the re-sorted tree to run with
    client_order: np.ndarray  # (N,) canonical client id per new slot
    objective: str
    value_before: float
    value_after: float
    moves: List[Tuple[int, int, int]]  # (client, from_edge, to_edge)
    evals: int

    @property
    def improvement(self) -> float:
        """Relative reduction of the objective (0.12 = 12% better)."""
        if self.value_before <= 0:
            return 0.0
        return 1.0 - self.value_after / self.value_before

    def to_dict(self) -> Dict[str, object]:
        return {
            "objective": self.objective,
            "value_before": self.value_before,
            "value_after": self.value_after,
            "improvement": self.improvement,
            "moves": [list(m) for m in self.moves],
            "num_moves": len(self.moves),
            "evals": self.evals,
        }


class _Evaluator:
    """Scores an assignment by replaying it against fixed jitter tables."""

    def __init__(self, base, costs, net, tables, kappas, objective, capacity):
        self.base = base
        self.costs = costs
        self.net = net
        self.tables = tables
        self.kappas = kappas
        self.objective = objective
        self.capacity = capacity
        self.evals = 0
        self._cache: Dict[bytes, float] = {}

    def __call__(self, assignment: np.ndarray) -> float:
        key = assignment.tobytes()
        if key in self._cache:
            return self._cache[key]
        spec, order = assignment_to_spec(assignment, self.base)
        dag = build_round_dag(spec, self.kappas)
        dur = assemble_durations(
            dag, self.costs, self.net, self.tables,
            client_ids=order, capacity=self.capacity,
        )
        fin = sweep(dag, dur)
        if self.objective == "p99_time":
            val = float(np.percentile(fin[:, dag.sink], 99.0))
        else:  # energy: mean per-client device energy
            from repro_torch.sim.replay import ReplayResult, _node_energy

            res = ReplayResult(dag, dur, fin, _node_energy(dag, self.costs, dur))
            val = float(res.client_energy.mean())
        self.evals += 1
        self._cache[key] = val
        return val


def _chain_cost(costs: SimCosts, net: NetworkModel, kappa1: int) -> np.ndarray:
    """Expected per-interval cost of each client's serial chain (compute +
    uplink, persistent factors and jitter means) — the greedy sort key."""
    comp = kappa1 * costs.t_step * net.client_speed * net.compute_jitter.mean()
    up = costs.link_t[0] * net.client_link * net.link_jitter.mean()
    return comp + up


def optimize_association(
    tree,
    costs: SimCosts,
    net: NetworkModel,
    kappas,
    *,
    objective: str = "p99_time",
    trials: int = 32,
    capacity: Optional[np.ndarray] = None,
    top_k: int = 6,
    max_rounds: int = 8,
    greedy_init: bool = True,
) -> AssociationResult:
    """Greedy + local-search client→edge association (depth-2 trees).

    objective   "p99_time" (p99 cloud-interval wall clock) or "energy"
                (mean per-client device energy)
    capacity    per-edge client capacity (default: incumbent group sizes)
    top_k       bottleneck clients probed per local-search round
    max_rounds  local-search rounds (each accepts the best improving move)
    greedy_init start from a cost-aware greedy assignment instead of the
                incumbent (the incumbent is always evaluated as baseline)
    """
    base = as_hierarchy(tree)
    if base.depth != 2:
        raise ValueError(
            f"association optimization is defined for depth-2 trees, got depth {base.depth}"
        )
    if objective not in ("p99_time", "energy"):
        raise ValueError(f"objective must be p99_time|energy, got {objective!r}")
    n = base.num_clients
    n_edges = base.num_nodes(1)
    incumbent = np.asarray(base.segments(1), np.int64).copy()
    group_sizes = np.bincount(incumbent, minlength=n_edges)
    cap = group_sizes.copy() if capacity is None else np.asarray(capacity, np.int64)
    if cap.shape != (n_edges,) or np.any(cap < 1):
        raise ValueError(f"capacity must be ({n_edges},) positive ints")
    if cap.sum() < n:
        raise ValueError(f"total capacity {int(cap.sum())} < {n} clients")

    tables = draw_jitter_tables(net, base, kappas, trials)
    evaluate = _Evaluator(base, costs, net, tables, tuple(kappas), objective, cap)
    value_before = evaluate(incumbent)

    # -- greedy: place expensive clients first, each on the edge that
    # currently adds the least estimated bottleneck cost ------------------
    chain = _chain_cost(costs, net, int(kappas[0]))
    backhaul = costs.link_t[-1] * net.edge_backhaul * net.backhaul_jitter.mean()
    best_assign = incumbent
    best_value = value_before
    if greedy_init:
        greedy = np.full(n, -1, np.int64)
        load = np.zeros(n_edges, np.int64)
        edge_peak = np.zeros(n_edges, np.float64)  # slowest chain on the edge so far
        up_base = costs.link_t[0] * net.client_link * net.link_jitter.mean()
        for c in np.argsort(-chain, kind="stable"):
            # once the still-empty edges need every remaining client,
            # restrict to them (every edge must end with >= 1 client)
            empty = np.where(load == 0)[0]
            remaining = n - int(load.sum())
            feasible = empty if empty.size == remaining else np.where(load < cap)[0]
            up_e = up_base[c] * net.edge_uplink[feasible]
            if net.contention:
                up_e = up_e * (load[feasible] + 1.0) / cap[feasible]
            comp_c = chain[c] - up_base[c]
            cand = np.maximum(edge_peak[feasible], comp_c + up_e) + backhaul[feasible]
            j = int(np.argmin(cand))
            e = int(feasible[j])
            greedy[c] = e
            load[e] += 1
            edge_peak[e] = max(edge_peak[e], comp_c + float(up_e[j]))
        gv = evaluate(greedy)
        if gv < best_value:
            best_assign, best_value = greedy, gv

    # -- local search: move/swap the most expensive clients ----------------
    assign = best_assign.copy()
    value = best_value
    moves: List[Tuple[int, int, int]] = []
    for _ in range(max_rounds):
        load = np.bincount(assign, minlength=n_edges)
        # bottleneck pressure: chain cost scaled by the edge's factors
        pressure = chain * net.edge_uplink[assign]
        if net.contention:
            pressure = pressure * load[assign] / cap[assign]
        candidates = np.argsort(-pressure, kind="stable")[: int(top_k)]
        best_move = None
        for c in candidates:
            src = int(assign[c])
            for dst in range(n_edges):
                if dst == src:
                    continue
                if load[dst] < cap[dst] and load[src] > 1:
                    trial_assign = assign.copy()
                    trial_assign[c] = dst
                    v = evaluate(trial_assign)
                    if best_move is None or v < best_move[0]:
                        best_move = (v, trial_assign, [(int(c), src, dst)])
                # swap with the cheapest client on dst (capacity-neutral)
                on_dst = np.where(assign == dst)[0]
                if on_dst.size:
                    partner = int(on_dst[int(np.argmin(pressure[on_dst]))])
                    trial_assign = assign.copy()
                    trial_assign[c], trial_assign[partner] = dst, src
                    v = evaluate(trial_assign)
                    if best_move is None or v < best_move[0]:
                        best_move = (
                            v, trial_assign,
                            [(int(c), src, dst), (partner, dst, src)],
                        )
        if best_move is None or best_move[0] >= value:
            break
        value, assign = best_move[0], best_move[1]
        moves.extend(best_move[2])

    if value > value_before:  # never return worse than the incumbent
        assign, value, moves = incumbent, value_before, []
    spec, order = assignment_to_spec(assign, base)
    return AssociationResult(
        assignment=assign,
        spec=spec,
        client_order=order,
        objective=objective,
        value_before=value_before,
        value_after=value,
        moves=moves,
        evals=evaluate.evals,
    )
