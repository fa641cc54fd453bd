"""The per-cloud-interval dependency DAG of the client-edge-cloud system.

Copy-port of ``repro.sim.dag`` (host numpy), held to it bit for bit by
``tests/test_torch_sim.py``.

One cloud interval of the κ-schedule is a DAG of three node kinds:

    STEP   one local SGD step of one client           (κ₁ per level-1 interval)
    HOP    one upload across one tree link: level 1 = client→edge uplink,
           level depth = the edge(…)→cloud backhaul
    AGG    one aggregation at a tier-ℓ node

For a depth-L tree with κ = (κ₁, …, κ_L) there are R = κ₂·…·κ_L level-1
intervals per cloud interval. Interval r ends at *boundary level*
b(r) — the highest ℓ with (r+1) divisible by κ₂·…·κ_ℓ — and the boundary
runs hops+aggs bottom-up through level b(r). A client's next steps are
gated by the *highest* aggregate that fired at the previous boundary
(restricted to its ancestor there): the broadcast back down is free, the
same reading as the analytic model.

Generalities honored here (the analytic model prices none of them):

* **ragged trees** — any ``HierarchySpec``; aggregates wait for exactly
  their own children.
* **sampled cohorts** — pass ``cohort`` (sorted original client ids, e.g.
  from a ``fed.participation`` sampler): only cohort members get chains,
  and only their ancestor nodes aggregate that interval.
* **straggler masks** — ``masks[r, i] == 0`` excludes cohort member i
  from interval r's aggregation (deadline-based partial aggregation, the
  ``fed.failures.StragglerModel`` contract): it keeps computing (its STEP
  nodes exist and burn energy), its upload is skipped, no aggregate waits
  for it, and its chain continues from its own last step (it keeps its
  local model and rejoins at a later boundary).
* **failure masks** — ``alive[r, i] == 0`` is a dead client
  (``FailureSimulator`` / ``SubtreeOutageSimulator``): no nodes at all
  that interval — no compute time, no energy, nothing gated.

Nodes are emitted in topological order (every predecessor has a smaller
id), so replay is a single forward sweep and the last node is always the
cloud aggregate (the sink).
"""
from __future__ import annotations

import dataclasses
from math import prod
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.hierarchy import HierarchySpec, as_hierarchy

__all__ = ["STEP", "HOP", "AGG", "RoundDag", "build_round_dag"]

STEP, HOP, AGG = 0, 1, 2


@dataclasses.dataclass
class RoundDag:
    """One cloud interval as a flat, topologically ordered node list.

    kind      (n,) int8   STEP | HOP | AGG
    level     (n,) int8   tree level (STEP: 0; HOP/AGG: 1..depth)
    entity    (n,) int32  STEP / level-1 HOP: cohort slot index;
                          level-ℓ HOP (ℓ>=2): the *global* tier-(ℓ-1)
                          source node id; AGG: the global tier-ℓ node id
    client    (n,) int32  original client id (STEP / level-1 HOP), else -1
    interval  (n,) int16  level-1 interval index r
    step      (n,) int16  step index within the interval (STEP only, else -1)
    preds     tuple of int32 arrays, preds[i] < i (topological order)
    """

    spec: HierarchySpec
    kappas: Tuple[int, ...]
    cohort: np.ndarray  # (C,) original client ids, sorted
    kind: np.ndarray
    level: np.ndarray
    entity: np.ndarray
    client: np.ndarray
    interval: np.ndarray
    step: np.ndarray
    preds: Tuple[np.ndarray, ...]

    @property
    def num_nodes(self) -> int:
        return int(self.kind.size)

    @property
    def num_intervals(self) -> int:
        return prod(self.kappas[1:]) if len(self.kappas) > 1 else 1

    @property
    def sink(self) -> int:
        """The cloud aggregate — always the last node emitted."""
        return self.num_nodes - 1

    def counts(self) -> dict:
        return {
            "nodes": self.num_nodes,
            "steps": int(np.sum(self.kind == STEP)),
            "hops": int(np.sum(self.kind == HOP)),
            "aggs": int(np.sum(self.kind == AGG)),
        }


def _boundary_level(r: int, kappas: Tuple[int, ...]) -> int:
    """Highest level ℓ whose aggregation fires at the end of interval r."""
    level = 1
    period = 1
    for ell in range(2, len(kappas) + 1):
        period *= kappas[ell - 1]
        if (r + 1) % period == 0:
            level = ell
    return level


def _check_mask(name: str, m, num_intervals: int, c_count: int) -> np.ndarray:
    m = np.asarray(m)
    if m.shape != (num_intervals, c_count):
        raise ValueError(
            f"{name} must be ({num_intervals}, {c_count}) "
            f"(level-1 intervals x cohort), got {m.shape}"
        )
    return m > 0


def build_round_dag(
    tree,
    kappas,
    *,
    cohort: Optional[np.ndarray] = None,
    masks: Optional[np.ndarray] = None,
    alive: Optional[np.ndarray] = None,
) -> RoundDag:
    """Construct one cloud interval's DAG.

    tree    a ``HierarchySpec`` (or FedTopology)
    kappas  the κ-vector, one entry per tree level
    cohort  sorted original client ids participating this cloud interval
            (default: the full population)
    masks   (R, C) straggler mask: 0 = computes but misses the deadline
            (excluded from that interval's aggregation)
    alive   (R, C) failure mask: 0 = dead (no compute, no energy)
    """
    spec = as_hierarchy(tree)
    kv = tuple(int(k) for k in kappas)
    if len(kv) != spec.depth:
        raise ValueError(f"kappas {kv} has {len(kv)} levels but the tree has depth {spec.depth}")
    if any(k < 1 for k in kv):
        raise ValueError(f"kappas must be >= 1, got {kv}")

    if cohort is None:
        cohort = np.arange(spec.num_clients, dtype=np.int64)
    else:
        cohort = np.asarray(cohort, np.int64)
        if cohort.size == 0:
            raise ValueError("cohort must be non-empty")
        if np.any(np.diff(cohort) <= 0):
            raise ValueError("cohort ids must be sorted and unique")
        if cohort[0] < 0 or cohort[-1] >= spec.num_clients:
            raise ValueError(
                f"cohort ids must be in 0..{spec.num_clients - 1}, got "
                f"[{cohort[0]}, {cohort[-1]}]"
            )
    c_count = int(cohort.size)
    num_intervals = prod(kv[1:]) if len(kv) > 1 else 1

    masks = (
        np.ones((num_intervals, c_count), bool)
        if masks is None
        else _check_mask("masks", masks, num_intervals, c_count)
    )
    alive = (
        np.ones((num_intervals, c_count), bool)
        if alive is None
        else _check_mask("alive", alive, num_intervals, c_count)
    )
    part = masks & alive  # participates in the interval's aggregation

    # per level: each cohort slot's global ancestor id, and the active
    # (ancestor-of-some-slot) node set with a dense local index
    seg: List[Optional[np.ndarray]] = [None]  # 1-indexed by level
    active: List[Optional[np.ndarray]] = [None]
    local_of: List[Optional[dict]] = [None]
    for ell in range(1, spec.depth + 1):
        s = spec.segments(ell)[cohort]
        seg.append(s)
        act = np.unique(s)
        active.append(act)
        local_of.append({int(g): i for i, g in enumerate(act)})
    # parent map per tier (global ids): tier ℓ-1 node -> tier ℓ node
    parents = [np.asarray(p, np.int64) for p in spec.parents]

    kind: List[int] = []
    level: List[int] = []
    entity: List[int] = []
    client: List[int] = []
    interval: List[int] = []
    stepix: List[int] = []
    preds: List[np.ndarray] = []

    def emit(k, lv, ent, cl, r, s, ps) -> int:
        kind.append(k)
        level.append(lv)
        entity.append(ent)
        client.append(cl)
        interval.append(r)
        stepix.append(s)
        preds.append(np.asarray(ps, np.int32))
        return len(kind) - 1

    # chain[i]: the node slot i's next step must wait on — its own last
    # step (masked/dead), or the broadcast aggregate (participated)
    chain = np.full(c_count, -1, np.int64)
    # prev_agg[ell][local]: the previous aggregate at that node (serial
    # boundary processing on one server keeps its timeline monotone and
    # gives empty aggregations a well-defined time)
    prev_agg: List[Optional[np.ndarray]] = [None] + [
        np.full(active[ell].size, -1, np.int64) for ell in range(1, spec.depth + 1)
    ]

    kappa1 = kv[0]
    for r in range(num_intervals):
        # -- local steps: a serial chain per alive slot --------------------
        last_step = np.full(c_count, -1, np.int64)
        for i in range(c_count):
            if not alive[r, i]:
                continue
            for s in range(kappa1):
                ps = [chain[i]] if chain[i] >= 0 else []
                chain[i] = emit(STEP, 0, i, int(cohort[i]), r, s, ps)
            last_step[i] = chain[i]

        b = _boundary_level(r, kv)
        # -- level-1 boundary: uplinks + edge aggregates -------------------
        up = np.full(c_count, -1, np.int64)
        for i in range(c_count):
            if part[r, i]:
                up[i] = emit(HOP, 1, i, int(cohort[i]), r, -1, [last_step[i]])
        agg_at: List[Optional[np.ndarray]] = [None] * (spec.depth + 1)
        agg_at[1] = np.full(active[1].size, -1, np.int64)
        for li, g in enumerate(active[1]):
            members = np.where((seg[1] == g) & part[r])[0]
            ps = [int(up[i]) for i in members]
            if prev_agg[1][li] >= 0:
                ps.append(int(prev_agg[1][li]))
            agg_at[1][li] = emit(AGG, 1, int(g), -1, r, -1, ps)
        prev_agg[1] = agg_at[1]

        # -- higher boundaries: hop up one level, aggregate, repeat --------
        for ell in range(2, b + 1):
            agg_at[ell] = np.full(active[ell].size, -1, np.int64)
            # hops: one per active tier-(ℓ-1) node, to its tier-ℓ parent
            hop_of = {}
            for li, g in enumerate(active[ell - 1]):
                hop_of[int(g)] = emit(
                    HOP, ell, int(g), -1, r, -1, [int(agg_at[ell - 1][li])]
                )
            for li, g in enumerate(active[ell]):
                children = [
                    int(c) for c in active[ell - 1] if int(parents[ell - 1][c]) == int(g)
                ]
                ps = [hop_of[c] for c in children]
                if prev_agg[ell][li] >= 0:
                    ps.append(int(prev_agg[ell][li]))
                agg_at[ell][li] = emit(AGG, ell, int(g), -1, r, -1, ps)
            prev_agg[ell] = agg_at[ell]

        # -- gates: a participating slot's next step waits on the highest
        # aggregate that fired (its level-b ancestor already transitively
        # waits on the slot's own upload); masked/dead slots keep training
        # from their own local chain --------------------------------------
        for i in range(c_count):
            if part[r, i]:
                chain[i] = int(agg_at[b][local_of[b][int(seg[b][i])]])

    return RoundDag(
        spec=spec,
        kappas=kv,
        cohort=cohort,
        kind=np.asarray(kind, np.int8),
        level=np.asarray(level, np.int8),
        entity=np.asarray(entity, np.int32),
        client=np.asarray(client, np.int32),
        interval=np.asarray(interval, np.int16),
        step=np.asarray(stepix, np.int16),
        preds=tuple(preds),
    )
