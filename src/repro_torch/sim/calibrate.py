"""Seed the replay's node costs from the repo's analytic models.

Copy-port of ``repro.sim.calibrate`` (host numpy), held to it bit for bit by
``tests/test_torch_sim.py``.

The parity contract (the reason this module exists): under a zero-variance
``NetworkSpec`` the replay must reduce to the analytic schedule algebra,

    from_workload(costs)  ->  replay == cloud_interval_time / _energy
    from_cluster(costs)   ->  replay == ClusterCosts.interval_time

to float64 machine precision (the only difference left is summation
order: the DAG accumulates ``t_comp`` κ₁κ₂ times where the closed form
multiplies once — a few hundred rounding steps, bounded well below 1e-12
relative; ``tests/test_sim.py`` pins it). To keep that exact, the level-L
(backhaul) base cost is computed with the *same expression* the analytic
model uses, ``(cloud_latency_mult - 1.0) * t_comm_edge`` — the paper
reads the cloud hop as overlapping one edge-period of it.

Calibration sources:

* ``from_workload`` — ``WorkloadCosts`` / ``paper_workload`` (Table I),
  with per-level transport bit-widths applied through
  ``WorkloadCosts.with_bits`` (depth 2) or raw ``bits/32`` wire scaling
  (deeper trees, where no closed form exists).
* ``from_cluster`` — ``ClusterCosts`` (collective times from a roofline
  model): collective times sit on the AGG nodes,
  links are free (the all-reduce *is* the transfer).
* ``from_roofline`` — convenience: roofline terms -> ``ClusterCosts``
  (duck-typed: any objects with ``bound_s`` / ``collective_s``, such as
  the port's ``analysis.roofline.RooflineTerms``) -> ``from_cluster``.
* ``straggler_network`` — satellite: prices the DES's client compute from
  ``fed.failures.StragglerModel``'s *own* distribution (same slowness
  array, same RNG stream), so the deadline-mask path and the replay can
  never drift apart.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cost_model import ClusterCosts, WorkloadCosts
from repro_torch.sim.distributions import LogNormalDist, NetworkModel, NetworkSpec

__all__ = [
    "SimCosts",
    "from_workload",
    "from_cluster",
    "from_roofline",
    "straggler_network",
    "straggler_masks",
]


@dataclasses.dataclass(frozen=True)
class SimCosts:
    """Base (pre-distribution) cost of each DAG node kind.

    t_step    one local step (s);  e_step  its device energy (J)
    link_t    per-level hop time, ``link_t[ell-1]`` for a level-ell HOP
              (level 1 = client uplink, level depth = backhaul)
    agg_t     per-level aggregation time (0 for the wireless model —
              server-side math is free next to the radio; the collective
              times for the cluster model)
    e_uplink  client radio energy per level-1 upload (J); higher hops are
              backhaul and cost no device energy (the Table II reading)
    """

    t_step: float
    e_step: float
    link_t: Tuple[float, ...]
    agg_t: Tuple[float, ...]
    e_uplink: float = 0.0

    def __post_init__(self):
        if len(self.link_t) != len(self.agg_t):
            raise ValueError("link_t and agg_t must have one entry per tree level")
        if not self.link_t:
            raise ValueError("need at least one tree level")

    @property
    def depth(self) -> int:
        return len(self.link_t)


def _bits_vector(depth: int, bits_per_param) -> Tuple[float, ...]:
    if bits_per_param is None:
        return (32.0,) * depth
    if isinstance(bits_per_param, (int, float)):
        return (float(bits_per_param),) * depth
    bits = tuple(float(b) for b in bits_per_param)
    if len(bits) != depth:
        raise ValueError(f"bits_per_param has {len(bits)} entries for depth {depth}")
    if any(b <= 0 for b in bits):
        raise ValueError(f"bits per parameter must be positive, got {bits}")
    return bits


def from_workload(
    costs: WorkloadCosts, depth: int = 2, *, bits_per_param=None
) -> SimCosts:
    """Calibrate from a Table I workload (``core.cost_model``).

    ``bits_per_param`` — scalar or one entry per level (the
    ``TransportSpec.bits_vector()`` convention: entry ell-1 is the wire
    width of level-ell uploads). Depth 2 routes through
    ``WorkloadCosts.with_bits`` so parity against the compressed analytic
    model is exact; deeper trees scale each hop by ``bits/32``.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    bits = _bits_vector(depth, bits_per_param)
    if depth == 1:
        b = costs.with_bits(bits[0], 32.0)
        link = (b.t_comm_edge,)
        e_up = b.e_comm_edge
    elif depth == 2:
        b = costs.with_bits(bits[0], bits[1])
        # exactly the closed form's terms: kappa2 uplinks at t_comm_edge
        # plus (mult-1) extra edge-periods for the backhaul
        link = (b.t_comm_edge, (b.cloud_latency_mult - 1.0) * b.t_comm_edge)
        e_up = b.e_comm_edge
    else:
        # no closed form above depth 2 — price every hop as a wire
        # transfer at the edge rate, top hop keeping the paper's
        # (mult-1) overlap reading
        scaled = [costs.t_comm_edge * b / 32.0 for b in bits]
        scaled[-1] *= costs.cloud_latency_mult - 1.0
        link = tuple(scaled)
        e_up = costs.e_comm_edge * bits[0] / 32.0
    return SimCosts(
        t_step=costs.t_comp,
        e_step=costs.e_comp,
        link_t=link,
        agg_t=(0.0,) * depth,
        e_uplink=e_up,
    )


def from_cluster(costs: ClusterCosts, depth: int = 2, *, bits_per_param=None) -> SimCosts:
    """Calibrate from cluster collective times (a roofline model):
    the all-reduce *is* the transfer, so aggregation nodes carry the time
    and hops are free. Intermediate levels of deeper trees price at the
    edge (ICI) rate. No device-energy notion on the cluster."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    bits = _bits_vector(depth, bits_per_param)
    if depth <= 2:
        b = costs.with_bits(bits[0], bits[-1])
        agg = (b.t_edge_agg,) if depth == 1 else (b.t_edge_agg, b.t_cloud_agg)
    else:
        agg = tuple(
            (costs.t_cloud_agg if ell == depth else costs.t_edge_agg) * bits[ell - 1] / 32.0
            for ell in range(1, depth + 1)
        )
    return SimCosts(
        t_step=costs.t_step,
        e_step=0.0,
        link_t=(0.0,) * depth,
        agg_t=agg,
        e_uplink=0.0,
    )


def from_roofline(step, edge, cloud, depth: int = 2, *, bits_per_param=None) -> SimCosts:
    """Roofline terms for (local step, edge agg, cloud agg) -> SimCosts:
    ``analysis.roofline.RooflineTerms``, or any objects with ``bound_s``
    (the step) and ``collective_s`` (the aggregations; None for a level
    with none)."""
    cluster = ClusterCosts(
        t_step=step.bound_s,
        t_edge_agg=edge.collective_s if edge is not None else 0.0,
        t_cloud_agg=cloud.collective_s if cloud is not None else 0.0,
    )
    return from_cluster(cluster, depth, bits_per_param=bits_per_param)


# ---------------------------------------------------------------------------
# Straggler calibration (satellite): one distribution for mask + DES paths
# ---------------------------------------------------------------------------


def straggler_network(model, tree) -> NetworkModel:
    """A :class:`NetworkModel` that prices client compute from a
    ``fed.failures.StragglerModel`` — *sharing* its slowness array and its
    RNG stream, not copying parameters.

    With ``jitter_granularity="interval"`` the replay draws exactly one
    ``(C,)`` lognormal per level-1 interval — the same
    ``normal(0, sigma, N)`` call ``StragglerModel.interval_latency``
    makes — so when ``SimCosts.t_step == model.mean_step_s`` and the
    cohort is the full population, per-client interval compute times in
    the replay are bit-identical to ``interval_latency(kappa1)`` draws
    from the same model state (pinned in ``tests/test_sim.py``). Use a
    dedicated model instance per consumer: masks (``survivors``) and
    timing draws interleave on one shared stream.
    """
    spec = NetworkSpec(
        compute_jitter=f"lognormal:{float(model.sigma)}",
        jitter_granularity="interval",
        seed=int(model.seed),
    )
    net = spec.build(tree)
    if model.num_clients != tree.num_clients:
        raise ValueError(
            f"StragglerModel has {model.num_clients} clients, tree has {tree.num_clients}"
        )
    net.client_speed = np.asarray(model.slowness, np.float64)
    jitter = LogNormalDist(float(model.sigma))
    jitter._rng = model._rng  # share the stream — the no-drift guarantee
    net.compute_jitter = jitter
    return net


def straggler_masks(
    model,
    kappa1: int,
    num_intervals: int,
    *,
    deadline: Optional[float] = None,
    cohort: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """(R, C) deadline masks for ``build_round_dag`` drawn from the same
    ``StragglerModel`` the runner uses (``survivors`` per boundary)."""
    rows = []
    for _ in range(num_intervals):
        mask, _ = model.survivors(kappa1, deadline)
        rows.append(mask if cohort is None else mask[np.asarray(cohort)])
    return np.stack(rows).astype(bool)
