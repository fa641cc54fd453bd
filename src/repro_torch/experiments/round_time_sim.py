"""Round-time and energy distributions: the ``repro_torch.sim`` replay
family, host numpy (bit-identical to the JAX package's simulator).

Four sections, returned under ``sim`` and merged into ``--json PATH``
(merge-preserving; no file is written without it):

* ``parity``      the zero-variance replay against the analytic
                  ``cloud_interval_time`` / ``cloud_interval_energy`` over
                  every paper workload x a kappa grid: the largest relative
                  error (must sit at float64 machine precision)
* ``determinism`` the congested scenario replayed twice from fresh seeded
                  builds: the percentiles must be bit-identical
* ``scenarios``   p50/p90/p99 round time and energy of the registered sim
                  scenarios, with the analytic point estimate and the
                  p99/analytic tail ratio the analytic model cannot see
* ``association`` the HFEL-style optimizer on ``hetero_clients_assoc``:
                  p99 before and after, moves, relative improvement

``--smoke`` is the gate: parity rel-err < 1e-12, bit-identical
determinism, and association p99_after <= p99_before, at reduced trial
counts.

    python -m repro_torch.experiments.round_time_sim [--smoke] [--trials N] \\
        [--json OUT.json] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.experiments.common import add_device_argument

PARITY_KAPPAS = ((1, 1), (4, 2), (6, 10), (15, 4), (30, 2), (60, 1))
PARITY_TOL = 1e-12


def parity_section() -> dict:
    """The largest |replay - analytic| / analytic over workloads x the kappa
    grid, plus a ragged-tree, compressed-transport and cluster-cost check."""
    from repro_torch.core.cost_model import (
        ClusterCosts,
        cloud_interval_energy,
        cloud_interval_time,
        paper_workload,
    )
    from repro_torch.core.hierarchy import HierarchySpec
    from repro_torch.sim import build_round_dag, from_cluster, from_workload, simulate_round

    worst = 0.0
    worst_at = ""
    trees = {
        "uniform": HierarchySpec.uniform(5, 10),
        "ragged": HierarchySpec.from_fanouts([[16, 12, 10, 7, 5], [5]]),
    }
    for wl in ("mnist", "cifar10"):
        costs = paper_workload(wl)
        for bits, tag in ((None, "fp32"), ((32.0, 8.0), "int8_cloud")):
            eff = costs if bits is None else costs.with_bits(*bits)
            sim_costs = from_workload(costs, 2, bits_per_param=bits)
            for k1, k2 in PARITY_KAPPAS:
                want_t = cloud_interval_time(eff, k1, k2)
                want_e = cloud_interval_energy(eff, k1, k2)
                for tree_name, tree in trees.items():
                    res = simulate_round(build_round_dag(tree, (k1, k2)), sim_costs)
                    rel_t = abs(float(res.round_time[0]) - want_t) / want_t
                    rel_e = float(
                        np.max(np.abs(res.client_energy[0] - want_e)) / want_e
                    )
                    rel = max(rel_t, rel_e)
                    if rel > worst:
                        worst, worst_at = rel, f"{wl}/{tag}/{tree_name}/k{k1}x{k2}"
    cc = ClusterCosts(t_step=1e-3, t_edge_agg=2e-4, t_cloud_agg=2e-3)
    res = simulate_round(
        build_round_dag(trees["uniform"], (6, 10)), from_cluster(cc, 2)
    )
    want = cc.interval_time(6, 10)
    rel = abs(float(res.round_time[0]) - want) / want
    if rel > worst:
        worst, worst_at = rel, "cluster/k6x10"
    out = {"max_rel_err": worst, "worst_at": worst_at, "tol": PARITY_TOL,
           "ok": worst < PARITY_TOL}
    print(f"sim_parity,max_rel_err={worst:.3e},at={worst_at},ok={out['ok']}")
    return out


def _replay_scenario(name: str, trials: int):
    from repro_torch.fed import scenarios
    from repro_torch.sim import simulate_spec

    return simulate_spec(scenarios.get(name), trials=trials)


def determinism_section(trials: int) -> dict:
    """Two fresh seeded builds must give bit-identical distributions."""
    a = _replay_scenario("congested_backhaul", trials)
    b = _replay_scenario("congested_backhaul", trials)
    identical = bool(
        np.array_equal(a.finish, b.finish) and np.array_equal(a.energy, b.energy)
    )
    out = {"trials": trials, "bit_identical": identical,
           "p99_s": a.percentiles()["p99_s"]}
    print(f"sim_determinism,trials={trials},bit_identical={identical}")
    return out


def scenarios_section(trials: int) -> dict:
    """Percentiles and the analytic tail ratio of the registered sim scenarios."""
    from repro_torch.core.cost_model import cloud_interval_time, paper_workload
    from repro_torch.fed import scenarios

    out = {}
    for name in ("congested_backhaul", "hetero_clients_assoc", "straggler_tail"):
        spec = scenarios.get(name)
        res = _replay_scenario(name, trials)
        k = spec.schedule.kappas
        analytic = cloud_interval_time(paper_workload(spec.cost.workload), k[0], k[1])
        s = res.summary()
        p = s["round_time"]
        row = {
            "kappas": list(k),
            "trials": trials,
            "round_time": p,
            "energy_per_client_j": s["energy_per_client_j"],
            "analytic_s": analytic,
            "tail_ratio_p99": p["p99_s"] / analytic,
            "cdf": res.cdf(17),
        }
        out[name] = row
        print(
            f"sim_scenario_{name},p50={p['p50_s']:.3f}s,p99={p['p99_s']:.3f}s,"
            f"analytic={analytic:.3f}s,tail_ratio={row['tail_ratio_p99']:.3f}"
        )
    return out


def association_section(trials: int) -> dict:
    """HFEL association on the heterogeneous scenario: p99 before and after."""
    from repro_torch.core.cost_model import paper_workload
    from repro_torch.core.hierarchy import as_hierarchy
    from repro_torch.fed import scenarios
    from repro_torch.sim import from_workload, optimize_association

    spec = scenarios.get("hetero_clients_assoc")
    tree = as_hierarchy(spec.topology.build())
    costs = from_workload(paper_workload(spec.cost.workload), tree.depth)
    net = spec.network.build(tree)
    result = optimize_association(
        tree, costs, net, spec.schedule.kappas, trials=trials,
        objective="p99_time", top_k=6, max_rounds=6,
    )
    out = {
        "scenario": "hetero_clients_assoc",
        "trials": trials,
        "p99_before_s": result.value_before,
        "p99_after_s": result.value_after,
        **{k: v for k, v in result.to_dict().items() if k not in ("value_before", "value_after")},
    }
    print(
        f"sim_association,p99_before={result.value_before:.3f}s,"
        f"p99_after={result.value_after:.3f}s,"
        f"improvement={100 * result.improvement:.1f}%,"
        f"moves={len(result.moves)},evals={result.evals}"
    )
    return out


def check_gates(sim: dict) -> list:
    """The ``--smoke`` gates' failures (empty when they hold)."""
    failures = []
    if not sim["parity"]["ok"]:
        failures.append(f"zero-variance parity drift: max_rel_err="
                        f"{sim['parity']['max_rel_err']:.3e} (tol {PARITY_TOL})")
    if not sim["determinism"]["bit_identical"]:
        failures.append("replay not bit-identical across two seeded runs")
    assoc = sim["association"]
    if assoc["p99_after_s"] > assoc["p99_before_s"]:
        failures.append(f"association made p99 worse: {assoc['p99_before_s']:.3f}s -> "
                        f"{assoc['p99_after_s']:.3f}s")
    return failures


def main(smoke: bool = False, trials: int = 0, json_path: str = None, *, device=None) -> dict:
    resolve_device(device)
    trials = trials or (40 if smoke else 200)
    assoc_trials = max(trials // 2, 16)
    sim = {
        "smoke": bool(smoke),
        "parity": parity_section(),
        "determinism": determinism_section(min(trials, 40)),
        "scenarios": scenarios_section(trials),
        "association": association_section(assoc_trials),
    }
    if json_path:
        from repro_torch.experiments.common import merge_write_json

        merge_write_json(json_path, {"bench": "round_time_sim", "sim": sim})
        print(f"wrote {json_path}")
    if smoke:
        failures = check_gates(sim)
        if failures:
            raise SystemExit(failures[0])
    return sim


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced trials + hard gates (parity, determinism, association)")
    ap.add_argument("--trials", type=int, default=0, help="replay trials (0 = default)")
    ap.add_argument("--json", default=None, metavar="OUT.json",
                    help="merge the sections into this file (none is written without it)")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    return main(smoke=args.smoke, trials=args.trials, json_path=args.json, device=args.device)


if __name__ == "__main__":
    cli()
