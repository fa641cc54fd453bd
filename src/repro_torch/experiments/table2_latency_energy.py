"""Paper Table II: T_alpha and E_alpha for the kappa sweeps.

IIa: MNIST-workload constants, edge-IID and edge-NIID partitions, alpha=0.85.
IIb: CIFAR-workload constants, simple-NIID partition, alpha=0.70.
Steps-to-accuracy are measured on the synthetic stand-in; T and E use the
paper's Table I cost constants, so the trade-off's structure (T falls with
kappa2; E is U-shaped) is the reproduction target.

IIc [beyond the paper]: the IIa edge-IID sweep rerun with an int8 cloud hop
(``fed.transport``): the same schedules at about a quarter of the cloud
hop's bytes, so T_alpha reflects the compressed wire. On the card every
compressed sync runs K4 and K5 once a leaf.

``--sim`` [beyond the paper] appends percentile rows: each IIa point's
T_alpha replayed by ``repro_torch.sim`` under the ``congested_backhaul``
network (10% of edges 8x slower, lognormal jitter), scaling the measured
steps-to-accuracy by the round-time distribution. Rounds are taken as
perfectly correlated (one network world per trial scales every interval
alike): a tail-heavy upper bound.

    python -m repro_torch.experiments.table2_latency_energy [--sim] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.experiments.common import add_device_argument, first_reach, run_schedule

KAPPAS_A = ((60, 1), (30, 2), (15, 4), (6, 10))
KAPPAS_C = ((30, 2), (15, 4), (6, 10))
KAPPAS_B = ((50, 1), (25, 2), (10, 5), (5, 10))


def _sim_rows(k1, k2, steps, label, trials=200):
    """p50 and p99 of T_alpha under the congested-backhaul network."""
    from repro_torch.fed import scenarios
    from repro_torch.sim import simulate_spec

    spec = scenarios.get("congested_backhaul", overrides=[f"schedule.kappas={k1},{k2}"])
    res = simulate_spec(spec, trials=trials)
    n_intervals = steps / (k1 * k2)
    t_alpha = n_intervals * res.round_time
    p50, p99 = np.percentile(t_alpha, [50.0, 99.0])
    print(
        f"table2sim_{label}_k1={k1}_k2={k2},trials={trials},"
        f"T50={p50:.1f}s,T99={p99:.1f}s,tail_ratio={p99 / p50:.3f}"
    )
    return float(p50), float(p99)


def main(csv=True, sim=False, sim_trials=200, *, device=None, init=None, sections="acb", kappas=None,
         rounds=None):
    """The rows (partition, kappa1, kappa2, steps, T, E) of IIa and IIc.
    ``sections`` picks among IIa, IIc and IIb; ``kappas`` replaces each
    chosen section's schedules, and ``rounds`` (default 360 // kappa1, IIb's
    300 // kappa1) cuts every run to that many rounds."""
    device = resolve_device(device)
    rows = []
    if "a" in sections:
        print("# Table IIa (mnist costs, alpha=0.85)")
        for dist in ("edge_iid", "edge_niid"):
            for k1, k2 in kappas or KAPPAS_A:
                r = run_schedule(k1, k2, partition=dist, workload="mnist", rounds=rounds or 360 // k1,
                                 device=device, init=init)
                hit = first_reach(r, 0.85)
                if hit is None:
                    print(f"table2a_{dist}_k1={k1}_k2={k2},NOT_REACHED")
                    continue
                steps, T, E = hit
                rows.append((dist, k1, k2, steps, T, E))
                print(f"table2a_{dist}_k1={k1}_k2={k2},steps={steps},T={T:.1f}s,E={E:.2f}J")
                if sim:
                    _sim_rows(k1, k2, steps, dist, trials=sim_trials)

    if "c" in sections:
        print("# Table IIc (mnist costs, alpha=0.85, edge IID, int8 cloud hop)")
        for k1, k2 in kappas or KAPPAS_C:
            r = run_schedule(k1, k2, partition="edge_iid", workload="mnist", rounds=rounds or 360 // k1,
                             transport="identity/int8", device=device, init=init)
            hit = first_reach(r, 0.85)
            if hit is None:
                print(f"table2c_int8_k1={k1}_k2={k2},NOT_REACHED")
                continue
            steps, T, E = hit
            rows.append(("edge_iid_int8_cloud", k1, k2, steps, T, E))
            print(f"table2c_int8_k1={k1}_k2={k2},steps={steps},T={T:.1f}s,E={E:.2f}J")

    if "b" in sections:
        print("# Table IIb (cifar costs, alpha=0.70, simple NIID)")
        for k1, k2 in kappas or KAPPAS_B:
            r = run_schedule(k1, k2, partition="simple_niid", workload="cifar10", rounds=rounds or 300 // k1,
                             device=device, init=init)
            hit = first_reach(r, 0.70)
            if hit is None:
                print(f"table2b_k1={k1}_k2={k2},NOT_REACHED")
                continue
            steps, T, E = hit
            print(f"table2b_k1={k1}_k2={k2},steps={steps},T={T:.0f}s,E={E:.0f}J")
    return rows


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sim", action="store_true",
                    help="append stochastic T_alpha percentile rows (repro_torch.sim)")
    ap.add_argument("--sim-trials", type=int, default=200)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    return main(sim=args.sim, sim_trials=args.sim_trials, device=args.device)


if __name__ == "__main__":
    cli()
