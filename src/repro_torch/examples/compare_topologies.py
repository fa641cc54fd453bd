"""Cloud-based against edge-based against client-edge-cloud FL (the paper's
Fig. 1/2 story) on one synthetic problem: prints the accuracy-against-
simulated-time frontier of each topology, and of any ragged or deeper
hierarchies you ask for.

    python -m repro_torch.examples.compare_topologies [--device cpu]
    python -m repro_torch.examples.compare_topologies --levels 3
    python -m repro_torch.examples.compare_topologies \\
        --fanout 16,12,10,7,5/3,2/2 --kappas 6,5,2

``--fanout`` is the bottom-up child-count nest of the tree (levels
separated by '/'): ``16,12,10,7,5/3,2/2`` = five edges serving 16/12/10/7/5
clients, two regions of 3 and 2 edges, one cloud. ``--kappas`` is the
matching per-level schedule (local steps per edge aggregation, edge
aggregations per region aggregation, ...). On the card a ragged level's
mean runs K2 once a leaf, a uniform one K1.
"""
import argparse

from repro_torch.core import parse_fanouts
from repro_torch.device import resolve_device
from repro_torch.experiments.common import add_device_argument, first_reach, run_hierarchy_schedule, run_schedule
from repro_torch.experiments.fig2_topologies import run_edge_only

# 50 clients under progressively less uniform trees (the paper's topology first)
DEFAULT_SWEEP = {
    2: (
        ("hierarchical (uniform 5 edges)", "10,10,10,10,10/5", (6, 10)),
        ("hierarchical (ragged 5 edges)", "16,12,10,7,5/5", (6, 10)),
    ),
    3: (
        ("3-level (uniform 2 regions)", "10,10,10,10,10/3,2/2", (6, 5, 2)),
        ("3-level (ragged 2 regions)", "16,12,10,7,5/3,2/2", (6, 5, 2)),
    ),
}


def main(argv=None, *, init=None):
    """Returns {topology name: runner}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--levels", type=int, default=0,
                    help="also sweep trees of this depth (0 = both 2 and 3)")
    ap.add_argument("--fanout", type=str, default=None,
                    help="one explicit tree instead of the sweep, e.g. 16,12,10,7,5/3,2/2")
    ap.add_argument("--kappas", type=str, default=None,
                    help="per-level schedule for --fanout, e.g. 6,5,2")
    ap.add_argument("--rounds", type=int, default=100)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    sep = 2.0
    runs = {}
    print("training baseline topologies (50 clients, simple-NIID)...")
    runs["cloud-based (kappa=60, 10x latency)"] = run_schedule(
        60, 1, partition="simple_niid", rounds=10, class_sep=sep, device=device, init=init
    )
    runs["edge-based (1 edge, 10 clients)"] = run_edge_only(rounds=60, device=device, init=init)

    if args.fanout:
        spec = parse_fanouts(args.fanout)
        if args.kappas:
            kappas = tuple(int(k) for k in args.kappas.split(","))
        else:
            kappas = (6,) + (2,) * (spec.depth - 1)
        entries = [(f"custom {spec.describe()}", spec, kappas)]
    else:
        if args.kappas:
            ap.error("--kappas needs --fanout (the default sweep fixes its own schedules)")
        entries = []
        for depth, rows in DEFAULT_SWEEP.items():
            if args.levels and depth != args.levels:
                continue
            for name, fanout, kappas in rows:
                entries.append((name, parse_fanouts(fanout), kappas))

    for name, spec, kappas in entries:
        print(f"training {name}: tree {spec.describe()}, kappas {kappas}...")
        runs[name] = run_hierarchy_schedule(
            spec, kappas, partition="simple_niid", rounds=args.rounds, class_sep=sep, device=device, init=init
        )

    print(f"\n{'topology':42s} {'best acc':>8s} {'T_0.9':>9s}")
    for name, r in runs.items():
        hs = [h for h in r.history if h.accuracy is not None]
        hit = first_reach(r, 0.9)
        t = f"{hit[1]:8.1f}s" if hit else "   never"
        print(f"{name:42s} {max(h.accuracy for h in hs):8.3f} {t}")
    print("\nexpected (paper): hierarchical ~ cloud accuracy (same data reach), at a")
    print("fraction of the wall-clock; edge-based is fast but caps below (less data).")
    print("ragged/deeper trees track the uniform frontier — the schedule, not the")
    print("tree shape, sets the T/E tradeoff.")
    return runs


if __name__ == "__main__":
    main()
