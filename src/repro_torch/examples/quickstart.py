"""Quickstart: hierarchical FL from a declarative spec, in a few lines.

    python -m repro_torch.examples.quickstart [--device cpu]

Trains a small classifier across 20 clients on 4 edge servers with HierFAVG
(kappa1=4 local steps per edge aggregation, kappa2=2 edge rounds per cloud
round) and prints the accuracy and the simulated wall-clock and energy per
evaluated round. The experiment is the ``quickstart`` scenario; change any
axis with a dotted-path override, e.g.
``scenarios.get("quickstart", overrides=["schedule.kappas=6,2"])``.
"""
import argparse

from repro_torch.device import resolve_device
from repro_torch.experiments.common import add_device_argument, run_spec
from repro_torch.fed import scenarios


def main(argv=None, *, init=None):
    """Returns the runner."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    spec = scenarios.get("quickstart")
    print(spec.describe())
    runner, _ = run_spec(spec, device=device, init=init)
    for h in runner.history:
        if h.accuracy is not None:
            print(f"round {h.round:3d}  step {h.step:4d}  loss {h.loss:.3f}  "
                  f"acc {h.accuracy:.3f}  T={h.sim_time_s:6.1f}s  E={h.sim_energy_j:5.2f}J")
    final = [h.accuracy for h in runner.history if h.accuracy is not None][-1]
    print(f"\nfinal accuracy: {final:.3f} (HierFAVG, 20 clients / 4 edges, edge-NIID)")
    return runner


if __name__ == "__main__":
    main()
