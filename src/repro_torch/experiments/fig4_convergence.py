"""Paper Fig. 4: accuracy against training epoch under the two guidelines.

(a) edge-IID: fixed kappa1*kappa2 = 60, kappa1 in {60, 30, 15, 6}; a
    smaller kappa1 reaches accuracy in fewer local epochs, and with kappa1
    fixed, raising kappa2 is nearly free (the curves coincide).
(b) edge-NIID: the same sweeps; raising kappa2 now hurts.

    python -m repro_torch.experiments.fig4_convergence [--device cpu]

Eight schedules of 50 clients on 5 edges, 240 local steps each, evaluated
every round.
"""
import argparse

from repro_torch.device import resolve_device
from repro_torch.experiments.common import add_device_argument, run_schedule

PARTITIONS = ("edge_iid", "edge_niid")
SCHEDULES = ((60, 1), (30, 2), (15, 4), (6, 10))


def main(csv=True, *, device=None, init=None, partitions=PARTITIONS, schedules=SCHEDULES, rounds=None):
    """{(partition, kappa1, kappa2): (steps, accuracies)} at the evaluated
    rounds. ``rounds`` (default 240 // kappa1) cuts every run to that
    many rounds."""
    device = resolve_device(device)
    out = {}
    for dist in partitions:
        for k1, k2 in schedules:
            r = run_schedule(k1, k2, partition=dist, rounds=rounds or 240 // k1, device=device, init=init)
            accs = [h.accuracy for h in r.history if h.accuracy is not None]
            steps = [h.step for h in r.history if h.accuracy is not None]
            out[(dist, k1, k2)] = (steps, accs)
            tag = f"fig4_{dist}_k1={k1}_k2={k2}"
            print(f"{tag},final_acc={accs[-1]:.3f},steps={steps[-1]}")
    # guideline 1: at an equal local-step budget, the smaller kappa1 does at
    # least as well as the larger
    small = min(schedules)
    large = max(schedules)
    if small != large:
        for dist in partitions:
            a_large = out[(dist, *large)][1][-1]
            a_small = out[(dist, *small)][1][-1]
            print(f"fig4_{dist}_guideline1,small_k1_acc={a_small:.3f},large_k1_acc={a_large:.3f},"
                  f"holds={a_small >= a_large - 0.02}")
    return out


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_argument(ap)
    return main(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    cli()
