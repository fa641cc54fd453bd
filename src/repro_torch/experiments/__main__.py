"""Run the paper's figure and table scripts in turn, or one of them:

    python -m repro_torch.experiments [--only NAME] [--device cpu]

Each runs at its own default sizes; a failing script is named at the end
and the exit status is non-zero.
"""
import argparse
import time
import traceback

from repro_torch.experiments import (
    aggregation_scaling,
    compression_tradeoff,
    fig2_topologies,
    fig4_convergence,
    round_time_sim,
    table1_cost_model,
    table2_latency_energy,
    wallclock_curves,
)

SCRIPTS = {
    "table1_cost_model": lambda device: table1_cost_model.main(device=device),
    "fig4_convergence": lambda device: fig4_convergence.main(device=device),
    "table2_latency_energy": lambda device: table2_latency_energy.main(device=device),
    "fig2_topologies": lambda device: fig2_topologies.main(device=device),
    "aggregation_scaling": lambda device: aggregation_scaling.main([], device=device),
    "compression_tradeoff": lambda device: compression_tradeoff.main(device=device),
    "round_time_sim": lambda device: round_time_sim.main(device=device),
    "wallclock_curves": lambda device: wallclock_curves.main([], device=device),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None, help=f"one of {sorted(SCRIPTS)}")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.only and args.only not in SCRIPTS:
        raise SystemExit(f"unknown script {args.only!r}; choose from {sorted(SCRIPTS)}")
    failures = []
    for name, fn in SCRIPTS.items():
        if args.only and args.only != name:
            continue
        print(f"\n===== {name} =====", flush=True)
        t0 = time.time()
        try:
            fn(args.device)
            print(f"{name},elapsed_s={time.time() - t0:.1f}")
        except Exception as e:
            failures.append(name)
            print(f"{name},FAILED: {e}")
            traceback.print_exc()
    if failures:
        raise SystemExit(f"scripts failed: {failures}")


if __name__ == "__main__":
    main()
