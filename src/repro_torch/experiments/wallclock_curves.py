"""Wall-clock-against-accuracy curves: the synchronous barrier against
deadline and FedBuff-buffered cloud rounds under a straggler tail.

Round-count curves hide what the semi-synchronous engine buys: a deadline
round is cheaper in seconds because the cloud stops waiting for the
slowest edge. This script prices every variant on the same event clock
(per-edge cadences from the same ``StragglerModel`` slowness tail) and
reports accuracy against simulated wall-clock seconds:

* ``sync``      the full barrier (quorum=1.0) through the deadline engine,
                bit-exact with the synchronous superround engine but
                carrying the event clock, so the baseline's seconds are honest
* ``deadline``  60% quorum and staleness decay, with mid-round edge dropout
                injected (graceful degradation, not a crash)
* ``buffered``  FedBuff-style: the first K=3 edge arrivals fold per round

Gates (``--smoke``):

* every variant completes all rounds under fault injection,
* the deadline engine reaches the shared accuracy target in strictly less
  simulated wall-clock time than the synchronous barrier,
* the final deadline and buffered accuracy sit within ``ACC_FLOOR`` of the
  synchronous baseline.

    python -m repro_torch.experiments.wallclock_curves [--smoke] [--rounds N] \\
        [--json OUT.json] [--device cpu]

``--json`` merges the results under ``"semisync"``; no file is written
without it.
"""
from __future__ import annotations

import argparse

from repro_torch.device import resolve_device
from repro_torch.experiments.common import add_device_argument, run_spec

ACC_FLOOR = 0.10  # the largest accuracy giveback against the synchronous baseline
TARGET_FRACTION = 0.90  # the shared target: this fraction of the weaker final accuracy


def _base_overrides(rounds: int) -> list:
    # the straggler_tail problem on a deadline-friendly cadence: kappas=(4,5),
    # so an eval lands on every cloud boundary (5 rounds); the deadline
    # engine refuses an eval finer than a cloud interval
    return [
        "schedule.kappas=4,5",
        "data.class_sep=2.0",
        f"run.num_rounds={rounds}",
        "run.eval_every=5",
        "failures.straggler_sigma=0.4",
        "failures.straggler_mean_s=1.0",
        "failures.seed=5",
    ]


VARIANTS = {
    "sync": ["deadline.enabled=true", "deadline.quorum=1.0"],
    "deadline": [
        "deadline.enabled=true", "deadline.quorum=0.6",
        "deadline.staleness=poly:0.5", "deadline.max_staleness=3",
        "deadline.edge_drop_rate=0.1", "deadline.retry_limit=1",
        "deadline.seed=5",
    ],
    "buffered": [
        "deadline.enabled=true", "deadline.buffer_size=3",
        "deadline.staleness=poly:0.5", "deadline.max_staleness=3",
        "deadline.seed=5",
    ],
}


def _run_variant(name: str, rounds: int, *, device=None, init=None) -> dict:
    from repro_torch.fed.api import ExperimentSpec

    spec = ExperimentSpec.parse(_base_overrides(rounds) + VARIANTS[name])
    runner, _ = run_spec(spec, device=device, init=init)
    curve = [
        {"round": h.round, "wall_s": h.wall_clock_s, "accuracy": h.accuracy}
        for h in runner.history
        if h.accuracy is not None
    ]
    return {
        "overrides": VARIANTS[name],
        "rounds": len(runner.history),
        "final_accuracy": runner.history[-1].accuracy,
        "final_wall_s": runner.history[-1].wall_clock_s,
        "curve": curve,
    }


def _time_to(curve: list, alpha: float):
    for p in curve:
        if p["accuracy"] is not None and p["accuracy"] >= alpha:
            return p["wall_s"]
    return None


def wallclock_section(rounds: int, *, device=None, init=None) -> dict:
    device = resolve_device(device)
    results = {name: _run_variant(name, rounds, device=device, init=init) for name in VARIANTS}
    # the shared target, reachable by both sync and deadline, so the time to
    # it compares the engines rather than who converged further
    target = TARGET_FRACTION * min(
        results["sync"]["final_accuracy"], results["deadline"]["final_accuracy"]
    )
    for name, res in results.items():
        res["time_to_target_s"] = _time_to(res["curve"], target)
    return {"target_accuracy": target, "variants": results}


def check_gates(section: dict) -> list:
    failures = []
    res = section["variants"]
    for name, r in res.items():
        if r["rounds"] == 0 or r["final_accuracy"] is None:
            failures.append(f"{name}: run did not complete")
    sync, dl = res["sync"], res["deadline"]
    t_sync, t_dl = sync["time_to_target_s"], dl["time_to_target_s"]
    if t_dl is None:
        failures.append("deadline: never reached the shared target accuracy")
    elif t_sync is not None and not t_dl < t_sync:
        failures.append(
            f"deadline time-to-target {t_dl:.2f}s not below synchronous {t_sync:.2f}s"
        )
    for name in ("deadline", "buffered"):
        gap = sync["final_accuracy"] - res[name]["final_accuracy"]
        if gap > ACC_FLOOR:
            failures.append(
                f"{name}: final accuracy {res[name]['final_accuracy']:.3f} is "
                f"{gap:.3f} below the synchronous baseline (floor {ACC_FLOOR})"
            )
    return failures


def main(argv=None, *, device=None, init=None) -> dict:
    """The ``semisync`` section; ``device`` (when given) takes the place of
    ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced rounds + hard gates")
    ap.add_argument("--rounds", type=int, default=None,
                    help="override the round count (default 60, smoke 20)")
    ap.add_argument("--json", default=None, metavar="OUT.json",
                    help="merge the results into this file (none is written without it)")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    rounds = args.rounds or (20 if args.smoke else 60)

    section = wallclock_section(rounds, device=device if device is not None else args.device, init=init)
    print(f"target accuracy: {section['target_accuracy']:.3f}")
    for name, r in section["variants"].items():
        t = r["time_to_target_s"]
        print(
            f"  {name:9s} final_acc={r['final_accuracy']:.3f} "
            f"wall={r['final_wall_s']:8.2f}s "
            f"time_to_target={'never' if t is None else f'{t:8.2f}s'}"
        )

    if args.json:
        from repro_torch.experiments.common import merge_write_json

        merge_write_json(args.json, {"semisync": section})
        print(f"wrote semisync section -> {args.json}")

    if args.smoke:
        failures = check_gates(section)
        if failures:
            raise SystemExit("chaos gate FAILED:\n  " + "\n  ".join(failures))
        print("chaos gate OK: completes under dropout, deadline beats the "
              "barrier to target, accuracy within the floor")
    return section


if __name__ == "__main__":
    main()
