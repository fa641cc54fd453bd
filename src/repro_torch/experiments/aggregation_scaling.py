"""HierFAVG's communication scaling: the paper's amortisation knob in
bytes, for uniform, ragged, and deeper-than-two hierarchies.

Analytic per-step link traffic (the ring model of ``dist.collectives``) for
the production meshes as a function of the per-level kappa schedule: how
the hierarchy moves traffic from the expensive (cloud) link to the cheap
(edge) link, what int8 delta compression buys on top, and where the
bottleneck edge sits when the fan-out is ragged. Host arithmetic only.

    python -m repro_torch.experiments.aggregation_scaling            # default sweep
    python -m repro_torch.experiments.aggregation_scaling --levels 3 # uniform 3-level
    python -m repro_torch.experiments.aggregation_scaling \\
        --fanout 16,12,10,7,5/3,2/2 --kappas 16,2,2                  # explicit tree
"""
import argparse

from repro_torch.configs.base import param_count
from repro_torch.configs.registry import get_config
from repro_torch.core.hierarchy import HierarchySpec, parse_fanouts
from repro_torch.device import resolve_device
from repro_torch.dist.collectives import hierarchy_traffic_per_step
from repro_torch.experiments.common import add_device_argument

ARCHS = ("granite-3-2b", "yi-9b", "deepseek-7b")

# the default sweep: the seed's two-level tree (8 edges x 4 clients), and a
# ragged two-level and uniform and ragged three-level variant of the same
# 32 clients
SWEEP = {
    2: (
        ("uniform", HierarchySpec.uniform(8, 4), ((1, 1), (16, 1), (16, 4), (64, 4))),
        ("ragged", parse_fanouts("8,6,6,4,3,2,2,1/8"), ((16, 4), (64, 4))),
    ),
    3: (
        ("uniform", parse_fanouts("4,4,4,4,4,4,4,4/4,4/2"), ((16, 2, 2), (64, 2, 2))),
        ("ragged", parse_fanouts("8,6,6,4,3,2,2,1/5,3/2"), ((16, 2, 2), (64, 2, 2))),
    ),
}


def report(arch: str, shape: str, spec: HierarchySpec, kappas, per_dev: float) -> dict:
    per_level = hierarchy_traffic_per_step(per_dev, spec, kappas)
    cells = ",".join(
        f"L{i+1}_MBps_per_step={b / 1e6:.2f}" for i, b in enumerate(per_level)
    )
    cloud = per_level[-1]
    kstr = "x".join(str(k) for k in kappas)
    print(
        f"agg_scaling_{arch}_{shape}_{spec.describe().split()[0]}_k={kstr},"
        f"{cells},cloud_int8={cloud / 4 / 1e6:.3f}"
    )
    return {"arch": arch, "shape": shape, "fanouts": spec.fanouts_text(), "kappas": tuple(kappas),
            "per_dev_bytes": per_dev, "per_level_bytes": list(per_level)}


def main(argv=None, csv=True, *, device=None):
    """The rows of the sweep (arch, tree, kappas, per-level bytes a step)
    and the headline's cloud-traffic reduction."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--levels", type=int, default=0,
                    help="restrict the sweep to trees of this depth (0 = all)")
    ap.add_argument("--fanout", type=str, default=None,
                    help="explicit bottom-up fan-out, e.g. 16,12,10,7,5/3,2/2")
    ap.add_argument("--kappas", type=str, default=None,
                    help="per-level schedule for --fanout, e.g. 16,2,2")
    ap.add_argument("--archs", type=str, default=",".join(ARCHS))
    add_device_argument(ap)
    # tolerate the flags of a caller that drives several scripts
    args, _ = ap.parse_known_args(argv)
    resolve_device(device if device is not None else args.device)

    if args.fanout:
        spec = parse_fanouts(args.fanout)
        if args.kappas:
            kappas = tuple(int(k) for k in args.kappas.split(","))
        else:
            kappas = (16,) + (2,) * (spec.depth - 1)
        sweep = {spec.depth: (("custom", spec, (kappas,)),)}
    else:
        if args.kappas:
            ap.error("--kappas needs --fanout (the default sweep fixes its own schedules)")
        sweep = {d: v for d, v in SWEEP.items() if not args.levels or d == args.levels}

    rows = []
    for arch in args.archs.split(","):
        cfg = get_config(arch)
        pbytes = param_count(cfg) * 2  # bf16
        per_dev = pbytes / 16  # TP-sharded within a client group
        for depth in sorted(sweep):
            for shape, spec, kappa_list in sweep[depth]:
                for kappas in kappa_list:
                    rows.append(report(arch, shape, spec, kappas, per_dev))

    # the headline: (16,4) against (1,1) cloud-traffic reduction on the seed topology
    cfg = get_config("granite-3-2b")
    per_dev = param_count(cfg) * 2 / 16
    uni = HierarchySpec.uniform(8, 4)
    c11 = hierarchy_traffic_per_step(per_dev, uni, (1, 1))[-1]
    c164 = hierarchy_traffic_per_step(per_dev, uni, (16, 4))[-1]
    print(
        f"agg_scaling_headline,cloud_traffic_reduction={c11 / c164:.0f}x,"
        f"with_int8={4 * c11 / c164:.0f}x"
    )
    return {"rows": rows, "cloud_traffic_reduction": c11 / c164}


if __name__ == "__main__":
    main()
