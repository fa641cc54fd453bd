"""Compression trade-off: the kappa sweep against the codec sweep,
time-to-accuracy.

The paper trades aggregation frequency (kappa2) against convergence; the
transport layer adds the orthogonal axis of each hop's payload size. This
script sweeps both on the MNIST-cost workload: each (kappa1, kappa2)
schedule runs under an fp32 wire, an int8 cloud hop, and int8 with error
feedback on both hops, and reports steps, T_alpha and E_alpha to the
target accuracy with the cumulative uplink MB a client: the compounded
saving of arXiv:2103.14272 on top of HierFAVG's kappa2 lever. On the card
every compressed sync runs K4 and K5 once a leaf.

    python -m repro_torch.experiments.compression_tradeoff [--alpha 0.85] \\
        [--codecs identity/identity,identity/int8] [--device cpu]
"""
import argparse

from repro_torch.device import resolve_device
from repro_torch.experiments.common import add_device_argument, first_reach, run_schedule

# (label, per-level codec string, bottom-up)
DEFAULT_CODECS = (
    ("fp32", "identity/identity"),
    ("int8_cloud", "identity/int8"),
    ("int8_ef_both", "int8_ef/int8_ef"),
)
KAPPAS = ((30, 2), (15, 4), (6, 10))


def main(csv=True, alpha=0.85, codecs=DEFAULT_CODECS, kappas=KAPPAS, *, device=None, init=None, rounds=None):
    """One row dict per (schedule, codec) that reached ``alpha``;
    ``rounds`` (default 360 // kappa1) cuts every run to that many rounds."""
    device = resolve_device(device)
    rows = []
    print("# compression_tradeoff (mnist costs, edge_iid, alpha=%.2f)" % alpha)
    for k1, k2 in kappas:
        base = None
        for label, spec in codecs:
            r = run_schedule(
                k1, k2, partition="edge_iid", workload="mnist",
                rounds=rounds or 360 // k1, transport=spec, device=device, init=init,
            )
            hit = first_reach(r, alpha)
            if hit is None:
                print(f"tradeoff_k1={k1}_k2={k2}_{label},NOT_REACHED")
                continue
            steps, T, E = hit
            wire = next(h.wire_mb for h in r.history if h.step >= steps)
            if label == codecs[0][0]:
                base = (T, E, wire)
            speedup = base[0] / T if base else float("nan")
            wire_ratio = wire / base[2] if base else float("nan")
            rows.append(
                {"k1": k1, "k2": k2, "codec": label, "steps": steps,
                 "T_s": T, "E_j": E, "wire_mb": wire,
                 "time_speedup_vs_fp32": speedup,
                 "wire_ratio_vs_fp32": wire_ratio}
            )
            print(
                f"tradeoff_k1={k1}_k2={k2}_{label},steps={steps},T={T:.1f}s,"
                f"E={E:.2f}J,wire={wire:.2f}MB,speedup={speedup:.2f}x,"
                f"bytes_ratio={wire_ratio:.2f}"
            )
    return rows


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--alpha", type=float, default=0.85)
    ap.add_argument(
        "--codecs", default=None,
        help="comma-separated per-level codec strings, e.g. 'identity/int8,int8/int8'",
    )
    add_device_argument(ap)
    args = ap.parse_args(argv)
    codecs = DEFAULT_CODECS
    if args.codecs:
        codecs = tuple((c, c) for c in args.codecs.split(","))
    return main(alpha=args.alpha, codecs=codecs, device=args.device)


if __name__ == "__main__":
    cli()
