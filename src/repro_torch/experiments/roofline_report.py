"""The roofline table from the dry run's artifacts: the port of
``benchmarks/roofline_report.py``.

    PYTHONPATH=src python -m repro_torch.experiments.roofline_report [--out artifacts/dryrun_torch]

Reads the JSONs that ``repro_torch.launch.dryrun`` wrote and prints JAX's
rows: one ``roofline,...`` row a single-pod cell (the three terms, the
dominant one, MODEL_FLOPS / counted FLOPs, the roofline fraction, and the
amortised HierFAVG step's collective time where the edge and cloud phases
were counted), one ``multipod,...`` row a multi-pod cell (the bytes a rank
moves over the "pod" axis), and one ``refused,...`` row a cell the port or
JAX refuses, with its words. The numbers are counts of one rank's ops
priced at the H100's data-sheet rates (``analysis.roofline``), not
measurements. ``--markdown`` prints the single-pod cells as PERF.md's
table instead.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional, Tuple

OUT = "artifacts/dryrun_torch"


def load(out_dir: str = OUT) -> Tuple[List[dict], List[dict]]:
    """(counted cells, refused cells) of ``out_dir``."""
    cells, refused = [], []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if "refused" in rec:
            refused.append(rec)
        elif "mesh" in rec and "roofline" in rec:  # skip auxiliary artifacts
            cells.append(rec)
    return cells, refused


def fmt_row(c: dict) -> str:
    r = c["roofline"]
    amort = c.get("phases", {}).get("amortized_step")
    extra = f",amortized_coll_ms={amort['collective_s'] * 1e3:.1f}" if amort else ""
    return (
        f"roofline,{c['arch']},{c['shape']},{c['mesh']},"
        f"compute_ms={r['compute_s'] * 1e3:.2f},memory_ms={r['memory_s'] * 1e3:.2f},"
        f"collective_ms={r['collective_s'] * 1e3:.2f},dominant={r['dominant']},"
        f"useful_flops_ratio={r['useful_flops_ratio']:.3f},"
        f"roofline_fraction={r['roofline_fraction']:.4f}{extra}"
    )


MARKDOWN_HEAD = ("| arch | shape | TFLOP a rank | HBM GB | coll GB | arg / temp GB | compute / memory / collective ms "
                 "| bound | roofline fraction | amortised step coll ms | traced s |\n" + "|---" * 11 + "|")


def markdown_row(c: dict) -> str:
    """A single-pod cell as a row of ``MARKDOWN_HEAD``."""
    r, m, ops = c["roofline"], c["memory"], c["ops"]
    amort = c.get("phases", {}).get("amortized_step")
    return (f"| {c['arch']} | {c['shape']} | {ops['flops_per_device'] / 1e12:.2f} | "
            f"{ops['hbm_bytes_per_device'] / 1e9:.1f} | {ops['coll_bytes_per_device'] / 1e9:.2f} | "
            f"{m['argument_size_in_bytes'] / 1e9:.2f} / {m['temp_size_in_bytes'] / 1e9:.2f} | "
            f"{r['compute_s'] * 1e3:.1f} / {r['memory_s'] * 1e3:.1f} / {r['collective_s'] * 1e3:.1f} | "
            f"{r['dominant']} | {r['roofline_fraction']:.3f} | "
            f"{'' if amort is None else format(amort['collective_s'] * 1e3, '.1f')} | {c['trace_s']:.1f} |")


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT, help="the dry run's artifact directory")
    ap.add_argument("--markdown", action="store_true", help="the single-pod cells as a markdown table")
    args = ap.parse_args(argv)
    cells, refused = load(args.out)
    if not cells and not refused:
        print("roofline_report,NO_ARTIFACTS (run: python -m repro_torch.launch.dryrun)")
        return 0
    single = [c for c in cells if "multi" not in c["mesh"]]  # the single pod's (or a host mesh's)
    multi = [c for c in cells if "multi" in c["mesh"]]
    if args.markdown:
        print("\n".join([MARKDOWN_HEAD] + [markdown_row(c) for c in single]))
        return 0
    print(f"# roofline table: {len(single)} single-pod cells, {len(multi)} multi-pod cells, {len(refused)} refused "
          f"(counted, not measured)")
    for c in single:
        print(fmt_row(c))
    print("# multi-pod (pod axis = DCN)")
    for c in multi:
        r = c["roofline"]
        dcn = sum(v for k, v in r["coll_breakdown"].items() if "pod" in k)
        print(f"multipod,{c['arch']},{c['shape']},dcn_GB_per_dev={dcn / 1e9:.3f},dominant={r['dominant']}")
    for c in refused:
        print(f"refused,{c['arch']},{c['shape']},{c['mesh']},{c['refused']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
