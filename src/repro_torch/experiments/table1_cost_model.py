"""Paper Table I: per-iteration and per-upload latency and energy constants.

    python -m repro_torch.experiments.table1_cost_model [--device cpu]

Host arithmetic only; the entry point still resolves its device, as every
script of the port does.
"""
import argparse

from repro_torch.core import cost_model as cm
from repro_torch.device import resolve_device
from repro_torch.experiments.common import add_device_argument


def main(csv=False, *, device=None):
    resolve_device(device)
    rows = []
    for name in ("mnist", "cifar10"):
        w = cm.paper_workload(name)
        rows.append((name, w.t_comp, w.t_comm_edge, w.e_comp, w.e_comm_edge))
    print("# Table I — latency/energy constants (paper values in parens)")
    print("# expected: mnist 0.024s/0.1233s/0.0024J/0.0616J; cifar 4s/33s/0.4J/16.5J")
    for name, tc, tm, ec, em in rows:
        print(f"table1_{name},T_comp={tc:.4f}s,T_comm={tm:.4f}s,E_comp={ec:.4f}J,E_comm={em:.4f}J")
    return rows


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_argument(ap)
    return main(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    cli()
