"""End-to-end federated LM training, spec-driven.

    python -m repro_torch.examples.train_hier_lm              # ~10M model, fast
    python -m repro_torch.examples.train_hier_lm --preset 100m --rounds 40

Trains a decoder-only LM with HierFAVG across 8 clients on 2 edges on a
Markov-teacher token corpus with label-skewed (edge-NIID) client splits,
with checkpoints and failure injection, assembled from the
``lm_edge_niid`` scenario. Every flag is a dotted-path override on that
spec; ``--device cpu`` runs the plain path. On the card every level mean
runs K1 once a leaf.

The default ``--ckpt-dir`` is ``hier_lm_ckpt_torch`` under the temporary
directory: the port's checkpoints hold ``torch.Generator`` state where the
JAX package's hold a threefry key, so neither resumes from the other's.
"""
import argparse
import os
import tempfile
import time

from repro_torch.device import resolve_device
from repro_torch.experiments.common import add_device_argument, run_spec
from repro_torch.fed import scenarios


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "hier_lm_ckpt_torch")


def main(argv=None, *, init=None):
    """Returns (runner, final state)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="10m", choices=["10m", "100m"])
    ap.add_argument("--rounds", type=int, default=24)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=default_ckpt_dir())
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failures", action="store_true")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="PATH=VALUE", help="extra spec overrides, repeatable")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    overrides = [
        f"model.arch=lm-{args.preset}",
        f"run.num_rounds={args.rounds}",
        f"data.seq_len={args.seq_len}",
        f"run.checkpoint_dir={args.ckpt_dir}",
        "run.checkpoint_every=8",
    ]
    if args.inject_failures:
        overrides += ["failures.p_fail=0.1"]
    spec = scenarios.get("lm_edge_niid", overrides=overrides + args.overrides)
    print(spec.describe())

    t0 = time.time()
    runner, state = run_spec(spec, device=device, init=init, resume=args.resume)
    for h in runner.history:
        if h.round % 4 == 0 or h.round == spec.run.num_rounds - 1:
            print(f"round {h.round:3d}  step {h.step:4d}  loss {h.loss:.4f}  alive {h.mask_alive}")
    print(f"\ntrained {int(state.step)} local steps in {time.time()-t0:.0f}s; "
          f"loss {runner.history[0].loss:.3f} -> {runner.history[-1].loss:.3f}")
    return runner, state


if __name__ == "__main__":
    main()
