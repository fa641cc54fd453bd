#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold its CUDA
kernels against their plain PyTorch versions.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases, one JSON line each; any failure exits non-zero:

  build       compile every CUDA source of the port with nvcc (sm_90a)
  kernels     K1 grouped_mean and K2 segment_mean against their plain
              versions on the card, at the main path's shapes, f32 and bf16,
              with masked clients and a dead group; times by CUDA events
  quickstart  the ``quickstart`` scenario on cuda, then on the CPU (plain
              versions): per-round losses and accuracies must agree
  ragged      ``ragged_edges`` on cuda: K2 must launch, the loss must fall
  mlp307k     the full-width MLP (64 -> 4096 -> 10, 32 clients on 4 edges,
              kappa = (8, 2)) on cuda: loss falls, accuracy >= 0.9

The quickstart and mlp307k phases then run their scenario twice more,
warm: once timed, once under ``torch.profiler``, and report where the
device time of a cloud interval goes (by kernel class and top kernels) and
the device's idle share.

Then a kernel summary line, the card's name and power limit as nvidia-smi
reports them, and last ``{"ok": true, "device": {...}}``. Imports nothing
of JAX. Exits non-zero without a GPU.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
MLP307K = [
    "data.dim=64", "model.hidden=4096", "topology.num_edges=4", "topology.clients_per_edge=8",
    "schedule.kappas=8,2", "run.num_rounds=8", "run.eval_every=2",
]
KERNELS = {
    "grouped_mean": "src/repro/kernels/hier_aggregate.py:56",
    "segment_mean": "src/repro/kernels/hier_aggregate.py:193",
}
SOURCE = "src/repro_torch/kernels/csrc/hier_aggregate.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, *, flush, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events around each call,
    with the L2 cache flushed before each (a sync sees cold parameters)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_ulp(x):
    import torch

    mag = x.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def kernel_cases():
    """(kernel, label, N, D, groups or segment ids) at the main path's shapes."""
    import numpy as np

    ragged = np.repeat(np.arange(5), [16, 12, 10, 7, 5])
    return [
        ("grouped_mean", "quickstart w1 edge (20x768, G=4)", 20, 768, 4),
        ("grouped_mean", "mlp307k w1 edge (32x262144, G=4)", 32, 262144, 4),
        ("grouped_mean", "mlp307k w1 cloud (32x262144, G=1)", 32, 262144, 1),
        ("segment_mean", "ragged 16,12,10,7,5 (50x262144)", 50, 262144, ragged),
    ]


def phase_kernels(torch, ha):
    import numpy as np

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB > L2
    rng = np.random.default_rng(0)
    rows, summary = [], {}
    for name, label, n, d, groups in kernel_cases():
        ids = groups if name == "segment_mean" else np.repeat(np.arange(groups), n // groups)
        num = int(ids.max()) + 1
        kernel = (lambda x, w: ha.grouped_mean(x, w, num)) if name == "grouped_mean" else (
            lambda x, w: ha.segment_mean(x, w, ids, num))
        plain = (lambda x, w: ha.grouped_mean_plain(x, w, num)) if name == "grouped_mean" else (
            lambda x, w: ha.segment_mean_plain(x, w, ids, num))
        base = rng.uniform(0.5, 4.0, n).astype(np.float32)
        masked = base * (rng.random(n) > 0.3)
        for g in range(num):  # keep >= 1 survivor per group
            masked[np.flatnonzero(ids == g)[0]] = base[np.flatnonzero(ids == g)[0]]
        dead = masked * (ids != 0)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to("cuda", dtype)
            for variant, wn in (("weights", base), ("masked", masked), ("dead group 0", dead)):
                w = torch.from_numpy(wn).cuda()
                got, want = kernel(x, w), plain(x, w)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs()
                err = float(diff.max())
                # f32: both sum in f32 in another order, so they agree to a
                # few ulp of the largest input. bf16: the same, plus one bf16
                # ulp of the result, where the two f32 means round apart.
                f32_tol = 1e-5 * float(x.float().abs().max())
                if dtype == torch.float32:
                    check(err <= f32_tol, f"{name} {label} f32 {variant}: err {err}")
                else:
                    check(bool((diff <= bf16_ulp(want.float()) + f32_tol).all()),
                          f"{name} {label} bf16 {variant}: err {err} beyond one ulp")
                if variant == "dead group 0":  # bit for bit: compare the raw bits
                    rows0 = torch.from_numpy(np.flatnonzero(ids == 0)).cuda()
                    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                    check(torch.equal(got[rows0].view(bits), x[rows0].view(bits)),
                          f"{name} {label} {dtype}: dead group rows changed")
                row = {"kernel": name, "case": label, "dtype": str(dtype)[6:], "variant": variant,
                       "max_abs_err": err}
                if variant == "weights":
                    nbytes = 2 * x.numel() * x.element_size() + w.numel() * 4
                    row["ms"] = time_ms(lambda: kernel(x, w), flush=flush)
                    row["plain_ms"] = time_ms(lambda: plain(x, w), flush=flush)
                    row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
                    row["bound_by"] = "bytes"
                rows.append(row)
                if dtype == torch.float32:
                    s = summary.setdefault(name, {"max_abs_err": 0.0})
                    s["max_abs_err"] = max(s["max_abs_err"], err)
                    if variant == "weights":  # the last (largest) case of each kernel wins
                        s.update({k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}, case=label)
    emit({"phase": "kernels", "kernels": sorted(KERNELS), "cases": rows})
    return summary


def run_scenario(torch, ha, name, overrides, device, params=None, profiler=None):
    """Build, init and run a scenario; returns (runner, state, seconds,
    launches, params) with the launch counts reset just before the run and
    read just after it, so they count this run only. ``profiler`` (a
    ``torch.profiler.profile``) wraps ``runner.run`` alone."""
    from repro_torch.fed import scenarios

    spec = scenarios.get(name, overrides=overrides)
    runner = spec.build(device=device)
    if params is None:
        params = spec.init_params(spec.run.seed + 1, "cpu")
    state = runner.init(torch.Generator(device=device).manual_seed(spec.run.seed), params)
    if device == "cuda":
        torch.cuda.synchronize()
    ha.reset_launch_counts()
    with profiler if profiler is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        state = runner.run(state)
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = dict(ha.LAUNCHES)
    return runner, state, seconds, launches, params


def path_report(runner, seconds, launches, extra=None):
    hier = runner.hier_config
    steps = runner.cfg.num_rounds * hier.kappa1
    out = {
        "rounds": len(runner.history),
        "seconds": seconds,
        "client_steps_per_s": runner.topology.num_clients * steps / seconds,
        "launches": launches,
        "loss_first": runner.history[0].loss,
        "loss_last": runner.history[-1].loss,
        "accuracy": [h.accuracy for h in runner.history if h.accuracy is not None],
    }
    out.update(extra or {})
    return out


def kernel_class(name: str) -> str:
    if "grouped_mean_kernel" in name or "segment_mean_kernel" in name:
        return "aggregation (K1/K2)"
    low = name.lower()
    if "gemm" in low or "gemv" in low or "cutlass" in low or "matmul" in low:
        return "matrix products"
    return "other"


def device_profile(torch, ha, name, overrides, params):
    """Where the device time of a warm ``runner.run`` goes, per cloud
    interval: the run once more timed, then once under ``torch.profiler``
    (device-side events: kernels, copies, memsets)."""
    from torch.profiler import ProfilerActivity, profile

    runner, _, warm_s, *_ = run_scenario(torch, ha, name, overrides, "cuda", params)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    _, _, window_s, *_ = run_scenario(torch, ha, name, overrides, "cuda", params, profiler=prof)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_class, by_name = {}, {}
    for e in events:
        by_class[kernel_class(e.name)] = by_class.get(kernel_class(e.name), 0.0) + e.device_time_total
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    busy_us = sum(by_class.values())
    check(busy_us > 0, f"{name}: the profiler saw no device time")
    intervals = runner.cfg.num_rounds / runner.hier_config.kappa2_effective
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "cloud_intervals": intervals,
        "warm_wall_ms_per_interval": warm_s * 1e3 / intervals,
        "warm_client_steps_per_s": runner.topology.num_clients * runner.cfg.num_rounds
        * runner.hier_config.kappa1 / warm_s,
        "profiled_wall_ms_per_interval": window_s * 1e3 / intervals,
        "device_busy_ms_per_interval": busy_us / 1e3 / intervals,
        "device_busy_share_of_warm_wall": busy_us / 1e6 / warm_s,
        "device_idle_share_profiled": 1.0 - busy_us / 1e6 / window_s,
        "device_ops_per_interval": len(events) / intervals,
        "busy_ms_per_interval_by_class": {k: v / 1e3 / intervals for k, v in sorted(by_class.items())},
        "top_kernels_ms_per_interval": [[n[:90], v / 1e3 / intervals] for n, v in top],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import hier_aggregate as ha

    t0 = time.perf_counter()
    libs = _build.build_all()
    ptxas = [ln.strip() for p in libs.values() for ln in Path(str(p) + ".log").read_text().splitlines()
             if "Used" in ln] if all(Path(str(p) + ".log").exists() for p in libs.values()) else []
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [str(p) for p in libs.values()], "ptxas": ptxas})

    summary = phase_kernels(torch, ha)
    total = {name: 0 for name in KERNELS}

    # quickstart: cuda (kernels), then cpu (plain versions), same init
    runner, _, secs, launches, params = run_scenario(torch, ha, "quickstart", (), "cuda")
    intervals = runner.cfg.num_rounds // runner.hier_config.kappa2_effective
    check(launches["grouped_mean"] == intervals * 12, f"quickstart K1 launches {launches}")
    cpu_runner, *_ = run_scenario(torch, ha, "quickstart", (), "cpu", params=params)
    loss_rel = max(abs(a.loss - b.loss) / abs(b.loss) for a, b in zip(runner.history, cpu_runner.history))
    acc_gap = max((abs(a.accuracy - b.accuracy) for a, b in zip(runner.history, cpu_runner.history)
                   if a.accuracy is not None), default=0.0)
    check(len(runner.history) == len(cpu_runner.history) == runner.cfg.num_rounds, "quickstart rounds")
    check(loss_rel <= 1e-4, f"quickstart cuda vs cpu loss rel err {loss_rel}")
    check(acc_gap <= 0.01, f"quickstart cuda vs cpu accuracy gap {acc_gap}")
    for k in total:
        total[k] += launches[k]
    emit({"phase": "quickstart", **path_report(runner, secs, launches, {
        "cpu_loss_max_rel_err": loss_rel, "cpu_accuracy_max_gap": acc_gap,
        "final_accuracy": runner.history[-1].accuracy,
        "profile": device_profile(torch, ha, "quickstart", (), params)})})

    # ragged edges: level 1 goes through K2
    runner, _, secs, launches, _ = run_scenario(
        torch, ha, "ragged_edges", ["run.num_rounds=20", "run.eval_every=10"], "cuda")
    check(launches["segment_mean"] == 2 * 40 and launches["grouped_mean"] == 2 * 4, f"ragged launches {launches}")
    check(runner.history[-1].loss < runner.history[0].loss, "ragged_edges loss did not fall")
    emit({"phase": "ragged", **path_report(runner, secs, launches)})
    for k in total:
        total[k] += launches[k]

    # the full-width MLP design shape
    torch.cuda.reset_peak_memory_stats()
    runner, state, secs, launches, params = run_scenario(torch, ha, "hierfavg_edge_iid", MLP307K, "cuda")
    check(launches["grouped_mean"] == 4 * 12, f"mlp307k K1 launches {launches}")
    check(all(torch.isfinite(v).all() for v in state.params.values()), "mlp307k params not finite")
    check(tuple(state.params["w1"].shape) == (32, 64, 4096), "mlp307k w1 shape")
    check(runner.history[-1].loss < runner.history[0].loss, "mlp307k loss did not fall")
    check(runner.history[-1].accuracy >= 0.9, f"mlp307k accuracy {runner.history[-1].accuracy}")
    for k in total:
        total[k] += launches[k]
    emit({"phase": "mlp307k", **path_report(runner, secs, launches, {
        "params_per_client": sum(v[0].numel() for v in state.params.values()),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "profile": device_profile(torch, ha, "hierfavg_edge_iid", MLP307K, params)})})

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": KERNELS[name],
         "launches": total[name], "max_abs_err": summary[name]["max_abs_err"], "ms": summary[name]["ms"],
         "plain_ms": summary[name]["plain_ms"], "bound_ms": summary[name]["bound_ms"],
         "bound_by": summary[name]["bound_by"], "library_ms": None}
        for name in sorted(KERNELS)
    ]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
