#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold its CUDA
kernels against their plain PyTorch versions.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases, one JSON line each; any failure exits non-zero:

  build       compile every CUDA source of the port with nvcc (sm_90a)
  kernels     K1 grouped_mean and K2 segment_mean against their plain
              versions on the card, at the main path's shapes, f32 and bf16,
              with masked clients and a dead group; times by CUDA events
  transport_kernels
              K4 quantize and K5 dequantize against their plain versions at
              the transport's leaf shapes, f32 and bf16, qblock 256 and 128,
              bit for bit (an all-zero block must get scale 0); K6
              segment_dequant_mean against its plain version and against K5
              then K2, with masked clients and a dead group
  quickstart  the ``quickstart`` scenario on cuda, then on the CPU (plain
              versions): per-round losses and accuracies must agree
  ragged      ``ragged_edges`` on cuda: K2 must launch, the loss must fall
  mlp307k     the full-width MLP (64 -> 4096 -> 10, 32 clients on 4 edges,
              kappa = (8, 2)) on cuda: loss falls, accuracy >= 0.9
  int8_cloud, int8_ef_both
              the compressed-transport scenarios (cut to 20 rounds) on cuda,
              then on the CPU: losses agree, K4/K5 launch as counted
  mlp307k_int8_ef
              ``int8_ef_both`` at the full-width MLP's shape: int8 with error
              feedback (qblock 128) on both hops; final accuracy within 0.02
              of the uncompressed mlp307k run
  fused_decode
              the transport's fused decode-and-aggregate entry point (K6) on
              that run's client updates, at the edge and cloud groupings

The quickstart, mlp307k and mlp307k_int8_ef phases then run their scenario
twice more, warm: once timed, once under ``torch.profiler``, and report
where the device time of a cloud interval goes (by kernel class and top
kernels) and the device's idle share.

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
INT8_CLOUD = ["run.num_rounds=20", "run.eval_every=10"]
INT8_EF_BOTH = ["run.num_rounds=20"]
# kernel -> (the TPU kernel it replaces, its CUDA source)
KERNELS = {
    "grouped_mean": ("src/repro/kernels/hier_aggregate.py:56", "src/repro_torch/kernels/csrc/hier_aggregate.cu"),
    "segment_mean": ("src/repro/kernels/hier_aggregate.py:193", "src/repro_torch/kernels/csrc/hier_aggregate.cu"),
    "segment_dequant_mean": (
        "src/repro/kernels/hier_aggregate.py:132", "src/repro_torch/kernels/csrc/hier_aggregate.cu"),
    "quantize": ("src/repro/kernels/quantize.py:38", "src/repro_torch/kernels/csrc/quantize.cu"),
    "dequantize": ("src/repro/kernels/quantize.py:91", "src/repro_torch/kernels/csrc/quantize.cu"),
}


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
    emit({"phase": "kernels", "kernels": ["grouped_mean", "segment_mean"], "cases": rows})
    return summary


def bit_equal(a, b) -> bool:
    """Same shape, dtype and bits (so -0.0 and 0.0 differ)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
        return torch.equal(a.view(bits), b.view(bits))
    return torch.equal(a, b)


def phase_transport_kernels(torch, ha, qz):
    """K4 / K5 at the transport's leaf shapes and K6 at the sync's, each
    against its plain version on the same inputs."""
    import numpy as np

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB > L2
    rng = np.random.default_rng(1)
    rows, summary = [], {}
    for label, n, d in (("quickstart w1 (20x768)", 20, 768), ("b2 leaf (50x10)", 50, 10),
                        ("mlp307k w1 (32x262144)", 32, 262144)):
        for qblock in (256, 128):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32) * 3.0).to("cuda", dtype)
                x[0, :qblock] = 0.0  # an all-zero block
                q, s = qz.quantize_stacked(x, qblock)
                qp, sp = qz.quantize_stacked_plain(x, qblock)
                back = qz.dequantize_stacked(q, s, d, dtype)
                backp = qz.dequantize_stacked_plain(q, s, d, dtype)
                torch.cuda.synchronize()
                what = f"{label} qblock {qblock} {dtype}"
                check(bit_equal(q, qp), f"quantize {what}: codes differ from the plain version")
                check(bit_equal(s, sp), f"quantize {what}: scales differ from the plain version")
                check(float(s[0, 0]) == 0.0 and int(q[0, :qblock].abs().max()) == 0,
                      f"quantize {what}: an all-zero block did not get scale 0")
                check(bit_equal(back, backp), f"dequantize {what}: differs from the plain version")
                dp, nb = q.shape[1], s.shape[1]
                lib = None
                if dtype == torch.float32 and d == dp:  # one broadcast multiply computes K5
                    lib = lambda: torch.mul(q.view(n, nb, qblock), s.view(n, nb, 1))
                    check(bit_equal(lib().view(n, d), back), f"dequantize {what}: torch.mul differs")
                isz = x.element_size()
                for name, kernel, plain, nbytes, library in (
                    ("quantize", lambda: qz.quantize_stacked(x, qblock), lambda: qz.quantize_stacked_plain(x, qblock),
                     n * d * isz + n * dp + n * nb * 4, None),
                    ("dequantize", lambda: qz.dequantize_stacked(q, s, d, dtype),
                     lambda: qz.dequantize_stacked_plain(q, s, d, dtype), n * dp + n * nb * 4 + n * d * isz, lib),
                ):
                    row = {"kernel": name, "case": label, "qblock": qblock, "dtype": str(dtype)[6:],
                           "max_abs_err": 0.0, "ms": time_ms(kernel, flush=flush),
                           "plain_ms": time_ms(plain, flush=flush), "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                           "bound_by": "bytes",
                           "library_ms": None if library is None else time_ms(library, flush=flush)}
                    rows.append(row)
                    if n == 32 and qblock == 256 and dtype == torch.float32:  # the largest f32 case
                        summary[name] = {k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                             "bound_by", "library_ms")}
                        summary[name]["case"] = f"{label}, qblock {qblock}"

    k6 = summary.setdefault("segment_dequant_mean", {"max_abs_err": 0.0, "library_ms": None})
    ragged = np.repeat(np.arange(5), [16, 12, 10, 7, 5])
    for label, n, ids in (("mlp307k w1 edge (32x262144, G=4)", 32, np.repeat(np.arange(4), 8)),
                          ("mlp307k w1 cloud (32x262144, G=1)", 32, np.zeros(32, np.int64)),
                          ("ragged 16,12,10,7,5 (50x262144)", 50, ragged)):
        d, qblock = 262144, 256
        num = int(ids.max()) + 1
        q, s = qz.quantize_stacked(torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).cuda(), qblock)
        decoded = qz.dequantize_stacked(q, s, d)
        tol = 1e-5 * float(decoded.abs().max())
        base = rng.uniform(0.5, 4.0, n).astype(np.float32)
        masked = base * (rng.random(n) > 0.3)
        for g in range(num):  # keep >= 1 survivor per group
            first = np.flatnonzero(ids == g)[0]
            masked[first] = base[first]
        dead = masked * (ids != 0)
        for variant, wn in (("weights", base), ("masked", masked), ("dead group 0", dead)):
            w = torch.from_numpy(wn).cuda()
            got = ha.segment_dequant_mean(q, s, w, ids, num)
            want = ha.segment_dequant_mean_plain(q, s, w, ids, num)
            staged = ha.segment_mean(decoded, w, ids, num)  # K5 then K2
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(err <= tol, f"segment_dequant_mean {label} {variant}: err {err} > {tol}")
            staged_err = float((got - staged).abs().max())
            check(staged_err <= tol, f"segment_dequant_mean {label} {variant}: K5+K2 err {staged_err}")
            if variant == "dead group 0":
                rows0 = torch.from_numpy(np.flatnonzero(ids == 0)).cuda()
                check(bit_equal(got[rows0], decoded[rows0]), f"segment_dequant_mean {label}: dead rows changed")
            row = {"kernel": "segment_dequant_mean", "case": label, "variant": variant, "max_abs_err": err,
                   "k5_then_k2_max_abs_err": staged_err, "tolerance": tol}
            if variant == "weights":
                nbytes = n * d + s.numel() * 4 + n * 4 + n * d * 4
                row.update(ms=time_ms(lambda: ha.segment_dequant_mean(q, s, w, ids, num), flush=flush),
                           plain_ms=time_ms(lambda: ha.segment_dequant_mean_plain(q, s, w, ids, num), flush=flush),
                           k5_then_k2_ms=time_ms(lambda: ha.segment_mean(qz.dequantize_stacked(q, s, d), w, ids, num),
                                                 flush=flush),
                           bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
                k6.update({k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}, case=label)
            rows.append(row)
            k6["max_abs_err"] = max(k6["max_abs_err"], err)
    emit({"phase": "transport_kernels", "kernels": ["quantize", "dequantize", "segment_dequant_mean"],
          "cases": rows})
    return summary


def run_scenario(torch, mods, name, overrides, device, params=None, profiler=None):
    """Build, init and run a scenario; returns (runner, state, seconds,
    launches, params) with the launch counts of every kernel module in
    ``mods`` reset just before the run and read just after it, so they count
    this run only. ``profiler`` (a ``torch.profiler.profile``) wraps
    ``runner.run`` alone."""
    from repro_torch.fed import scenarios

    spec = scenarios.get(name, overrides=overrides)
    runner = spec.build(device=device)
    if params is None:
        params = spec.init_params(spec.run.seed + 1, "cpu")
    state = runner.init(torch.Generator(device=device).manual_seed(spec.run.seed), params)
    if device == "cuda":
        torch.cuda.synchronize()
    for m in mods:
        m.reset_launch_counts()
    with profiler if profiler is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        state = runner.run(state)
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = {k: v for m in mods for k, v in m.LAUNCHES.items()}
    return runner, state, seconds, launches, params


def cpu_agreement(torch, mods, runner, name, overrides, params):
    """The same run on the CPU (plain versions) from the same init: the
    largest per-round relative loss error and accuracy gap, checked. A
    round whose CPU loss is exactly 0 (the full-width MLP separates its data
    and the cross-entropy underflows) is held to |loss| <= 1e-6 instead."""
    cpu_runner, *_ = run_scenario(torch, mods, name, overrides, "cpu", params=params)
    check(len(runner.history) == len(cpu_runner.history) == runner.cfg.num_rounds, f"{name} rounds")
    pairs = [(a.loss, b.loss) for a, b in zip(runner.history, cpu_runner.history)]
    loss_rel = max((abs(a - b) / abs(b) for a, b in pairs if b != 0), default=0.0)
    zero_loss = max((abs(a) for a, b in pairs if b == 0), default=0.0)
    acc_gap = max((abs(a.accuracy - b.accuracy) for a, b in zip(runner.history, cpu_runner.history)
                   if a.accuracy is not None), default=0.0)
    check(loss_rel <= 1e-4, f"{name} cuda vs cpu loss rel err {loss_rel}")
    check(zero_loss <= 1e-6, f"{name} cuda loss {zero_loss} where the cpu loss is 0")
    check(acc_gap <= 0.01, f"{name} cuda vs cpu accuracy gap {acc_gap}")
    return {"cpu_loss_max_rel_err": loss_rel, "cpu_zero_loss_rounds": sum(b == 0 for _, b in pairs),
            "cuda_loss_max_where_cpu_zero": zero_loss, "cpu_accuracy_max_gap": acc_gap}


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
    if "quantize_kernel" in name:  # K4 quantize_kernel and K5 dequantize_kernel
        return "transport codec (K4/K5)"
    if "segment_dequant_mean_kernel" in name:
        return "fused decode-mean (K6)"
    low = name.lower()
    if "gemm" in low or "gemv" in low or "cutlass" in low or "matmul" in low:
        return "matrix products"
    return "other"


def device_profile(torch, mods, name, overrides, params):
    """Where the device time of a warm ``runner.run`` goes, per cloud
    interval: the run once more timed, then once under ``torch.profiler``
    (device-side events: kernels, copies, memsets)."""
    from torch.profiler import ProfilerActivity, profile

    runner, _, warm_s, *_ = run_scenario(torch, mods, name, overrides, "cuda", params)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    _, _, window_s, *_ = run_scenario(torch, mods, name, overrides, "cuda", params, profiler=prof)
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
    from repro_torch.core import aggregation
    from repro_torch.core.hierarchy import as_hierarchy
    from repro_torch.fed import transport
    from repro_torch.kernels import _build
    from repro_torch.kernels import hier_aggregate as ha
    from repro_torch.kernels import quantize as qz

    mods = (ha, qz)
    t0 = time.perf_counter()
    libs = _build.build_all()
    ptxas = [ln.strip() for p in libs.values() for ln in Path(str(p) + ".log").read_text().splitlines()
             if "Used" in ln] if all(Path(str(p) + ".log").exists() for p in libs.values()) else []
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [str(p) for p in libs.values()], "ptxas": ptxas})

    summary = phase_kernels(torch, ha)
    summary.update(phase_transport_kernels(torch, ha, qz))
    total = {name: 0 for name in KERNELS}

    def count(launches):
        for k in total:
            total[k] += launches[k]

    # quickstart: cuda (kernels), then cpu (plain versions), same init
    runner, _, secs, launches, params = run_scenario(torch, mods, "quickstart", (), "cuda")
    intervals = runner.cfg.num_rounds // runner.hier_config.kappa2_effective
    check(launches["grouped_mean"] == intervals * 12, f"quickstart K1 launches {launches}")
    agreement = cpu_agreement(torch, mods, runner, "quickstart", (), params)
    count(launches)
    emit({"phase": "quickstart", **path_report(runner, secs, launches, {
        **agreement, "final_accuracy": runner.history[-1].accuracy,
        "profile": device_profile(torch, mods, "quickstart", (), params)})})

    # ragged edges: level 1 goes through K2
    runner, _, secs, launches, _ = run_scenario(
        torch, mods, "ragged_edges", ["run.num_rounds=20", "run.eval_every=10"], "cuda")
    check(launches["segment_mean"] == 2 * 40 and launches["grouped_mean"] == 2 * 4, f"ragged launches {launches}")
    check(runner.history[-1].loss < runner.history[0].loss, "ragged_edges loss did not fall")
    emit({"phase": "ragged", **path_report(runner, secs, launches)})
    count(launches)

    # the full-width MLP design shape
    torch.cuda.reset_peak_memory_stats()
    runner, state, secs, launches, params = run_scenario(torch, mods, "hierfavg_edge_iid", MLP307K, "cuda")
    check(launches["grouped_mean"] == 4 * 12, f"mlp307k K1 launches {launches}")
    check(all(torch.isfinite(v).all() for v in state.params.values()), "mlp307k params not finite")
    check(tuple(state.params["w1"].shape) == (32, 64, 4096), "mlp307k w1 shape")
    check(runner.history[-1].loss < runner.history[0].loss, "mlp307k loss did not fall")
    check(runner.history[-1].accuracy >= 0.9, f"mlp307k accuracy {runner.history[-1].accuracy}")
    uncompressed_accuracy = runner.history[-1].accuracy
    count(launches)
    emit({"phase": "mlp307k", **path_report(runner, secs, launches, {
        "params_per_client": sum(v[0].numel() for v in state.params.values()),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "profile": device_profile(torch, mods, "hierfavg_edge_iid", MLP307K, params)})})

    # the compressed transport. One K4 and one K5 launch per leaf (4 for the
    # MLP) per compressed sync: int8_cloud compresses the cloud syncs only
    # (2 in 20 rounds of kappa (6, 10)), int8_ef_both every sync (20).
    # K1: 9 edge syncs x 4 leaves + a two-stage cloud sync x 4 per interval.
    for name, overrides, syncs in (("int8_cloud", INT8_CLOUD, 2), ("int8_ef_both", INT8_EF_BOTH, 20)):
        runner, state, secs, launches, params = run_scenario(torch, mods, name, overrides, "cuda")
        check(launches["quantize"] == launches["dequantize"] == syncs * 4, f"{name} K4/K5 launches {launches}")
        check(launches["grouped_mean"] == 2 * 44, f"{name} K1 launches {launches}")
        check(all(torch.isfinite(v).all() for v in state.params.values()), f"{name} params not finite")
        check(runner.history[-1].loss < runner.history[0].loss, f"{name} loss did not fall")
        agreement = cpu_agreement(torch, mods, runner, name, overrides, params)
        count(launches)
        emit({"phase": name, **path_report(runner, secs, launches, {
            **agreement, "transport": runner.hier_config.transport.describe(),
            "wire_mb": runner.history[-1].wire_mb, "final_accuracy": runner.history[-1].accuracy})})

    # int8 with error feedback on both hops at the full-width MLP's shape:
    # 8 syncs x 4 leaves
    torch.cuda.reset_peak_memory_stats()
    runner, state, secs, launches, params = run_scenario(torch, mods, "int8_ef_both", MLP307K, "cuda")
    check(launches["quantize"] == launches["dequantize"] == 8 * 4, f"mlp307k_int8_ef K4/K5 launches {launches}")
    check(launches["grouped_mean"] == 4 * 12, f"mlp307k_int8_ef K1 launches {launches}")
    check(all(torch.isfinite(v).all() for v in state.params.values()), "mlp307k_int8_ef params not finite")
    check(runner.history[-1].loss < runner.history[0].loss, "mlp307k_int8_ef loss did not fall")
    acc = runner.history[-1].accuracy
    check(abs(acc - uncompressed_accuracy) <= 0.02, f"mlp307k_int8_ef accuracy {acc} vs {uncompressed_accuracy}")
    peak = torch.cuda.max_memory_allocated()
    agreement = cpu_agreement(torch, mods, runner, "int8_ef_both", MLP307K, params)
    count(launches)
    emit({"phase": "mlp307k_int8_ef", **path_report(runner, secs, launches, {
        **agreement, "transport": runner.hier_config.transport.describe(), "final_accuracy": acc,
        "uncompressed_final_accuracy": uncompressed_accuracy, "wire_mb": runner.history[-1].wire_mb,
        "peak_memory_bytes": peak,
        "profile": device_profile(torch, mods, "int8_ef_both", MLP307K, params)})})

    # the fused decode-and-aggregate entry point (K6) on that run's client
    # updates (final minus initial model), encoded as the transport does,
    # at the edge (G=4) and cloud (G=1) groupings: 4 K4 and 8 K6 launches
    spec = as_hierarchy(runner.topology)
    n = spec.num_clients
    updates = {k: (v - params[k].to("cuda")).reshape(n, -1).contiguous() for k, v in state.params.items()}
    for m in mods:
        m.reset_launch_counts()
    t0 = time.perf_counter()
    encoded = {k: transport.quantize_rows(u, 128) for k, u in updates.items()}
    fused = {(level, k): transport.fused_decode_segment_mean(q, s, runner.weights, spec.segments(level),
                                                             spec.num_nodes(level))
             for level in (1, 2) for k, (q, s) in encoded.items()}
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: v for m in mods for k, v in m.LAUNCHES.items()}
    check(launches["segment_dequant_mean"] == 8 and launches["quantize"] == 4, f"fused_decode launches {launches}")
    worst = 0.0
    for (level, k), got in fused.items():
        q, s = encoded[k]
        decoded = transport.dequantize_rows(q, s, q.shape[1], 128)
        want = aggregation.segment_weighted_mean({k: decoded}, runner.weights, spec.segments(level),
                                                 spec.num_nodes(level))[k]
        err = float((got - want).abs().max())
        check(torch.isfinite(got).all() and err <= 1e-5 * float(decoded.abs().max()) + 1e-30,
              f"fused_decode level {level} {k}: err {err}")
        worst = max(worst, err)
    count(launches)
    emit({"phase": "fused_decode", "seconds": secs, "launches": launches, "max_abs_err_vs_k5_then_mean": worst})

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][1], "replaces": KERNELS[name][0],
         "launches": total[name], "max_abs_err": summary[name]["max_abs_err"], "ms": summary[name]["ms"],
         "plain_ms": summary[name]["plain_ms"], "bound_ms": summary[name]["bound_ms"],
         "bound_by": summary[name]["bound_by"], "library_ms": summary[name].get("library_ms")}
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
