"""Three-term roofline model with the NVIDIA H100 SXM's data-sheet peaks.

    compute term    = FLOPs / 67 TFLOP/s (f32: the port computes f32
                      with TF32 off)
    memory term     = HBM bytes / 3.35 TB/s
    collective term = collective bytes / NVLink's rate

Port of ``repro.analysis.roofline``. The arithmetic of ``RooflineTerms``,
``hierfavg_step_terms``, ``CalibrationResult``, ``megakernel_interval_cost``
and ``model_flops`` is JAX's; the TPU v5e constants give way to the H100's
(one compute peak, f32 outside the tensor cores, as JAX has one for the
TPU's bf16). ``from_summary`` takes any object with
``flops``, ``hbm_bytes``, ``collective_bytes_per_device()`` and
``collective_breakdown()`` (the JAX package's ``HloSummary`` is one; the
port has no HLO parser).

HierFAVG-specific accounting: the paper's contribution is *amortization* of
the two aggregation hops. ``hierfavg_step_terms`` combines the local-step
cell with the edge/cloud phase cells as

    per-step collective = local + edge/κ₁ + cloud/(κ₁·κ₂)

with the cloud hop's bytes optionally scaled by the DCN slowdown (the
paper's 10× edge→cloud latency assumption, Section IV-A): breakdown keys
containing "pod" are priced at NVLink's rate times ``DCN_SLOWDOWN``.

``measure_host_peaks`` and ``calibrate_megakernel`` close the loop on a
live device: a timed matmul and a timed streaming add give the device's own
peaks, and one fused edge interval (K3 through ``kernels.ops.edge_interval``
with ``path="kernel"``, its plain version with ``path="ref"``) is reported
as achieved-vs-peak fractions. On CUDA they time with CUDA events after a
synchronise, and zero a buffer larger than the L2 cache before each timed
call; on the CPU with the host clock.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

PEAK_FLOPS = 67e12  # FLOP/s, f32 outside the tensor cores (H100 SXM data sheet)
HBM_BW = 3.35e12  # bytes/s of HBM3 (H100 SXM data sheet)
NVLINK_BW = 450e9  # bytes/s one way over all 18 NVLink 4 links of one card (900 GB/s both ways)
DCN_SLOWDOWN = 10.0  # the paper's cloud:edge latency ratio, reused for the pod axis
FLUSH_BYTES = 2**30  # zeroed before each timed CUDA call: evicts the 50 MB L2 and covers the host's queueing


@dataclasses.dataclass
class RooflineTerms:
    name: str
    chips: int
    flops_per_device: float
    hbm_bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, float]  # mesh-axis class -> bytes/device
    model_flops_global: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        """NVLink bytes at NVLink speed + pod-axis (DCN) bytes at DCN speed."""
        dcn = sum(v for k, v in self.coll_breakdown.items() if "pod" in k)
        link = self.coll_bytes_per_device - dcn
        return link / NVLINK_BW + dcn * DCN_SLOWDOWN / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops_global / total if total > 0 else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the step runs at the
        max-term speed: (useful compute time) / (bound time)."""
        if self.bound_s <= 0:
            return 0.0
        useful_s = self.model_flops_global / (self.chips * PEAK_FLOPS)
        return useful_s / self.bound_s

    def to_dict(self) -> Dict:
        return {
            "name": self.name,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "coll_breakdown": self.coll_breakdown,
            "model_flops_global": self.model_flops_global,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def from_summary(name: str, summary, chips: int, *, model_flops_global: float = 0.0) -> RooflineTerms:
    """Terms from a per-device summary: any object with ``flops``,
    ``hbm_bytes``, ``collective_bytes_per_device()`` and
    ``collective_breakdown()``."""
    return RooflineTerms(
        name=name,
        chips=chips,
        flops_per_device=summary.flops,
        hbm_bytes_per_device=summary.hbm_bytes,
        coll_bytes_per_device=summary.collective_bytes_per_device(),
        coll_breakdown=summary.collective_breakdown(),
        model_flops_global=model_flops_global,
    )


def hierfavg_step_terms(
    name: str,
    local: RooflineTerms,
    edge: Optional[RooflineTerms],
    cloud: Optional[RooflineTerms],
    kappa1: int,
    kappa2: int,
) -> RooflineTerms:
    """Amortized per-local-step terms — the paper's protocol in roofline form."""

    def scaled(t: Optional[RooflineTerms], f: float):
        if t is None:
            return 0.0, 0.0, 0.0, {}
        bd = {k: v * f for k, v in t.coll_breakdown.items()}
        return t.flops_per_device * f, t.hbm_bytes_per_device * f, t.coll_bytes_per_device * f, bd

    ef, eb, ec, ebd = scaled(edge, 1.0 / kappa1)
    cf, cb, cc, cbd = scaled(cloud, 1.0 / (kappa1 * kappa2))
    breakdown = dict(local.coll_breakdown)
    for d in (ebd, cbd):
        for k, v in d.items():
            breakdown[k] = breakdown.get(k, 0.0) + v
    return RooflineTerms(
        name=name,
        chips=local.chips,
        flops_per_device=local.flops_per_device + ef + cf,
        hbm_bytes_per_device=local.hbm_bytes_per_device + eb + cb,
        coll_bytes_per_device=local.coll_bytes_per_device + ec + cc,
        coll_breakdown=breakdown,
        model_flops_global=local.model_flops_global,
    )


# ---------------------------------------------------------------------------
# Empirical calibration against the fused edge interval (K3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CalibrationResult:
    name: str
    elapsed_s: float
    flops: float  # analytic work of one fused edge interval
    bytes_moved: float  # analytic minimal HBM traffic of the fused design
    peak_flops: float  # measured device peak (FLOP/s)
    peak_bw: float  # measured device peak (B/s)

    @property
    def achieved_flops(self) -> float:
        return self.flops / self.elapsed_s

    @property
    def achieved_bw(self) -> float:
        return self.bytes_moved / self.elapsed_s

    @property
    def flops_fraction(self) -> float:
        return self.achieved_flops / self.peak_flops

    @property
    def bw_fraction(self) -> float:
        return self.achieved_bw / self.peak_bw

    def to_dict(self) -> Dict:
        return {
            "name": self.name,
            "elapsed_s": self.elapsed_s,
            "flops": self.flops,
            "bytes_moved": self.bytes_moved,
            "peak_flops": self.peak_flops,
            "peak_bw": self.peak_bw,
            "achieved_flops": self.achieved_flops,
            "achieved_bw": self.achieved_bw,
            "flops_fraction": self.flops_fraction,
            "bw_fraction": self.bw_fraction,
        }


def _best_seconds(fn: Callable[[], object], device: torch.device, reps: int) -> float:
    """The fastest of ``reps`` calls of ``fn`` after one warm call: CUDA
    events around each call, after a synchronise and a zeroed
    ``FLUSH_BYTES`` buffer, on CUDA; the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
    best = float("inf")
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def measure_host_peaks(*, device: DeviceLike = None, n: int = 1024, reps: int = 5) -> Dict[str, float]:
    """Micro-probe the device: best-of-reps f32 (n, n) matmul (FLOP/s, TF32
    off) and streaming add over 8 n^2 floats (read + write B/s). On CUDA,
    n = 1024 cannot load an H100 (a 2 GFLOP product, a 32 MB add that sits
    in L2): callers pass a larger n there."""
    dev = resolve_device(device)  # also turns TF32 off
    a = torch.ones((n, n), dtype=torch.float32, device=dev)
    best = _best_seconds(lambda: a @ a, dev, reps)
    peak_flops = 2.0 * n**3 / best
    big = torch.ones((n * n * 8,), dtype=torch.float32, device=dev)
    best_c = _best_seconds(lambda: big + 1.0, dev, reps)
    peak_bw = 2.0 * big.numel() * big.element_size() / best_c
    return {"flops": peak_flops, "bw": peak_bw}


def megakernel_interval_cost(
    *, num_clients: int, kappa1: int, batch: int, feat: int, out: int, dtype_bytes: int = 4,
    momentum: bool = True,
) -> Dict[str, float]:
    """Analytic work/traffic of one fused edge interval (all edges).

    FLOPs per client per step: forward + backward matmuls (2·2·b·f·o) plus
    the momentum/param elementwise updates (~4·P with P = f·o); the trailing
    edge mean adds ~2·P per client. Minimal traffic is the fused design
    point: params and momentum cross HBM once in, once out, per client per
    *interval* (not per step), batches stream in once. With ``momentum``
    False the kernel neither reads nor writes momentum rows, so only the
    params' 2·P cross (JAX counts 4·P either way, its default here).
    """
    p = feat * out
    per_step = 4.0 * batch * feat * out + 4.0 * p
    flops = num_clients * (kappa1 * per_step + 2.0 * p)
    rows = 4.0 * p if momentum else 2.0 * p
    bytes_moved = float(dtype_bytes) * num_clients * (rows + kappa1 * batch * (feat + out))
    return {"flops": flops, "bytes": bytes_moved}


def calibrate_megakernel(
    *,
    num_edges: int = 2,
    clients_per_edge: int = 4,
    kappa1: int = 4,
    batch: int = 2,
    feat: int = 64,
    out: int = 128,
    momentum: float = 0.0,
    reps: int = 5,
    path: str = "ref",
    peaks: Optional[Dict[str, float]] = None,
    device: DeviceLike = None,
) -> CalibrationResult:
    """Time one fused edge interval and report achieved-vs-peak fractions.

    ``path="ref"`` times the plain version (``edge_interval_plain``, the
    same function in PyTorch ops); ``path="kernel"`` times K3 through
    ``kernels.ops.edge_interval`` (a CUDA device; on the CPU the entry
    point runs the plain version). The inputs are JAX's draws
    (``default_rng(0)``). The bytes count momentum rows only where
    ``momentum`` is nonzero (``megakernel_interval_cost``). ``peaks``
    defaults to ``measure_host_peaks`` on the same device.
    """
    from repro_torch.kernels import ops
    from repro_torch.kernels.megakernel import edge_interval_plain

    if path == "ref":
        step = edge_interval_plain
    elif path == "kernel":
        step = ops.edge_interval
    else:
        raise ValueError(f"path must be ref|kernel, got {path!r}")
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    n = num_edges * clients_per_edge
    p = feat * out
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    params = f32(rng.normal(size=(n, p)) * 0.05)
    xs = f32(rng.normal(size=(n, kappa1, batch, feat)))
    ys = f32(rng.normal(size=(n, kappa1, batch, out)))
    ws = f32(rng.uniform(1, 2, size=(n,)))
    mu = torch.zeros_like(params) if momentum else None
    run = lambda: step(params, xs, ys, ws, num_edges=num_edges, feat=feat, lr=0.05, momentum=momentum, mu=mu)
    best = _best_seconds(run, dev, reps)

    cost = megakernel_interval_cost(num_clients=n, kappa1=kappa1, batch=batch, feat=feat, out=out,
                                    momentum=bool(momentum))
    pk = peaks if peaks is not None else measure_host_peaks(device=dev)
    return CalibrationResult(
        name=f"edge_interval[{path}] E={num_edges} C={clients_per_edge} "
        f"k1={kappa1} b={batch} {feat}x{out}" + (f" momentum={momentum}" if momentum else ""),
        elapsed_s=best,
        flops=cost["flops"],
        bytes_moved=cost["bytes"],
        peak_flops=pk["flops"],
        peak_bw=pk["bw"],
    )


def model_flops(cfg, shape, *, active: bool = True) -> float:
    """6·N·D (train) / 2·N·D (forward-only), N = (active) params, D = tokens."""
    from repro_torch.configs.base import active_param_count, param_count

    n = active_param_count(cfg) if active else param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per request
    return 2.0 * n * shape.global_batch
