#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold its CUDA
kernels against their plain PyTorch versions.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases, one JSON line each; any failure exits non-zero:

  build       compile every CUDA source of the port with nvcc (sm_90a)
  kernels     K1 grouped_mean and K2 segment_mean against their plain
              versions on the card, at the main path's shapes (lm-100m's
              largest leaf and a norm among them; n1m_cohort4096's cloud
              root over 4096 rows, all four leaves, and its compacted edge
              stage with the prefetched segment table; one 4096-row
              segment; 70,000 groups, more than a grid's y dimension
              takes), f32 and bf16, with masked clients and a dead group;
              per case the schedule (one pass, or split into row chunks),
              the device kernels one call runs (profiler, against the
              schedule), a relaunch and an input one element off 16-byte
              alignment bit-equal to the first launch; times by CUDA events,
              beside one copy of the same rows (``copy_ms``), and the time
              the same timing gives one and two tiny kernels
  transport_kernels
              K4 quantize and K5 dequantize against their plain versions at
              the transport's leaf shapes, f32 and bf16, qblock 256 and 128,
              bit for bit (an all-zero block must get scale 0), plus a
              full-width leaf whose width is no multiple of 16 (32 x 262150)
              and 70,000 rows; which K5 path each case ran (16-byte
              vectors or scalar, read from the kernel's name in a profiler
              trace) must follow the shape; K6
              segment_dequant_mean against its plain version and against K5
              then K2, with masked clients and a dead group, also over
              70,000 ragged segments
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
  edge_interval_kernel
              K3 edge_interval against its plain version on the card: the
              JAX package's four test cases, kernel_bench's shape, the
              full-width case (32 clients, feat 64, out 1024) with momentum
              0 and 0.9 and with bf16 params and mu, a wide-feat case
              (the scratch-column path), an out that is no multiple of 32,
              16 and 12 clients per edge (rounds of 8 warps), kappa1 12 (the
              8-step ring wraps), kappa1 40 (loss partials stored every 32
              steps) and b 48 (a one-step ring); two launches
              bit for bit; one device kernel per call (profiler); how W and
              mu came in (``tma`` or ``lanes``), and where TMA ran, the same
              call with params and mu one element off alignment (lane loads)
              bit-equal to it and timed; the plain
              version one step short (kappa1 - 1) must fail the tolerance
              at full width; an all-zero-weight edge non-finite as in the
              plain version; times by CUDA events
  megakernel_vs_k3
              one cloud interval of the client-blocked lowering
              (``build_megakernel_super_round``) on linear MSE clients at
              K3's full-width case, against K3 through ``ops.edge_interval``
              (one edge, kappa2 1; four edges, kappa2 2); both timed
  mlp307k_megakernel
              ``mlp307k`` with ``run.engine=megakernel``: the client-blocked
              path must run (no fallback), K1 launches counted, losses
              against this call's mlp307k run and the same run on the CPU
  mlp307k_megakernel_bf16
              the same with bf16 client state: bf16 leaves, losses and
              accuracy against the f32 megakernel run, lower peak memory
  trimmed_edge
              the robust scenario (10%-trimmed edge sync under client
              failures) on cuda, then on the CPU: losses, accuracies and the
              survivors round by round agree; K1 runs every cloud sync with
              the round's mask
  median_cloud, trimmed_int8
              the coordinate-median cloud sync, and the trimmed edge sync over
              an int8 cloud hop (cut to 20 rounds), cuda then CPU; K1, K4 and
              K5 launch as counted
  mlp307k_robust
              the full-width MLP with a 25%-trimmed edge sync (2 of 8 dropped
              at each end), failures and stragglers: loss falls, accuracy
              within 0.05 of mlp307k; the run cut after its round-4
              checkpoint and resumed by a fresh runner ends bit-equal to the
              uninterrupted run; an outlier client (+1e3) moves the weighted
              edge mean but neither the trimmed mean nor the median
  n1m_cohort4096
              the population scenario uncut: 1,000,000 virtual clients on
              1000 edges of 1000, stratified cohorts of 4096, kappa (4, 2),
              8 rounds: every params leaf 4096 rows, the loss falls, K2 and
              K1 as counted (ragged cohort segments take K2, the cloud
              sync's root stage K1), the first cloud interval against the
              same on the CPU (its rounds' losses and grad norms, and the
              params after its cloud sync); the host time to draw and
              build one interval's cohort and block
  mlp307k_cohort
              the full-width MLP under sampled participation: 1024 virtual
              clients on 4 edges of 256, uniform cohorts of 32, Adam and
              int8 with error feedback on both hops (sticky rows: Adam's
              moments and the residual): K2, K1, K4 and K5 as counted, the
              store touched by exactly the clients drawn, the whole run
              against the CPU (losses, grad norms, the params after every
              interval, the store's touched rows, with a shifted-rows
              control that must fail), the store swap bit for bit on the
              card, the no-cohort control within the params tolerance; a
              run cut at its round-4 checkpoint and resumed bit-equal to
              the straight run (records, params, store); the warm wall
              with the prefetched K2 tables against the same run building
              them on the dispatch thread
  cohort_identity
              ``quickstart`` with round-robin cohorts of 20 (the whole
              population in order) against plain ``quickstart`` on the card:
              history and final params bit for bit, the same K1 launches
  deadline_barrier
              ``quickstart`` with the deadline engine at the full barrier
              (quorum 1.0) on the card against plain ``quickstart``: the
              engine is the DeadlineEngine, no interval gated, history
              (without ``wall_clock_s``) and final params bit for bit, the
              same K1 launches, the event clock strictly increasing
  deadline_scenarios
              ``deadline_straggler``, ``fedbuff_k4`` and ``stale_decay`` (20
              rounds, eval every 10) on the card, then on the CPU from the
              same init: losses and accuracies agree, final params within
              1e-4, ``wall_clock_s`` equal, at least one gated interval
              (the top stage's K1 over mask x gate), K1 as the synchronous
              run (88); the registered eval_every=1 refused in JAX's words
  deadline_ragged
              ``ragged_edges`` under a 60 % quorum with lognormal edge
              speeds: K2 under the gate, K2 80 and K1 8, at least one gated
              interval, the loss falls
  mlp307k_deadline
              ``deadline_straggler`` at the full-width MLP's shape (32
              clients on 4 edges, kappa (8, 2), 8 rounds): K1 48, the gated
              intervals counted (at least 1), the CPU run's losses,
              accuracies, params (1e-4) and wall clock; cut at its round-4
              checkpoint and resumed bit-equal to the straight run; warm
              profile and peak memory beside mlp307k's and beside the
              synchronous engine's under the same straggler masks (warm
              walls in turns, A B B A)
  attention_kernel
              K7 flash attention against its plain version on the card: the
              JAX package's test cases, kernel_bench's shape, the lm-100m
              prefill (GQA 12 on 4, hd 64, f32), the recurrentgemma-9b
              prefill (MQA 16 on 1, hd 256, window 2048, bf16) and the yi-9b
              prefill (GQA 32 on 4, hd 128, bf16); a relaunch bit for bit;
              which template ran (``tensor_core`` for bf16, ``cuda_core``
              for f32, read from the kernel's name in a profiler trace); max
              and RMS error; times beside the bound, the plain version and
              torch's scaled_dot_product_attention (a yardstick only)
  rglru_kernel
              K8 RG-LRU scan against its chunked plain version
              (``chunk=CHUNK``) bit for bit and across two launches, and
              within 1e-6 max(1, max|h|) of the sequential loop, while the
              chunked plain version with one chunk's carry zeroed must break
              that bound: the JAX test cases, chunk-boundary lengths (T - 1,
              T, T + 1, 3T + 7 at d 5 and 200, f32 and bf16),
              kernel_bench's shape, recurrentgemma-9b's (2 x 4096 x 4096,
              f32 and bf16) and a long prefill (2 x 32768 x 4096, bf16);
              every large case also through the element-load path (a and b
              one element off TMA's alignment, bit-equal and timed) and
              beside one elementwise add moving the same bytes
  train_lm10m
              ``lm_edge_niid`` (lm-10m, Adam with warmup-cosine, 8 clients on
              2 edges, kappa (4, 2)) for 8 rounds on cuda, then on the CPU
              from the same init: loss and grad_norm within LM_RTOL, wire_mb
              equal; K1 once per leaf per level mean, K7 and K8 never
  train_lm10m_int8_ef
              the same with error-feedback int8 (qblock 128) on both hops:
              K4 and K5 once per leaf per sync
  train_lm100m
              ``lm_edge_niid`` at lm-100m's full width (12 layers, d_model
              768, GQA 12 on 4, d_ff 2048; the scenario's vocabulary of 512)
              for 8 rounds on cuda: first-call wall, peak memory, every
              round's loss (finite, falling), K1 as counted and K7 = K8 = 0;
              one round on the CPU from the same init against the first
              round; then one warm cloud interval timed and profiled
  train_lm100m_robust
              one cloud interval of those settings with a coordinate-median
              edge sync and client failures, with remat off and on: device
              time per local step, peak memory, K1 at the cloud sync, K7 = K8
              = 0, remat's final params against the plain run's; the median
              and trimmed mean timed over the whole tree and on its largest
              leaf
  serve_lm100m
              ``repro_torch.launch.serve.serve`` on lm-100m at full width, f32,
              4 prompts of 1024 tokens, 32 generated: 12 K7 launches per
              prefill, none of K8; a 2 x 128 prefill on the card against the
              same on the CPU; decoding token P after prefill(P) against
              prefill(P + 1)
  serve_recurrentgemma9b
              the same on recurrentgemma-9b at full width (9.57B parameters,
              bf16), 2 prompts of 4096 tokens (the 2048-slot rings wrap), 16
              generated: 12 K7 and 26 K8 launches per prefill; the prefill
              with the kernels against the layer code on the card; decode
              consistency; a cut-depth f32 check of the K7/K8 route against
              the layer code; a warm prefill and decode step under
              torch.profiler

The quickstart, mlp307k, mlp307k_int8_ef, mlp307k_megakernel,
n1m_cohort4096, mlp307k_cohort, mlp307k_deadline and train_lm100m phases
then run their
scenario twice more, warm: once timed,
once under
``torch.profiler``, and report where the device time of a cloud interval
goes (by kernel class and top kernels) and the device's idle share.

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

T0 = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores (data sheet)
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate (data sheet)
MLP307K = [
    "data.dim=64", "model.hidden=4096", "topology.num_edges=4", "topology.clients_per_edge=8",
    "schedule.kappas=8,2", "run.num_rounds=8", "run.eval_every=2",
]
INT8_CLOUD = ["run.num_rounds=20", "run.eval_every=10"]
INT8_EF_BOTH = ["run.num_rounds=20"]
MEGAKERNEL = ["run.engine=megakernel"]
LM_TRAIN = ["run.num_rounds=8"]  # 32 local steps: the 20-step warmup, then the cosine
LM_INT8_EF = LM_TRAIN + ["transport.levels=int8_ef:128/int8_ef:128"]
LM100M = ["model.arch=lm-100m"]
# federated LM training, card against the CPU from the same init: per-round
# loss and grad_norm within LM_RTOL (the CPU tests hold the port to JAX at
# the same tolerance: tests/test_torch_lm_train.py)
LM_RTOL = 1e-4
BF16 = ["precision.param_dtype=bfloat16"]
# K3 at the engine's design geometry (N 32, E 4, kappa1 8, b 1) with the
# widest linear client the JAX kernel's own VMEM budget admits there
K3_FULL = dict(n=32, e=4, k1=8, b=1, feat=64, out=1024)
K3_RTOL, K3_ATOL = 3e-6, 5e-7  # the JAX kernel-vs-oracle tolerance
# kernel -> (the TPU kernel it replaces, its CUDA source)
KERNELS = {
    "grouped_mean": ("src/repro/kernels/hier_aggregate.py:56", "src/repro_torch/kernels/csrc/hier_aggregate.cu"),
    "segment_mean": ("src/repro/kernels/hier_aggregate.py:193", "src/repro_torch/kernels/csrc/hier_aggregate.cu"),
    "segment_dequant_mean": (
        "src/repro/kernels/hier_aggregate.py:132", "src/repro_torch/kernels/csrc/hier_aggregate.cu"),
    "quantize": ("src/repro/kernels/quantize.py:38", "src/repro_torch/kernels/csrc/quantize.cu"),
    "dequantize": ("src/repro/kernels/quantize.py:91", "src/repro_torch/kernels/csrc/quantize.cu"),
    "edge_interval": ("src/repro/kernels/megakernel.py:96", "src/repro_torch/kernels/csrc/megakernel.cu"),
    "flash_attention": (
        "src/repro/kernels/flash_attention.py:99", "src/repro_torch/kernels/csrc/flash_attention.cu"),
    "rglru_scan": ("src/repro/kernels/rglru_scan.py:44", "src/repro_torch/kernels/csrc/rglru_scan.cu"),
}
# K7 against its plain version: f32 both sum in f32 in other orders (|out|
# <= max |v| ~ 5); bf16 within ``flash_attention.bf16_tolerance`` of that,
# element by element: the tensor cores take P rounded to bf16 (2^-7 of the
# attention over |v|, row by row), and the two results round to bf16 apart
# (one ulp). bf16's RMS error within K7_BF16_RMS of the output's RMS: the
# roundings alone give about 2e-3, a window one key too wide about 8e-3 at
# recurrentgemma-9b's shape (the control, run on every windowed bf16 case)
K7_ATOL = 2e-5
K7_BF16_RMS = 5e-3
# the full-width serve checks: f32 card against CPU (and decode against a
# longer prefill) within K_F32 of the largest |logit|; bf16 within K_BF16 of
# it (bf16 rounds after every operation, in other places on the two routes)
K_F32, K_BF16 = 1e-4, 0.1
# K8's chunked order against the sequential loop: within this share of
# max(1, max|h|) (f32 rounding, composed over at most S / CHUNK carries)
K8_LOOP_TOL = 1e-6
# robustness: the trimmed edge sync at 0.25 drops 2 of 8 members at each end
# (at 0.1 an 8-client edge trims nothing), with failures and stragglers
ROBUST_MLP = ["aggregators.levels=trimmed_mean:0.25/weighted_mean", "failures.p_fail=0.1",
              "failures.straggler_sigma=0.3"]
# one cloud interval (2 rounds of kappa (4, 2)) of lm_edge_niid with a
# median edge sync under failures; remat's final params within
# REMAT_RTOL of the largest |param| of each leaf of the plain run's
LM_ROBUST = ["aggregators.levels=coordinate_median/weighted_mean", "failures.p_fail=0.1", "run.num_rounds=2"]
REMAT = ["precision.remat=true"]
REMAT_RTOL = 1e-6
CKPT_DIR = ROOT / "build" / "chip_smoke_checkpoints"  # removed when the phase ends
# the full-width MLP under sampled participation: 1024 virtual clients on 4
# edges of 256, uniform cohorts of 32 (mlp307k's own client count), with
# Adam's moments and the EF residual as sticky rows (3.7 MB a client)
COHORT_MLP = ["data.virtual_clients=1024", "data.samples_per_client=64", "topology.clients_per_edge=256",
              "participation.cohort_size=32", "participation.sampler=uniform", "model.optimizer=adam",
              "model.lr=1e-3", "transport.levels=int8_ef:128"]
# mlp307k_cohort against the CPU: per-round loss and grad norm within rtol
# 1e-4 (the grad norm with an atol of 1e-6 of the run's largest, since it
# falls by 17 orders once the loss underflows), final params within 1e-4,
# the scenario tolerance of tests/test_torch_runner.py: full-width Adam
# leaves the card and the CPU about as far apart with or without cohorts
# (the phase's control measures it)
COHORT_RTOL, COHORT_GNORM_ATOL, COHORT_PARAMS_ATOL = 1e-4, 1e-6, 1e-4
# its store's touched rows against the CPU's, relative to each leaf's
# largest |value|: Adam's moments within COHORT_STORE_RTOL, twice the gap
# of the no-cohort control's moments (9.5e-3 on an H100: as with the
# params, Adam parts the two devices with or without cohorts); of the EF
# residual's values at most COHORT_STORE_RES_SHARE further apart than
# COHORT_STORE_RES_RTOL (an int8 code that rounds the other way moves a
# value by a whole code step: 4-7 % of them on an H100). Another client's
# rows are 1.0 apart in the moments and about half their residual values
N1M_PARAMS_ATOL = 1e-5  # n1m's params after its first cloud sync, card vs CPU
COHORT_STORE_RTOL, COHORT_STORE_RES_RTOL, COHORT_STORE_RES_SHARE = 2e-2, 1e-3, 0.15
# round-robin cohorts of the whole quickstart population, in order
COHORT_IDENTITY = ["participation.cohort_size=20", "participation.sampler=round_robin"]
# the deadline engine: the full barrier; the registered scenarios' run
# (eval_every=1 is finer than their 10-round cloud interval, which the
# engine refuses, as JAX's does); a ragged tree under a partial quorum
DEADLINE_BARRIER = ["deadline.enabled=true", "deadline.quorum=1.0"]
DEADLINE_RUN = ["run.num_rounds=20", "run.eval_every=10"]
DEADLINE_RAGGED = DEADLINE_RUN + ["deadline.enabled=true", "deadline.quorum=0.6", "deadline.edge_speed=lognormal:0.5"]
DEADLINE_REFUSAL = "the deadline engine cannot run: eval_every=1 is finer than a cloud interval (kappa2_eff=10)"
DEADLINE_PARAMS_ATOL = 1e-4  # card vs CPU final params, the scenario tolerance of the CPU tests


def emit(obj) -> None:
    """One JSON line; a phase's line carries the seconds since the script
    started (``elapsed_s``), so a phase costs the difference to the last."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def flush_buffer(torch):
    """1 GiB to zero before each timed call: it evicts the 50 MB L2 (a sync
    sees cold parameters), and zeroing it keeps the device busy for about
    0.3 ms, longer than a wrapper's host work, so the start event is not
    recorded before the host has queued the kernel."""
    return torch.empty(256 * 2**20, dtype=torch.float32, device="cuda")


def time_ms(fn, *, flush, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events around each call,
    with ``flush`` (``flush_buffer``) zeroed before each."""
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


def reset_peak(torch) -> int:
    """Reset the peak-memory statistics; return the bytes allocated now, so
    that ``max_memory_allocated() - base`` is what the next run added on top
    of what earlier phases still hold."""
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def bf16_ulp(x):
    import torch

    mag = x.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def n1m_cohort_edge_stage():
    """The edge stage of one ``n1m_cohort4096`` cohort as the cohort engine
    builds it: the scenario's stratified draw of 4096 of its 1,000,000
    clients, the members' edge ids (quotas of 4 or 5 over 1000 edges),
    compacted by ``cohort_stages``. Ragged, so the engine takes K2 with the
    table ``stage_host_tables`` builds."""
    import numpy as np

    from repro_torch.core import aggregation
    from repro_torch.core.hierarchy import as_hierarchy
    from repro_torch.fed import scenarios

    spec = scenarios.get("n1m_cohort4096")
    hier = as_hierarchy(spec.topology.build())
    ids = spec.participation.build_sampler(hier).sample()
    edges = np.asarray(hier.segments(1), np.int64)[ids]
    stage = aggregation.cohort_stages(edges[None], ids.shape[0])[0]
    check(not stage.uniform, "n1m's cohort edge stage is not ragged")
    return stage


def kernel_cases():
    """(kernel, label, N, D, the group count, segment ids or a cohort
    ``Stage``) at the main path's shapes. A ``Stage`` is called as the
    cohort engine calls K2: with the ``offsets=`` table that
    ``stage_host_tables`` builds, uploaded."""
    import numpy as np

    ragged = np.repeat(np.arange(5), [16, 12, 10, 7, 5])
    # more segments than a grid's y dimension takes: 140,000 clients on
    # 70,000 edges of the quickstart MLP (its widest leaf), sizes 1, 3, 0, 4
    many = np.repeat(np.arange(70_000), np.tile([1, 3, 0, 4], 17_500))
    return [
        ("grouped_mean", "quickstart w1 edge (20x768, G=4)", 20, 768, 4),
        # n1m_cohort4096's cloud sync: its root stage over the cohort, all
        # four leaves (w1 16 x 48, b1 48, w2 48 x 10, b2 10)
        ("grouped_mean", "n1m cohort w1 cloud root (4096x768, G=1)", 4096, 768, 1),
        ("grouped_mean", "n1m cohort w2 cloud root (4096x480, G=1)", 4096, 480, 1),
        ("grouped_mean", "n1m cohort b1 cloud root (4096x48, G=1)", 4096, 48, 1),
        ("grouped_mean", "n1m cohort b2 cloud root (4096x10, G=1)", 4096, 10, 1),
        ("grouped_mean", "70,000 edges of 2 (140000x768, G=70000)", 140_000, 768, 70_000),
        ("grouped_mean", "mlp307k w1 edge (32x262144, G=4)", 32, 262144, 4),
        ("grouped_mean", "mlp307k w1 cloud (32x262144, G=1)", 32, 262144, 1),
        # lm_edge_niid's leaves at lm-100m: the final norm, and the stacked
        # MLP weight of 12 layers (8 x 12 x 768 x 2048, the largest leaf)
        ("grouped_mean", "lm-100m final_norm edge (8x768, G=2)", 8, 768, 2),
        ("grouped_mean", "lm-100m mlp w1 edge (8x18874368, G=2)", 8, 18874368, 2),
        ("grouped_mean", "lm-100m mlp w1 cloud (8x18874368, G=1)", 8, 18874368, 1),
        # n1m_cohort4096's edge sync and its cloud sync's first stage
        ("segment_mean", "n1m cohort w1 edges, compacted, offsets= (4096x768, G=1000)", 4096, 768,
         n1m_cohort_edge_stage()),
        ("segment_mean", "one tall segment (4096x768, G=1)", 4096, 768, np.zeros(4096, np.int64)),
        ("segment_mean", "70,000 ragged edges (140000x768)", 140_000, 768, many),
        ("segment_mean", "ragged 16,12,10,7,5 (50x262144)", 50, 262144, ragged),
    ]


def k1k2_schedule(ha, name, n, d, num, itemsize, table):
    """The schedule the wrapper runs (``hier_aggregate._schedule``) and its
    device kernels per call: 1 for one pass, 2 for a split."""
    if name == "grouped_mean":
        sched = ha._schedule(n // num, d, num, itemsize)
    else:
        sched = ha._segment_schedule(n, d, num, itemsize, ha.table_items(table.numel(), num))
    return sched._asdict(), sched.kernels


def phase_kernels(torch, ha):
    """K1 and K2 against their plain versions at the main path's shapes;
    per case the schedule, the device kernels one call runs (profiler,
    against the schedule's count), two launches and an input one element
    off 16-byte alignment (element loads) bit-equal to the first launch."""
    import numpy as np

    from repro_torch.core import aggregation

    flush = flush_buffer(torch)
    rng = np.random.default_rng(0)
    rows, summary = [], {}
    for name, label, n, d, groups in kernel_cases():
        offsets = None
        if isinstance(groups, aggregation.Stage):
            offsets = torch.from_numpy(aggregation.stage_host_tables(groups)[0]).cuda()
            groups = groups.ids
        ids = groups if name == "segment_mean" else np.repeat(np.arange(groups), n // groups)
        num = int(ids.max()) + 1
        if name == "segment_mean" and offsets is None:
            table = ha._device_table(ids.astype(np.int64).tobytes(), num, torch.device("cuda"))
        else:
            table = offsets
        kernel = (lambda x, w: ha.grouped_mean(x, w, num)) if name == "grouped_mean" else (
            lambda x, w: ha.segment_mean(x, w, ids, num, offsets=offsets))
        plain = (lambda x, w: ha.grouped_mean_plain(x, w, num)) if name == "grouped_mean" else (
            lambda x, w: ha.segment_mean_plain(x, w, ids, num))
        base = rng.uniform(0.5, 4.0, n).astype(np.float32)
        masked = base * (rng.random(n) > 0.3)
        firsts = np.searchsorted(ids, np.unique(ids))  # keep >= 1 survivor per (non-empty) group
        masked[firsts] = base[firsts]
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
                    sched, per_call = k1k2_schedule(ha, name, n, d, num, x.element_size(), table)
                    traced = traced_kernels(torch, lambda: kernel(x, w), "group_mean", want=per_call)
                    check(len(traced) == per_call, f"{name} {label} {dtype}: {len(traced)} device kernels a call "
                                                   f"({[t[:60] for t in traced]}), the schedule runs {per_call}")
                    check(bit_equal(kernel(x, w), got), f"{name} {label} {dtype}: a relaunch differs")
                    shifted = off_by_one(torch, x)
                    check(bit_equal(kernel(shifted, w), got),
                          f"{name} {label} {dtype}: an input off 16-byte alignment gives other bits")
                    del shifted
                    row.update(schedule=sched, device_kernels_per_call=len(traced), relaunch_bit_equal=True,
                               unaligned_bit_equal=True)
                    nbytes = 2 * x.numel() * x.element_size() + w.numel() * 4
                    row["ms"] = time_ms(lambda: kernel(x, w), flush=flush)
                    # a yardstick: one copy of x moves the same bytes in one kernel
                    dst = torch.empty_like(x)
                    row["copy_ms"] = time_ms(lambda: dst.copy_(x), flush=flush)
                    del dst
                    row["plain_ms"] = time_ms(lambda: plain(x, w), flush=flush)
                    row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
                    row["bound_by"] = "bytes"
                rows.append(row)
                if dtype == torch.float32:
                    s = summary.setdefault(name, {"max_abs_err": 0.0})
                    s["max_abs_err"] = max(s["max_abs_err"], err)
                    if variant == "weights":  # the last (largest) case of each kernel wins
                        s.update({k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}, case=label)
    # what this timing gives one and two tiny kernels: the floor under every
    # case above (a split runs two kernels a call)
    tiny = torch.zeros(16, device="cuda")
    floor = {"one_kernel_ms": time_ms(lambda: tiny.add_(1), flush=flush),
             "two_kernels_ms": time_ms(lambda: (tiny.add_(1), tiny.add_(1)), flush=flush)}
    emit({"phase": "kernels", "kernels": ["grouped_mean", "segment_mean"], "cases": rows, "timing_floor": floor})
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

    flush = flush_buffer(torch)
    rng = np.random.default_rng(1)
    rows, summary = [], {}
    for label, n, d in (("quickstart w1 (20x768)", 20, 768), ("b2 leaf (50x10)", 50, 10),
                        ("mlp307k w1 (32x262144)", 32, 262144), ("no 16 multiple (32x262150)", 32, 262150),
                        ("70,000 rows (70000x32)", 70000, 32)):
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
                kname = kernel_name(torch, lambda: qz.dequantize_stacked(q, s, d, dtype), "dequantize_kernel")
                path = "vector" if "dequantize_kernel_vec16" in kname else "scalar"
                check(path == ("vector" if d % 16 == 0 else "scalar"), f"dequantize {what}: took the {path} path")
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
                           **({"path": path} if name == "dequantize" else {}),
                           "max_abs_err": 0.0, "ms": time_ms(kernel, flush=flush),
                           "plain_ms": time_ms(plain, flush=flush), "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                           "bound_by": "bytes",
                           "library_ms": None if library is None else time_ms(library, flush=flush)}
                    rows.append(row)
                    if d == 262144 and qblock == 256 and dtype == torch.float32:  # the main path's largest leaf
                        summary[name] = {k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                             "bound_by", "library_ms")}
                        summary[name]["case"] = f"{label}, qblock {qblock}"

    k6 = summary.setdefault("segment_dequant_mean", {"max_abs_err": 0.0, "library_ms": None})
    ragged = np.repeat(np.arange(5), [16, 12, 10, 7, 5])
    many = np.repeat(np.arange(70_000), np.tile([1, 3, 0, 4], 17_500))  # beyond a grid's 65,535 y
    for label, n, d, ids in (("mlp307k w1 edge (32x262144, G=4)", 32, 262144, np.repeat(np.arange(4), 8)),
                             ("mlp307k w1 cloud (32x262144, G=1)", 32, 262144, np.zeros(32, np.int64)),
                             ("70,000 ragged edges (140000x768)", 140_000, 768, many),
                             ("ragged 16,12,10,7,5 (50x262144)", 50, 262144, ragged)):
        qblock = 256
        num = int(ids.max()) + 1
        q, s = qz.quantize_stacked(torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).cuda(), qblock)
        decoded = qz.dequantize_stacked(q, s, d)
        tol = 1e-5 * float(decoded.abs().max())
        base = rng.uniform(0.5, 4.0, n).astype(np.float32)
        masked = base * (rng.random(n) > 0.3)
        firsts = np.searchsorted(ids, np.unique(ids))  # keep >= 1 survivor per (non-empty) group
        masked[firsts] = base[firsts]
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


def k3_cases():
    """(label, N, E, kappa1, b, feat, out, momentum, dtype name)."""
    full = tuple(K3_FULL[k] for k in ("n", "e", "k1", "b", "feat", "out"))
    return [
        ("jax case 1", 8, 2, 3, 2, 4, 3, 0.0, "float32"),
        ("jax case 2", 16, 4, 2, 1, 8, 5, 0.9, "float32"),
        ("jax case 3", 8, 2, 4, 2, 6, 2, 0.9, "float32"),
        ("jax case 4 (one edge)", 8, 1, 2, 3, 4, 4, 0.0, "float32"),
        ("kernel_bench", 32, 4, 4, 2, 64, 128, 0.0, "float32"),
        ("full width", *full, 0.0, "float32"),
        ("full width", *full, 0.9, "float32"),
        ("full width", *full, 0.9, "bfloat16"),
        ("wide feat (scratch columns)", 8, 2, 3, 2, 512, 96, 0.9, "float32"),
        ("out not a multiple of 32", 16, 4, 3, 2, 32, 100, 0.9, "float32"),
        ("cpe 16 (two rounds of 8 clients)", 32, 2, 4, 1, 64, 256, 0.9, "float32"),
        ("cpe 12 (idle warps in the last round)", 24, 2, 3, 2, 16, 64, 0.0, "float32"),
        ("cpe 16, wide feat (scratch columns)", 32, 2, 2, 1, 96, 40, 0.9, "float32"),
        ("kappa1 12 (the 8-step ring wraps)", 8, 2, 12, 1, 16, 40, 0.9, "float32"),
        ("kappa1 40 (loss partials stored every 32 steps)", 8, 2, 40, 1, 16, 40, 0.9, "float32"),
        ("b 48 (a one-step ring)", 16, 2, 5, 48, 64, 64, 0.9, "float32"),
    ]


def k3_bound(n, k1, b, feat, out, mom, isz):
    """(bound ms, "bytes" or "operations") of one K3 call: each input read
    once and each output written once, against the f32 operations."""
    p = feat * out
    nbytes = 2 * n * p * isz * (2 if mom else 1) + n * k1 * b * (feat + out) * 4 + n * 4 + n * k1 * 4
    flops = n * k1 * (4 * b * feat * out + 3 * b * out + (5 if mom else 3) * feat * out) + 2 * n * p
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def k3_inputs(torch, rng, n, k1, b, feat, out, mom, dtype):
    import numpy as np

    p = feat * out
    params = torch.from_numpy((rng.normal(size=(n, p)) * 0.1).astype(np.float32)).to("cuda", dtype)
    x = torch.from_numpy(rng.normal(size=(n, k1, b, feat)).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.normal(size=(n, k1, b, out)).astype(np.float32)).cuda()
    w = torch.from_numpy(rng.uniform(1, 3, n).astype(np.float32)).cuda()
    mu = torch.from_numpy((rng.normal(size=(n, p)) * 0.01).astype(np.float32)).to("cuda", dtype) if mom else None
    return params, x, y, w, mu


TRACES_TAKEN_AGAIN = [0]  # short traces that showed no kernel and were taken again


def traced_kernels(torch, fn, needle: str, attempts: int = 5, want: int = 0) -> list:
    """The names of the device kernels holding ``needle`` that one call of
    ``fn`` ran, from a profiler trace (one entry per launch): ``fn`` runs
    once while the tracer warms up, unrecorded, then once recorded. The
    tracer can still lose a short window whole, or one of two kernels of a
    call (K1/K2's split), so a trace that shows no such kernel, or fewer
    than ``want``, is taken again, up to ``attempts`` traces of one call
    each; a kernel that never ran still shows none."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(attempts):
        names = []
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: names.extend(
                         e.name for e in p.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA and needle in e.name)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        if names and len(names) >= want:
            break
        TRACES_TAKEN_AGAIN[0] += 1
    return names


def off_by_one(torch, t):
    """A copy of ``t`` whose data starts one element past a 16-byte boundary
    (None stays None)."""
    if t is None:
        return None
    u = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return u.copy_(t)


def k3_err_over_tol(got, want, bf16: bool) -> float:
    """The largest |got - want| / tolerance over params and mu (K3's
    tolerance; bf16 rows plus one bf16 ulp)."""
    worst = 0.0
    for a, c in zip(got, want):
        a, c = a.float(), c.float()
        tol = K3_ATOL + K3_RTOL * c.abs()
        if bf16:
            tol = tol + bf16_ulp(c)
        worst = max(worst, float(((a - c).abs() / tol).max()))
    return worst


def phase_edge_interval_kernel(torch, mk):
    """K3 against its plain version on the same inputs, f32 at the JAX
    kernel's tolerance, bf16 at one bf16 ulp plus it; bit-equal across two
    launches; one device kernel per call (profiler); an all-zero-weight edge
    non-finite in both; on the full-width case, the plain version one step
    short (kappa1 - 1) must fail the tolerance."""
    import numpy as np

    flush = flush_buffer(torch)
    rng = np.random.default_rng(2)
    rows, summary = [], {"max_abs_err": 0.0, "library_ms": None}
    full_width, control = [], None
    for label, n, e, k1, b, feat, out, mom, dname in k3_cases():
        dtype = getattr(torch, dname)
        params, x, y, w, mu = k3_inputs(torch, rng, n, k1, b, feat, out, mom, dtype)
        kw = dict(num_edges=e, feat=feat, lr=0.1, momentum=mom, mu=mu)
        got = mk.edge_interval(params, x, y, w, **kw)
        again = mk.edge_interval(params, x, y, w, **kw)
        want = mk.edge_interval_plain(params, x, y, w, **kw)
        torch.cuda.synchronize()
        what = f"edge_interval {label} N{n} E{e} k1 {k1} b{b} {feat}x{out} momentum {mom} {dname}"
        check(all(bit_equal(a, c) for a, c in zip(got, again)), f"{what}: two launches differ")
        err = 0.0
        for name, a, c in zip(("params", "losses", "mu"), got, want):
            a, c = a.float(), c.float()
            tol = K3_ATOL + K3_RTOL * c.abs()
            if name != "losses" and dtype == torch.bfloat16:
                tol = tol + bf16_ulp(c)
            diff = (a - c).abs()
            check(bool(torch.isfinite(a).all()) and bool((diff <= tol).all()),
                  f"{what}: {name} max abs err {float(diff.max())} outside the tolerance")
            err = max(err, float(diff.max()))
        bound, bound_by = k3_bound(n, k1, b, feat, out, mom, params.element_size())
        row = {"kernel": "edge_interval", "case": label, "n": n, "edges": e, "kappa1": k1, "b": b, "feat": feat,
               "out": out, "momentum": mom, "dtype": dname, "path": "registers" if feat <= 64 else "scratch",
               "column_loads": mk.column_loads(params, x, num_edges=e, feat=feat, momentum=mom, mu=mu),
               "max_abs_err": err, "err_over_tol": k3_err_over_tol(got[::2], want[::2], dtype == torch.bfloat16),
               "bit_equal_relaunch": True,
               "ms": time_ms(lambda: mk.edge_interval(params, x, y, w, **kw), flush=flush),
               "plain_ms": time_ms(lambda: mk.edge_interval_plain(params, x, y, w, **kw), flush=flush, reps=5),
               "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        per_call = len(traced_kernels(torch, lambda: mk.edge_interval(params, x, y, w, **kw), "edge_interval"))
        check(per_call == 1, f"{what}: {per_call} edge_interval kernels in one call")
        row["kernel_launches_per_call"] = per_call
        if row["column_loads"] == "tma":  # the same call with one load per lane and row
            p1, mu1 = off_by_one(torch, params), off_by_one(torch, mu)
            kw1 = dict(kw, mu=mu1)
            check(mk.column_loads(p1, x, num_edges=e, feat=feat, momentum=mom, mu=mu1) == "lanes",
                  f"{what}: params one element off alignment still take TMA")
            check(all(bit_equal(a, c) for a, c in zip(mk.edge_interval(p1, x, y, w, **kw1), got)),
                  f"{what}: lane loads and TMA differ")
            row["ms_lane_loads"] = time_ms(lambda: mk.edge_interval(p1, x, y, w, **kw1), flush=flush)
        if label == "full width":
            # yardstick: copying the rows K3 reads and writes (params, and mu
            # with momentum), the most of its bytes
            rows_in = [params] + ([mu] if mom else [])
            rows_out = [torch.empty_like(t) for t in rows_in]
            row["copy_ms"] = time_ms(lambda: [o.copy_(i) for o, i in zip(rows_out, rows_in)], flush=flush)
            full_width.append({k: row.get(k) for k in ("momentum", "dtype", "column_loads", "ms", "ms_lane_loads",
                                                       "copy_ms", "plain_ms", "bound_ms", "bound_share")})
            if mom and dtype == torch.float32:  # the control: one step short must fail the tolerance
                short = mk.edge_interval_plain(params, x[:, : k1 - 1], y[:, : k1 - 1], w, **kw)
                control = k3_err_over_tol(got[::2], short[::2], False)
                check(control > 1.0, f"{what}: the plain version with kappa1 - 1 steps is within the tolerance "
                      f"({control} of it): the check has no teeth")
                row["control_kappa1_minus_1_err_over_tol"] = control
        rows.append(row)
        if dtype == torch.float32:
            summary["max_abs_err"] = max(summary["max_abs_err"], err)
            if label == "full width" and mom:
                summary.update({k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                               case=f"{label}, momentum {mom}")
    check(control is not None, "edge_interval: the kappa1 - 1 control did not run")
    # an edge whose weights are all zero: no zero guard, as in JAX
    n, e, k1, b, feat, out = 8, 2, 3, 2, 4, 3
    params, x, y, w, mu = k3_inputs(torch, rng, n, k1, b, feat, out, 0.9, torch.float32)
    w[: n // e] = 0.0
    kw = dict(num_edges=e, feat=feat, lr=0.1, momentum=0.9, mu=mu)
    got, want = mk.edge_interval(params, x, y, w, **kw)[0], mk.edge_interval_plain(params, x, y, w, **kw)[0]
    check(not bool(torch.isfinite(got[: n // e]).any()) and not bool(torch.isfinite(want[: n // e]).any()),
          "edge_interval: an all-zero-weight edge must give non-finite rows in kernel and plain version")
    live = (got[n // e:] - want[n // e:]).abs()
    check(bool((live <= K3_ATOL + K3_RTOL * want[n // e:].abs()).all()), "edge_interval: live edge next to a dead one")
    rows.append({"kernel": "edge_interval", "case": "all-zero-weight edge", "dead_rows_non_finite": True,
                 "live_max_abs_err": float(live.max())})
    emit({"phase": "edge_interval_kernel", "kernels": ["edge_interval"], "tolerance": {
        "rtol": K3_RTOL, "atol": K3_ATOL, "bf16": "plus one bf16 ulp of the plain result"},
        "full_width": full_width,
        "control_kappa1_minus_1_err_over_tol": control, "cases": rows})
    return {"edge_interval": summary}


def phase_megakernel_vs_k3(torch, mods, mk):
    """One cloud interval of the client-blocked lowering on linear MSE
    clients ({"w"} (feat, out), loss mean((x w - y)^2)) against K3 through
    its entry point: one edge with kappa2 1 (one K3 call) and four edges
    with kappa2 2 (K3 over the edges, then over all clients). Returns the
    phase's launch counts: K3's are its entry-point launches."""
    import numpy as np

    from repro_torch import resolve_device
    from repro_torch.core.hierfavg import FedTopology, HierFAVGConfig, build_megakernel_super_round, init_state
    from repro_torch.kernels import ops
    from repro_torch.optim import sgd

    resolve_device("cuda")  # TF32 off for the lowering's products
    flush = flush_buffer(torch)
    n, k1, b, feat, out = (K3_FULL[k] for k in ("n", "k1", "b", "feat", "out"))
    lr = 0.1
    rng = np.random.default_rng(3)

    def loss_fn(p, batch, _rng):
        return torch.mean(torch.square(batch["x"] @ p["w"] - batch["y"]))

    w0 = torch.from_numpy((rng.normal(size=(feat, out)) * 0.1).astype(np.float32)).cuda()
    weights = torch.from_numpy(rng.uniform(1, 3, n).astype(np.float32)).cuda()
    report, counted = {}, {}
    for edges, k2 in ((1, 1), (4, 2)):
        topo, config = FedTopology(edges, n // edges), HierFAVGConfig(kappa1=k1, kappa2=k2)
        batches = {"x": torch.from_numpy(rng.normal(size=(k2, k1, n, b, feat)).astype(np.float32)).cuda(),
                   "y": torch.from_numpy(rng.normal(size=(k2, k1, n, b, out)).astype(np.float32)).cuda()}
        mega = build_megakernel_super_round(loss_fn, sgd(lr), topo, config, weights)
        fresh = lambda: init_state(torch.Generator(device="cuda").manual_seed(0), {"w": w0}, sgd(lr), topo, config)
        for m in mods:
            m.reset_launch_counts()
        state, metrics = mega(fresh(), batches)
        start = fresh().params["w"].reshape(n, feat * out)
        k3_params = start
        k3_losses = []
        schedule = (1,) if k2 == 1 else (edges, 1)
        for j, groups in enumerate(schedule):  # edge rounds, then the cloud round
            xs, ys = (batches[k][j].transpose(0, 1).contiguous() for k in ("x", "y"))
            k3_params, losses, _ = ops.edge_interval(k3_params, xs, ys, weights, num_edges=groups, feat=feat, lr=lr)
            k3_losses.append(torch.mean(losses))
        torch.cuda.synchronize()
        launches = {k: v for m in mods for k, v in m.LAUNCHES.items()}
        check(launches["edge_interval"] == k2 and launches["grouped_mean"] == k2,
              f"megakernel_vs_k3 E{edges} launches {launches}")
        for k, v in launches.items():
            counted[k] = counted.get(k, 0) + v
        got = state.params["w"].reshape(n, feat * out)
        diff = (got - k3_params).abs()
        check(bool((diff <= K3_ATOL + K3_RTOL * k3_params.abs()).all()),
              f"megakernel_vs_k3 E{edges}: params max abs err {float(diff.max())}")
        loss_err = float((metrics["loss"] - torch.stack(k3_losses)).abs().max())
        check(bool(torch.allclose(metrics["loss"], torch.stack(k3_losses), rtol=K3_RTOL, atol=K3_ATOL)),
              f"megakernel_vs_k3 E{edges}: losses {metrics['loss'].tolist()} vs {torch.stack(k3_losses).tolist()}")

        def k3_interval():
            p = start
            for j, groups in enumerate(schedule):
                xs, ys = (batches[k][j].transpose(0, 1).contiguous() for k in ("x", "y"))
                p = mk.edge_interval(p, xs, ys, weights, num_edges=groups, feat=feat, lr=lr)[0]

        timing_state = fresh()
        report[f"E{edges}_kappa2_{k2}"] = {
            "params_max_abs_err": float(diff.max()), "loss_max_abs_err": loss_err, "launches": launches,
            "megakernel_ms": time_ms(lambda: mega(timing_state, batches), flush=flush, reps=5),
            "k3_ms": time_ms(k3_interval, flush=flush, reps=10),
        }
    emit({"phase": "megakernel_vs_k3", "case": dict(K3_FULL, lr=lr), "tolerance": {"rtol": K3_RTOL, "atol": K3_ATOL},
          **report})
    return counted


def run_scenario(torch, mods, name, overrides, device, params=None, profiler=None, resume=False, spy=None):
    """Build, init and run a scenario; returns (runner, state, seconds,
    launches, params) with the launch counts of every kernel module in
    ``mods`` reset just before the run and read just after it, so they count
    this run only. ``profiler`` (a ``torch.profiler.profile``) wraps
    ``runner.run`` alone. ``resume`` starts from the latest checkpoint of
    ``run.checkpoint_dir`` (``restore_or_init``). ``spy(runner)`` is called
    after the init (``spy_cohort_engine``)."""
    from repro_torch.fed import scenarios

    spec = scenarios.get(name, overrides=overrides)
    runner = spec.build(device=device)
    if params is None:
        params = spec.init_params(spec.run.seed + 1, "cpu")
    rng = torch.Generator(device=device).manual_seed(spec.run.seed)
    state, start = runner.restore_or_init(rng, params) if resume else (runner.init(rng, params), 0)
    if spy is not None:
        spy(runner)
    if device == "cuda":
        torch.cuda.synchronize()
    for m in mods:
        m.reset_launch_counts()
    with profiler if profiler is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        state = runner.run(state, start_round=start)
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = {k: v for m in mods for k, v in m.LAUNCHES.items()}
    return runner, state, seconds, launches, params


def history_agreement(runner, ref_runner, what, prefix):
    """Per-round losses within rtol 1e-4 and accuracies within 0.01 of
    ``ref_runner``'s, checked. A round whose reference loss is exactly 0
    (the full-width MLP separates its data and the cross-entropy
    underflows) is held to |loss| <= 1e-6 instead."""
    check(len(runner.history) == len(ref_runner.history) == runner.cfg.num_rounds, f"{what} rounds")
    pairs = [(a.loss, b.loss) for a, b in zip(runner.history, ref_runner.history)]
    loss_rel = max((abs(a - b) / abs(b) for a, b in pairs if b != 0), default=0.0)
    zero_loss = max((abs(a) for a, b in pairs if b == 0), default=0.0)
    acc_gap = max((abs(a.accuracy - b.accuracy) for a, b in zip(runner.history, ref_runner.history)
                   if a.accuracy is not None), default=0.0)
    check(loss_rel <= 1e-4, f"{what} loss rel err {loss_rel}")
    check(zero_loss <= 1e-6, f"{what}: loss {zero_loss} where the reference loss is 0")
    check(acc_gap <= 0.01, f"{what} accuracy gap {acc_gap}")
    return {f"{prefix}_loss_max_rel_err": loss_rel, f"{prefix}_zero_loss_rounds": sum(b == 0 for _, b in pairs),
            f"{prefix}_loss_max_where_zero": zero_loss, f"{prefix}_accuracy_max_gap": acc_gap}


def cpu_agreement(torch, mods, runner, name, overrides, params):
    """The same run on the CPU (plain versions) from the same init, held to
    ``history_agreement``."""
    cpu_runner, *_ = run_scenario(torch, mods, name, overrides, "cpu", params=params)
    return history_agreement(runner, cpu_runner, f"{name} cuda vs cpu", "cpu")


def resident_clients(runner) -> int:
    """The clients a local step trains: the cohort under sampled
    participation, else every client."""
    return runner.participation.cohort_size if runner.participation is not None else runner.topology.num_clients


def path_report(runner, seconds, launches, extra=None):
    hier = runner.hier_config
    steps = runner.cfg.num_rounds * hier.kappa1
    out = {
        "rounds": len(runner.history),
        "seconds": seconds,
        "client_steps_per_s": resident_clients(runner) * steps / seconds,
        "launches": launches,
        "loss_first": runner.history[0].loss,
        "loss_last": runner.history[-1].loss,
        "accuracy": [h.accuracy for h in runner.history if h.accuracy is not None],
    }
    out.update(extra or {})
    return out


def kernel_class(name: str) -> str:
    if "group_mean_kernel" in name or "group_mean_finish_kernel" in name:  # K1 and K2 share both
        return "aggregation (K1/K2)"
    if "quantize_kernel" in name:  # K4 quantize_kernel, K5 dequantize_kernel and dequantize_kernel_vec16
        return "transport codec (K4/K5)"
    if "segment_dequant_mean_kernel" in name:
        return "fused decode-mean (K6)"
    if "edge_interval" in name:
        return "fused edge interval (K3)"
    if "flash_attention" in name:  # flash_attention_kernel (f32) and flash_attention_wgmma (bf16)
        return "flash attention (K7)"
    if "rglru_chunked_kernel" in name:
        return "RG-LRU scan (K8)"
    low = name.lower()
    if "gemm" in low or "gemv" in low or "cutlass" in low or "matmul" in low or "nvjet" in low:
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
    swap = {} if runner.participation is None else {
        "warm_host_swap_ms_per_interval": runner._engine.swap_seconds * 1e3 / intervals}
    return {
        "cloud_intervals": intervals,
        "warm_wall_ms_per_interval": warm_s * 1e3 / intervals,
        **swap,
        "warm_client_steps_per_s": resident_clients(runner) * runner.cfg.num_rounds
        * runner.hier_config.kappa1 / warm_s,
        "profiled_wall_ms_per_interval": window_s * 1e3 / intervals,
        "device_busy_ms_per_interval": busy_us / 1e3 / intervals,
        "device_busy_share_of_warm_wall": busy_us / 1e6 / warm_s,
        "device_idle_share_profiled": 1.0 - busy_us / 1e6 / window_s,
        "device_ops_per_interval": len(events) / intervals,
        "busy_ms_per_interval_by_class": {k: v / 1e3 / intervals for k, v in sorted(by_class.items())},
        "top_kernels_ms_per_interval": [[n[:90], v / 1e3 / intervals] for n, v in top],
    }


def attention_cases():
    """(label, B, S, H, Hkv, hd, window, dtype name); K7 is causal on every
    path of the port."""
    cases = [(f"jax case s{s} window {w}", 3, s, 1, 1, 64, w, dt)
             for s, w in ((128, 0), (200, 0), (256, 33), (120, 64)) for dt in ("float32", "bfloat16")]
    return cases + [
        ("kernel_bench (4 x 1024 x 64)", 4, 1024, 1, 1, 64, 0, "bfloat16"),
        ("lm-100m prefill", 4, 1024, 12, 4, 64, 0, "float32"),
        ("recurrentgemma-9b prefill", 2, 4096, 16, 1, 256, 2048, "bfloat16"),
        ("yi-9b prefill", 1, 4096, 32, 4, 128, 0, "bfloat16"),
    ]


def visible_pairs(s: int, window: int) -> int:
    """(query, key) pairs of a causal self-attention of length s that a
    window (0: none) leaves visible."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def k7_bound(b, s, h, hkv, hd, window, isz):
    """(bound ms, "bytes" or "operations") of one K7 call: q, k, v read once
    and out written once at the HBM rate, against 4 hd operations per visible
    pair per query head at the tensor cores' bf16 rate (bf16) or the f32 rate
    without TF32 (f32)."""
    nbytes = (2 * b * s * h * hd + 2 * b * s * hkv * hd) * isz
    flops = 4 * hd * visible_pairs(s, window) * b * h
    rate = BF16_FLOPS_PER_S if isz == 2 else F32_FLOPS_PER_S
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def sdpa_call(torch, q, k, v, window):
    """torch's scaled_dot_product_attention on (B, H, S, hd) copies of K7's
    inputs (causal, or a boolean band mask for a window; GQA by
    ``enable_gqa``): a yardstick for K7's time that the port never calls.
    Returns a callable giving (B, H, S, hd)."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if window > 0:
        i = torch.arange(q.shape[1], device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)


def kernel_name(torch, fn, needle: str) -> str:
    """The name of the one device kernel containing ``needle`` that a call
    of ``fn`` ran, from a profiler trace."""
    names = set(traced_kernels(torch, fn, needle))
    check(len(names) == 1, f"one {needle} kernel per call, got {sorted(names)}")
    return names.pop()


def k7_path(torch, fn) -> str:
    """Which K7 template one call ran: ``tensor_core`` or ``cuda_core``."""
    return "tensor_core" if "flash_attention_wgmma" in kernel_name(torch, fn, "flash_attention") else "cuda_core"


def rms_rel(got, want) -> float:
    return float((got.float() - want.float()).pow(2).mean().sqrt() / want.float().pow(2).mean().sqrt())


def phase_attention_kernel(torch, fa):
    """K7 against its plain version on the same inputs (``K7_ATOL``; bf16
    within ``bf16_tolerance`` and ``K7_BF16_RMS``, which the plain version
    with a window one key too wide must fail), bit-equal across two
    launches, on the template its dtype names (one profiled call per
    dtype: ``fa_forward`` picks the template by dtype alone)."""
    import numpy as np

    flush = flush_buffer(torch)
    rng = np.random.default_rng(4)
    rows, summary, paths = [], {}, {}
    for label, b, s, h, hkv, hd, window, dname in attention_cases():
        dtype = getattr(torch, dname)
        q, k, v = (torch.from_numpy(rng.normal(size=(b, s, n, hd)).astype(np.float32)).to("cuda", dtype)
                   for n in (h, hkv, hkv))
        got = fa.attention(q, k, v, causal=True, window=window)
        again = fa.attention(q, k, v, causal=True, window=window)
        want = fa.attention_plain(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        what = f"flash_attention {label} {dname}"
        check(bit_equal(got, again), f"{what}: two launches differ")
        diff = (got.float() - want.float()).abs()
        rms = rms_rel(got, want)
        control = None
        if dtype == torch.bfloat16:
            tol = fa.bf16_tolerance(q, k, v, got, want, K7_ATOL, causal=True, window=window)
            check(rms <= K7_BF16_RMS, f"{what}: RMS error {rms} of the output's RMS > {K7_BF16_RMS}")
            if window > 0:
                wide = fa.attention_plain(q, k, v, causal=True, window=window + 1)
                wide_tol = fa.bf16_tolerance(q, k, v, wide, want, K7_ATOL, causal=True, window=window)
                control = {"max_err_over_tol": float(((wide.float() - want.float()).abs() / wide_tol).max()),
                           "rms_err_rel": rms_rel(wide, want)}
                check(control["max_err_over_tol"] > 1 and control["rms_err_rel"] > K7_BF16_RMS,
                      f"{what}: the control (window + 1) passes the checks: {control}")
                del wide, wide_tol
        else:
            tol = K7_ATOL
        check(bool(torch.isfinite(got).all()) and bool((diff <= tol).all()),
              f"{what}: max err {float((diff / tol).max())} of the tolerance")
        if dname not in paths:
            paths[dname] = k7_path(torch, lambda: fa.attention(q, k, v, causal=True, window=window))
        path = paths[dname]
        want_path = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
        check(path == want_path, f"{what}: ran the {path} template, want {want_path}")
        library = sdpa_call(torch, q, k, v, window)
        lib_err = float((library().transpose(1, 2).float() - want.float()).abs().max())
        bound, bound_by = k7_bound(b, s, h, hkv, hd, window, q.element_size())
        big = s >= 4096
        row = {"kernel": "flash_attention", "case": label, "b": b, "s": s, "h": h, "hkv": hkv, "hd": hd,
               "window": window, "dtype": dname, "path": path, "max_abs_err": float(diff.max()),
               "rms_err_rel": rms, "max_err_over_tol": float((diff / tol).max()), "control_window_plus_1": control,
               "bit_equal_relaunch": True,
               "visible_pairs_per_head": visible_pairs(s, window),
               "ms": time_ms(lambda: fa.attention(q, k, v, causal=True, window=window), flush=flush,
                             reps=10 if big else 25),
               "plain_ms": time_ms(lambda: fa.attention_plain(q, k, v, causal=True, window=window), flush=flush,
                                   reps=5, warmup=1),
               "bound_ms": bound, "bound_by": bound_by,
               "library_ms": time_ms(library, flush=flush, reps=10 if big else 25),
               "library_max_abs_err": lib_err}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        if label.startswith("recurrentgemma"):
            summary["flash_attention"] = {k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                               "library_ms")}
        del q, k, v, got, again, want, diff
    emit({"phase": "attention_kernel", "kernels": ["flash_attention"], "tolerance": {
        "atol": K7_ATOL, "bf16": "atol + 2^-7/(1-2^-8) attention_plain(q, k, |v|) + one bf16 ulp of the larger "
        "result, per element", "bf16_rms_rel": K7_BF16_RMS}, "cases": rows})
    return summary


def rglru_zeroed_carry(torch, rg, a, b, h0):
    """The control for K8: the chunked plain version with the carry into
    chunk 1 zeroed (h0 itself when one chunk covers the sequence). From a
    zero carry, chunks 1.. compose as a fresh scan from step CHUNK."""
    t = rg.CHUNK
    if a.shape[1] <= t:
        return rg.rglru_scan_plain(a, b, torch.zeros_like(h0), chunk=t)[0]
    head = rg.rglru_scan_plain(a[:, :t], b[:, :t], h0, chunk=t)[0]
    return torch.cat([head, rg.rglru_scan_plain(a[:, t:], b[:, t:], torch.zeros_like(h0), chunk=t)[0]], dim=1)


def phase_rglru_kernel(torch, rg):
    """K8 against its chunked plain version (bit for bit, and across two
    launches), within K8_LOOP_TOL max(1, max|h|) of the sequential loop, and
    the zeroed-carry control beyond that bound."""
    flush = flush_buffer(torch)
    gen = torch.Generator(device="cuda").manual_seed(5)
    t = rg.CHUNK
    cases = [("jax case", 2, 33, 96, "float32"), ("jax case", 2, 128, 128, "float32"),
             ("jax case", 2, 64, 200, "float32"), ("jax case, bf16 a and b", 2, 128, 128, "bfloat16")]
    cases += [("chunk boundary", 2, s, d, dname) for s in (t - 1, t, t + 1, 3 * t + 7) for d in (5, 200)
              for dname in ("float32", "bfloat16")]
    cases += [("kernel_bench", 2, 8192, 256, "float32"), ("recurrentgemma-9b prefill", 2, 4096, 4096, "float32"),
              ("recurrentgemma-9b prefill, bf16 a and b", 2, 4096, 4096, "bfloat16"),
              ("long prefill, bf16 a and b", 2, 32768, 4096, "bfloat16")]
    rows, summary = [], {}
    for label, b, s, d, dname in cases:
        dtype = getattr(torch, dname)
        a = (torch.rand(b, s, d, generator=gen, device="cuda") * 0.299 + 0.7).to(dtype)
        bb = (torch.randn(b, s, d, generator=gen, device="cuda") * 0.1).to(dtype)
        h0 = torch.randn(b, d, generator=gen, device="cuda")
        h, h_last = rg.rglru_scan(a, bb, h0)
        h2, h_last2 = rg.rglru_scan(a, bb, h0)
        hp, h_lastp = rg.rglru_scan_plain(a, bb, h0, chunk=t)
        loop = rg.rglru_scan_plain(a, bb, h0)[0]
        control = rglru_zeroed_carry(torch, rg, a, bb, h0)
        torch.cuda.synchronize()
        what = f"rglru_scan {label} {b}x{s}x{d} {dname}"
        check(bit_equal(h, h2) and bit_equal(h_last, h_last2), f"{what}: two launches differ")
        err = max(float((h - hp).abs().max()), float((h_last - h_lastp).abs().max()))
        check(bit_equal(h, hp) and bit_equal(h_last, h_lastp), f"{what}: differs from the chunked plain version, "
                                                                 f"err {err}")
        check(bit_equal(h_last, h[:, -1]), f"{what}: hT is not h[:, -1]")
        tol = K8_LOOP_TOL * max(1.0, float(loop.abs().max()))
        loop_err = float((h - loop).abs().max())
        control_err = float((control - loop).abs().max())
        check(loop_err <= tol, f"{what}: {loop_err} from the sequential loop, over {tol}")
        check(control_err > tol, f"{what}: the zeroed-carry control ({control_err}) stays within {tol}")
        nbytes = 2 * b * s * d * a.element_size() + b * s * d * 4 + 2 * b * d * 4
        row = {"kernel": "rglru_scan", "case": label, "b": b, "s": s, "d": d, "dtype": dname, "chunk": t,
               "max_abs_err": err, "bit_equal_plain": True, "bit_equal_relaunch": True,
               "loop_max_abs_err": loop_err, "loop_tolerance": tol, "control_max_abs_err": control_err,
               "ms": time_ms(lambda: rg.rglru_scan(a, bb, h0), flush=flush),
               "plain_ms": time_ms(lambda: rg.rglru_scan_plain(a, bb, h0, chunk=t), flush=flush, reps=3, warmup=1),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        if s >= 4096:
            # a yardstick of the card's rate for this traffic: one elementwise
            # add that reads a and b and writes h's bytes (not K8's function)
            z = torch.empty_like(h)
            row["same_bytes_add_ms"] = time_ms(lambda: torch.add(a, bb, out=z), flush=flush)
            del z
            # the element-load path at the same shape: a and b one element
            # off the 16-byte alignment that TMA needs
            ua, ub = (torch.empty(x.numel() + 1, dtype=dtype, device="cuda")[1:].view_as(x).copy_(x) for x in (a, bb))
            check(bit_equal(rg.rglru_scan(ua, ub, h0)[0], h), f"{what}: the element-load path differs")
            row["ms_element_loads"] = time_ms(lambda: rg.rglru_scan(ua, ub, h0), flush=flush)
            del ua, ub
        rows.append(row)
        if label == "recurrentgemma-9b prefill":
            summary["rglru_scan"] = {k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                          "library_ms")}
        del a, bb, h, h2, hp, loop, control
    emit({"phase": "rglru_kernel", "kernels": ["rglru_scan"],
          "tolerance": f"bit-equal to rglru_scan_plain(chunk={t}) and across two launches; within "
                       f"{K8_LOOP_TOL} max(1, max|h|) of the sequential loop, which the plain version with the "
                       f"carry into chunk 1 zeroed (h0 where one chunk covers S) must exceed", "cases": rows})
    return summary


def max_err(got, want):
    """(max |got - want|, max |want|) in f32 on the host."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()), float(want.abs().max())


def counted_serve(torch, mods, cfg, params, **kw):
    """``serve.serve`` with every launch count set to 0 just before and read
    just after; returns (serve's report, launches)."""
    from repro_torch.launch import serve

    torch.cuda.synchronize()
    for m in mods:
        m.reset_launch_counts()
    out = serve.serve(cfg, device="cuda", params=params, **kw)
    return out, {k: v for m in mods for k, v in m.LAUNCHES.items()}


def serve_report(out, warm, launches):
    keep = ("prefill_s", "prefill_tokens_per_s", "decode_s", "decode_tokens_per_s")
    return {"launches": launches, **{f"first_{k}": out[k] for k in keep}, **{f"warm_{k}": warm[k] for k in keep},
            "sample_ids": out["tokens"][:, -1].tolist()}


def check_launches(launches, want, what):
    """Every count as in ``want`` and every other kernel's at 0."""
    check(all(launches[k] == want.get(k, 0) for k in launches), f"{what} launches {launches}, want {want}")


def phase_serve_lm100m(torch, mods):
    """lm-100m at full width (f32) through the serving entry point, then
    against the CPU and against a longer prefill."""
    from torch.utils._pytree import tree_map

    from repro_torch.configs.base import param_count
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    cfg = get_config("lm-100m")
    B, P, G = 4, 1024, 32
    base = reset_peak(torch)
    with torch.no_grad():
        params = transformer.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    out, launches = counted_serve(torch, mods, cfg, params, batch=B, prompt_len=P, gen=G)
    peak = torch.cuda.max_memory_allocated() - base
    check_launches(launches, {"flash_attention": 12}, "serve_lm100m")
    check(tuple(out["tokens"].shape) == (B, G) and bool(torch.isfinite(out["prefill_logits"]).all()),
          "serve_lm100m: tokens or logits")
    warm, _ = counted_serve(torch, mods, cfg, params, batch=B, prompt_len=P, gen=G)

    # the same prefill on the card (K7) and on the CPU (layer code), same init
    x = torch.from_numpy(serve.make_prompts(cfg, 2, 129, seed=1))
    with torch.inference_mode():
        card, caches = transformer.prefill(params, cfg, x[:, :128].cuda(), 160)
        cpu, _ = transformer.prefill(tree_map(lambda t: t.cpu(), params), cfg, x[:, :128], 160)
        cpu_err, scale = max_err(card, cpu)
        check(cpu_err <= K_F32 * scale, f"serve_lm100m: card vs CPU logits err {cpu_err} (scale {scale})")
        dec, _ = transformer.decode_step(params, cfg, caches, x[:, 128].cuda(),
                                         torch.full((2,), 128, dtype=torch.int32, device="cuda"))
        longer, _ = transformer.prefill(params, cfg, x.cuda(), 160)
        dec_err, dec_scale = max_err(dec, longer)
        check(dec_err <= K_F32 * dec_scale, f"serve_lm100m: decode vs prefill(P+1) err {dec_err}")
    emit({"phase": "serve_lm100m", "arch": cfg.name, "params": param_count(cfg), "dtype": "float32",
          "batch": B, "prompt_len": P, "gen": G, **serve_report(out, warm, launches),
          "launches_per_prefill": {"flash_attention": 12, "rglru_scan": 0}, "peak_memory_bytes": peak,
          "card_vs_cpu": {"batch": 2, "prompt_len": 128, "max_abs_err": cpu_err, "max_abs_logit": scale,
                          "tolerance": f"{K_F32} x max |logit|"},
          "decode_vs_prefill": {"position": 128, "max_abs_err": dec_err, "max_abs_logit": dec_scale}})
    return launches


def lm_launches(runner, state, syncs_compressed: int) -> dict:
    """What a federated LM run must launch: K1 once per leaf per level mean
    (an edge sync is one stage, the cloud sync of the two-level tree two),
    K4 and K5 once per leaf per compressed sync, nothing else."""
    from repro_torch.tree import leaves

    n_leaves = len(list(leaves(state.params)))
    intervals = runner.cfg.num_rounds // runner.hier_config.kappa2_effective
    want = {"grouped_mean": n_leaves * 3 * intervals}  # kappa (4, 2): one edge and one cloud sync an interval
    if syncs_compressed:
        want.update(quantize=n_leaves * syncs_compressed, dequantize=n_leaves * syncs_compressed)
    return want


def lm_agreement(runner, ref, what, rounds=None):
    """Per-round loss and grad_norm within LM_RTOL of ``ref``'s (its first
    ``rounds`` records), wire_mb equal; checked."""
    rounds = len(ref.history) if rounds is None else rounds
    pairs = list(zip(runner.history[:rounds], ref.history[:rounds]))
    check(len(pairs) == rounds == len(ref.history[:rounds]), f"{what}: rounds")
    loss_rel = max(abs(a.loss - b.loss) / abs(b.loss) for a, b in pairs)
    gnorm_rel = max(abs(a.grad_norm - b.grad_norm) / abs(b.grad_norm) for a, b in pairs)
    check(loss_rel <= LM_RTOL and gnorm_rel <= LM_RTOL, f"{what}: loss rel err {loss_rel}, grad_norm {gnorm_rel}")
    check(all(a.wire_mb == b.wire_mb for a, b in pairs), f"{what}: wire_mb differs")
    return {"loss_max_rel_err": loss_rel, "grad_norm_max_rel_err": gnorm_rel, "rounds": rounds,
            "tolerance": {"rtol": LM_RTOL}}


def params_max_err(state, ref_state) -> float:
    from repro_torch.tree import leaves

    return max(float((a.float().cpu() - b.float().cpu()).abs().max())
               for a, b in zip(leaves(state.params), leaves(ref_state.params)))


def phase_train_lm10m(torch, mods, phase, overrides):
    """``lm_edge_niid`` (lm-10m) for 8 rounds on the card and on the CPU
    from the same init; launch counts asserted."""
    import math

    compressed = any(o.startswith("transport.levels=") for o in overrides)
    t0 = time.perf_counter()
    runner, state, secs, launches, params = run_scenario(torch, mods, "lm_edge_niid", overrides, "cuda")
    want = lm_launches(runner, state, runner.cfg.num_rounds if compressed else 0)
    check_launches(launches, want, phase)
    losses = [h.loss for h in runner.history]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], f"{phase}: losses {losses}")
    cpu_runner, cpu_state, cpu_secs, *_ = run_scenario(torch, mods, "lm_edge_niid", overrides, "cpu", params=params)
    agreement = lm_agreement(runner, cpu_runner, f"{phase} cuda vs cpu")
    emit({"phase": phase, **path_report(runner, secs, launches, {
        "arch": runner.spec.model.arch, "transport": runner.spec.transport.levels, "launches_want": want,
        "losses": losses, "grad_norms": [h.grad_norm for h in runner.history],
        "wire_mb": runner.history[-1].wire_mb, "cpu": agreement, "cpu_seconds": cpu_secs,
        "params_max_abs_err_vs_cpu": params_max_err(state, cpu_state),
        "phase_seconds": time.perf_counter() - t0})})
    return launches


def phase_train_lm100m(torch, mods):
    """``lm_edge_niid`` at lm-100m's full width: 8 rounds on the card, one on
    the CPU against the first, then one warm cloud interval profiled."""
    import math

    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    base = reset_peak(torch)
    runner, state, secs, launches, params = run_scenario(torch, mods, "lm_edge_niid", LM100M + LM_TRAIN, "cuda")
    peak = torch.cuda.max_memory_allocated() - base
    want = lm_launches(runner, state, 0)
    check_launches(launches, want, "train_lm100m")
    n_params = sum(x[0].numel() for x in leaves(state.params))
    check(n_params == 76_303_104, f"train_lm100m has {n_params} parameters per client")
    check(tuple(state.params["blocks"]["b0"]["mlp"]["w1"].shape) == (8, 12, 768, 2048), "train_lm100m mlp w1 shape")
    losses = [h.loss for h in runner.history]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], f"train_lm100m losses {losses}")
    check(all(bool(torch.isfinite(x).all()) for x in leaves(state.params)), "train_lm100m params not finite")
    del state
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    cpu_runner, *_ = run_scenario(torch, mods, "lm_edge_niid", LM100M + ["run.num_rounds=1"], "cpu", params=params)
    cpu_s = time.perf_counter() - t1
    agreement = lm_agreement(runner, cpu_runner, "train_lm100m round 0 cuda vs cpu", rounds=1)
    profile = device_profile(torch, mods, "lm_edge_niid", LM100M + ["run.num_rounds=2"], params)
    emit({"phase": "train_lm100m", **path_report(runner, secs, launches, {
        "arch": runner.spec.model.arch, "params_per_client": n_params, "clients": runner.topology.num_clients,
        "tokens_per_local_step": runner.topology.num_clients * runner.spec.data.batch_size * runner.spec.data.seq_len,
        "launches_want": want, "losses": losses, "grad_norms": [h.grad_norm for h in runner.history],
        "first_call_wall_s": secs, "peak_memory_bytes": peak, "cpu_round0": agreement, "cpu_round0_seconds": cpu_s,
        "profile": profile, "phase_seconds": time.perf_counter() - t0})})
    return launches


def phase_robust_scenario(torch, mods, name, overrides, want):
    """A robust scenario on the card, then on the CPU from the same init:
    per-round losses and accuracies within ``history_agreement``'s
    tolerances, the survivors round by round equal, launches as in
    ``want``."""
    runner, state, secs, launches, params = run_scenario(torch, mods, name, overrides, "cuda")
    check_launches(launches, want, name)
    check(all(bool(torch.isfinite(v).all()) for v in state.params.values()), f"{name} params not finite")
    check(runner.history[-1].loss < runner.history[0].loss, f"{name} loss did not fall")
    cpu_runner, *_ = run_scenario(torch, mods, name, overrides, "cpu", params=params)
    agreement = history_agreement(runner, cpu_runner, f"{name} cuda vs cpu", "cpu")
    alive = [h.mask_alive for h in runner.history]
    check(alive == [h.mask_alive for h in cpu_runner.history], f"{name}: survivors differ from the CPU run's")
    masked = runner.failures is not None or runner.stragglers is not None
    if masked:
        check(min(alive) < runner.topology.num_clients, f"{name}: no client ever failed: {alive}")
    emit({"phase": name, **path_report(runner, secs, launches, {
        **agreement, "aggregators": runner.hier_config.aggregators.describe(), "mask_alive": alive,
        # with a failure model every sync takes the round's mask
        "k1_masked_launches": launches["grouped_mean"] if masked else 0,
        "transport": runner.hier_config.transport.describe() if runner.hier_config.transport else "identity",
        "final_accuracy": runner.history[-1].accuracy})})
    return launches


def phase_mlp307k_robust(torch, mods, mlp_params, uncompressed_accuracy):
    """The full-width MLP with a 25%-trimmed edge sync, failures and
    stragglers; a cut-and-resumed run against the straight one, bit for bit;
    the outlier control on its final client models."""
    import shutil

    import numpy as np

    from repro_torch.core import aggregation
    from repro_torch.core.hierarchy import as_hierarchy

    straight = MLP307K + ROBUST_MLP + ["run.checkpoint_every=4", f"run.checkpoint_dir={CKPT_DIR / 'straight'}"]
    cut = MLP307K + ROBUST_MLP + ["run.checkpoint_every=4", f"run.checkpoint_dir={CKPT_DIR / 'cut'}"]
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        runner, state, secs, launches, _ = run_scenario(torch, mods, "hierfavg_edge_iid", straight, "cuda", mlp_params)
        check_launches(launches, {"grouped_mean": 4 * 2 * 4}, "mlp307k_robust")  # 4 cloud syncs, 2 stages, 4 leaves
        check(all(bool(torch.isfinite(v).all()) for v in state.params.values()), "mlp307k_robust params not finite")
        check(runner.history[-1].loss < runner.history[0].loss, "mlp307k_robust loss did not fall")
        acc = runner.history[-1].accuracy
        check(abs(acc - uncompressed_accuracy) <= 0.05, f"mlp307k_robust accuracy {acc} vs {uncompressed_accuracy}")
        alive = [h.mask_alive for h in runner.history]
        check(min(alive) < 32, f"mlp307k_robust: no client ever failed: {alive}")
        run_scenario(torch, mods, "hierfavg_edge_iid", cut + ["run.num_rounds=4"], "cuda", mlp_params)
        resumed, r_state, r_secs, r_launches, _ = run_scenario(torch, mods, "hierfavg_edge_iid", cut, "cuda",
                                                               mlp_params, resume=True)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    fields = lambda h: (h.round, h.step, h.loss, h.grad_norm, h.mask_alive, h.accuracy)
    check([h.round for h in resumed.history] == list(range(4, 8)), "mlp307k_robust resume: rounds")
    check([fields(h) for h in resumed.history] == [fields(h) for h in runner.history[4:]],
          "mlp307k_robust resume: the records differ from the uninterrupted run's")
    check(all(bit_equal(r_state.params[k], state.params[k]) for k in state.params),
          "mlp307k_robust resume: final params differ from the uninterrupted run's")

    # the control: client 3's rows + 1e3 before an edge sync (edge 0 holds
    # clients 0-7): the weighted mean of its edge moves by at least
    # 1e3 * w_3 / sum(w); the trimmed mean and the median stay within the
    # range of the other members
    spec = as_hierarchy(runner.topology)
    w = runner.weights
    x = {"w1": state.params["w1"].reshape(32, -1).clone()}
    x["w1"][3] += 1e3
    others = torch.cat([state.params["w1"].reshape(32, -1)[:3], state.params["w1"].reshape(32, -1)[4:8]])
    lo, hi = others.min(0).values, others.max(0).values
    moved = aggregation.hierarchical_segment_mean(x, w, spec, 1)["w1"][0] - aggregation.hierarchical_segment_mean(
        {"w1": state.params["w1"].reshape(32, -1)}, w, spec, 1)["w1"][0]
    want_move = 1e3 * float(w[3] / w[:8].sum())
    check(float(moved.min()) >= want_move * (1 - 1e-4), f"control: weighted mean moved {float(moved.min())}")
    inside = {}
    for agg in (aggregation.TrimmedMeanAggregator(0.25), aggregation.CoordinateMedianAggregator()):
        out = agg(x, w, spec, 1)["w1"][0]
        inside[agg.name] = bool(((out >= lo) & (out <= hi)).all())
        check(inside[agg.name], f"control: {agg.name} left the range of the other members")
    torch.cuda.synchronize()
    emit({"phase": "mlp307k_robust", **path_report(runner, secs, launches, {
        "aggregators": runner.hier_config.aggregators.describe(), "mask_alive": alive,
        "k1_masked_launches": launches["grouped_mean"], "final_accuracy": acc,
        "uncompressed_final_accuracy": uncompressed_accuracy,
        "resume": {"from_round": 4, "records_equal": True, "params_bit_equal": True, "seconds": r_secs,
                   "launches": r_launches},
        "control": {"client": 3, "plus": 1e3, "weighted_mean_min_move": float(moved.min()),
                    "want_at_least": want_move, "inside_other_members_range": inside}})})
    return launches


def drawn_ids(runner):
    """The distinct ids a fresh copy of the run's sampler draws over the
    run's cloud intervals (the cohorts the run trained)."""
    import numpy as np

    from repro_torch.core.hierarchy import as_hierarchy

    sampler = runner.participation.build_sampler(as_hierarchy(runner.topology))
    intervals = runner.cfg.num_rounds // runner.hier_config.kappa2_effective
    return np.unique(np.concatenate([sampler.sample() for _ in range(intervals)]))


def spy_cohort_engine(runner, params_after):
    """Give ``runner`` a ``CohortEngine`` that appends a host copy of the
    params to ``params_after`` after each cloud interval and checks its
    store swap bit for bit: after ``_load_cohort`` the state's sticky rows
    are the store's rows of the sampled ids, and after ``_writeback`` the
    store's rows of those ids are the state's rows."""
    import numpy as np
    import torch

    from repro_torch.fed.client_store import sticky_rows
    from repro_torch.fed.engine import CohortEngine
    from repro_torch.tree import leaves

    engine = CohortEngine(runner)
    load, writeback, step = engine._load_cohort, engine._writeback, engine._super
    c = engine.cohort_size

    def same_rows(state, ids, what):
        rows = [(x.view(torch.int16) if x.dtype == torch.bfloat16 else x).cpu().numpy()
                for x in leaves(sticky_rows(state, c))]
        check(all(np.array_equal(a, b) for a, b in zip(rows, leaves(runner.client_store.gather(ids)))),
              f"{what}: the state's sticky rows are not the store's rows of the cohort")

    def spied_load(state, ids):
        load(state, ids)
        same_rows(state, ids, "after _load_cohort")

    def spied_writeback(state, ids):
        writeback(state, ids)
        same_rows(state, ids, "after _writeback")

    def spied_step(state, *args):
        state, metrics = step(state, *args)
        params_after.append({k: v.detach().cpu().clone() for k, v in state.params.items()})
        return state, metrics

    engine._load_cohort, engine._writeback, engine._super = spied_load, spied_writeback, spied_step
    runner._engine = engine


def store_rows_agreement(state, cohort_size, store, ref_store, ids, ref_ids=None):
    """Two runs' stores at the rows ``ids`` (of ``ref_store``: ``ref_ids``,
    by default the same), leaf by leaf, relative to the reference leaf's
    largest |value|: the optimizer rows' largest difference, and for each
    residual leaf (the share of values further apart than
    COHORT_STORE_RES_RTOL of it, the largest difference): an int8 code that
    rounds the other way moves a residual by a whole code step."""
    import numpy as np

    from repro_torch.fed.client_store import sticky_rows

    n_opt = len(sticky_rows(state, cohort_size)["opt"])
    opt, res = [], []
    for i, (a, b) in enumerate(zip(store.state()["leaves"], ref_store.state()["leaves"])):
        a, b = a[ids].astype(np.float64), b[ids if ref_ids is None else ref_ids].astype(np.float64)
        scale = float(np.abs(b).max()) or 1.0
        err = np.abs(a - b) / scale
        if i < n_opt:
            opt.append(float(err.max()))
        else:
            res.append((float((err > COHORT_STORE_RES_RTOL).mean()), float(err.max())))
    return opt, res


def offsets_miss_cost(torch, mods, overrides, params):
    """What the prefetched K2 tables save: the warm wall per interval of
    the run as it is against the same run with its stages' tables taken
    out, so that ``segment_mean`` builds and uploads each one itself
    (``_device_table``, its cache cleared first; a uniform cohort's ids
    change every interval, so each interval misses), in the order A B B A;
    and the host time of one such miss on an idle device."""
    import numpy as np

    from repro_torch.core import aggregation
    from repro_torch.kernels import hier_aggregate as ha

    upload = aggregation.stages_to_device
    without = lambda *a, **k: tuple(st._replace(offsets=None) for st in upload(*a, **k))
    walls, misses = {"prefetched": [], "built_on_dispatch": []}, 0
    for mode in ("prefetched", "built_on_dispatch", "built_on_dispatch", "prefetched"):
        ha._device_table.cache_clear()
        aggregation.stages_to_device = without if mode == "built_on_dispatch" else upload
        try:
            runner, _, secs, *_ = run_scenario(torch, mods, "hierfavg_edge_iid", overrides, "cuda", params)
        finally:
            aggregation.stages_to_device = upload
        walls[mode].append(secs * 1e3 / (runner.cfg.num_rounds // runner.hier_config.kappa2_effective))
        misses += ha._device_table.cache_info().misses if mode == "built_on_dispatch" else 0
    ha._device_table.cache_clear()
    one = []
    for k in range(20):
        ids = np.sort(np.random.default_rng(k).integers(0, 4, 32))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ha._device_table(ids.tobytes(), 4, torch.device("cuda"))
        one.append((time.perf_counter() - t0) * 1e3)
    ha._device_table.cache_clear()
    return {"warm_wall_ms_per_interval": walls, "misses_in_two_runs": misses,
            "one_miss_host_ms_idle_device": statistics.median(one)}


def phase_n1m_cohort4096(torch, mods):
    """``n1m_cohort4096`` uncut on the card, its first cloud interval on the
    CPU. Launches: the stratified quotas (4 or 5 of each 1000-client edge)
    are ragged, so the edge sync and the cloud sync's first stage take K2
    once per leaf (4 leaves each) and the cloud sync's root stage K1: 8 K2
    and 4 K1 an interval, 4 intervals."""
    from repro_torch.core import aggregation
    from repro_torch.core.hierarchy import as_hierarchy

    base = reset_peak(torch)
    runner, state, secs, launches, params = run_scenario(torch, mods, "n1m_cohort4096", (), "cuda")
    peak = torch.cuda.max_memory_allocated() - base
    check_launches(launches, {"segment_mean": 32, "grouped_mean": 16}, "n1m_cohort4096")
    check(all(v.shape[0] == 4096 for v in state.params.values()), "n1m_cohort4096: a params leaf is not 4096 rows")
    check(all(bool(torch.isfinite(v).all()) for v in state.params.values()), "n1m_cohort4096 params not finite")
    check(runner.history[-1].loss < runner.history[0].loss, "n1m_cohort4096 loss did not fall")
    cpu_runner, cpu_state, *_ = run_scenario(torch, mods, "n1m_cohort4096", ["run.num_rounds=2"], "cpu", params)
    agreement = lm_agreement(runner, cpu_runner, "n1m_cohort4096 cuda vs cpu, first cloud interval")
    # the params after that interval's cloud sync (K2 over the compacted
    # edges with the prefetched table, K1 at the root), which neither the
    # loss nor the grad norm of its rounds sees
    _, synced, *_ = run_scenario(torch, mods, "n1m_cohort4096", ["run.num_rounds=2"], "cuda", params)
    synced_err = params_max_err(synced, cpu_state)
    check(synced_err <= N1M_PARAMS_ATOL, f"n1m_cohort4096 params after the first cloud sync: {synced_err} from the CPU's")
    agreement.update(params_max_abs_err_after_first_cloud_sync=synced_err, params_atol=N1M_PARAMS_ATOL)
    del cpu_runner, cpu_state, synced
    # the host work of one interval's cohort and block, as the prefetch
    # worker does it (the run is over, so its batcher may move on)
    sampler = runner.participation.build_sampler(as_hierarchy(runner.topology))
    table = runner._engine._segments_table()
    t0 = time.perf_counter()
    ids = sampler.sample()
    t1 = time.perf_counter()
    runner.batcher.next_batches_for(ids, 8)
    t2 = time.perf_counter()
    aggregation.cohort_stages(table[:, ids], ids.shape[0])
    t3 = time.perf_counter()
    distinct = drawn_ids(runner)
    emit({"phase": "n1m_cohort4096", **path_report(runner, secs, launches, {
        "cpu_agreement": agreement, "cohort_size": 4096, "virtual_clients": runner.topology.num_clients,
        "params_leading_dims": sorted({int(v.shape[0]) for v in state.params.values()}),
        "peak_memory_bytes": peak, "client_store_num_touched": runner.client_store.num_touched,
        "client_store_is_empty": runner.client_store.is_empty, "distinct_clients_drawn": int(distinct.shape[0]),
        "host_ms_one_interval": {"sample": (t1 - t0) * 1e3, "virtual_batches": (t2 - t1) * 1e3,
                                 "cohort_stages": (t3 - t2) * 1e3},
        "profile": device_profile(torch, mods, "n1m_cohort4096", (), params)})})
    return launches


def phase_mlp307k_cohort(torch, mods, mlp_params):
    """The full-width MLP under sampled participation, against the CPU, and
    cut-and-resumed against straight. Launches: every uniform cohort of 32
    over the 4 edges is ragged, so per interval the edge sync and the cloud
    sync's first stage take K2 once per leaf (8) and the root stage K1 (4);
    int8_ef on both hops: K4 and K5 once per leaf per sync (2 syncs x 4
    leaves); 4 intervals."""
    import shutil

    import numpy as np

    from repro_torch.fed.client_store import sticky_rows

    overrides = MLP307K + COHORT_MLP
    want = {"segment_mean": 32, "grouped_mean": 16, "quantize": 32, "dequantize": 32}
    base = reset_peak(torch)
    runner, state, secs, launches, _ = run_scenario(torch, mods, "hierfavg_edge_iid", overrides, "cuda", mlp_params)
    peak = torch.cuda.max_memory_allocated() - base
    check_launches(launches, want, "mlp307k_cohort")
    check(all(bool(torch.isfinite(v).all()) for v in state.params.values()), "mlp307k_cohort params not finite")
    check(tuple(state.params["w1"].shape) == (32, 64, 4096), "mlp307k_cohort w1 shape")
    check(runner.history[-1].loss < runner.history[0].loss, "mlp307k_cohort loss did not fall")
    distinct = drawn_ids(runner)
    store = runner.client_store
    check(store.num_touched == distinct.shape[0], f"store touched {store.num_touched}, drawn {distinct.shape[0]}")
    check(bool(np.array_equal(np.flatnonzero(store.state()["touched"]), distinct)), "store touched other clients")
    first_swap_ms = runner._engine.swap_seconds * 1e3 / 4
    # the same run spied on the card and on the CPU: the swap bit for bit
    # (spy_cohort_engine), the params after every interval and the store's
    # touched rows against the CPU's
    card_params, cpu_params = [], []
    spied, spied_state, *_ = run_scenario(torch, mods, "hierfavg_edge_iid", overrides, "cuda", mlp_params,
                                          spy=lambda r: spy_cohort_engine(r, card_params))
    cpu_runner, cpu_state, *_ = run_scenario(torch, mods, "hierfavg_edge_iid", overrides, "cpu", mlp_params,
                                             spy=lambda r: spy_cohort_engine(r, cpu_params))
    check(all(bit_equal(spied_state.params[k], state.params[k]) for k in state.params),
          "mlp307k_cohort: the spied card run differs from the first")
    agreement = history_agreement(runner, cpu_runner, "mlp307k_cohort cuda vs cpu", "cpu")
    check(len(card_params) == len(cpu_params) == 4, "mlp307k_cohort: params after 4 intervals")
    interval_err = [max(float((a[k] - b[k]).abs().max()) for k in a) for a, b in zip(card_params, cpu_params)]
    check(max(interval_err) <= COHORT_PARAMS_ATOL, f"mlp307k_cohort params vs cpu by interval: {interval_err}")
    opt_err, res_off = store_rows_agreement(spied_state, 32, spied.client_store, cpu_runner.client_store, distinct)
    check(max(opt_err) <= COHORT_STORE_RTOL, f"mlp307k_cohort store: optimizer rows {opt_err} of the leaf's largest")
    check(max(share for share, _ in res_off) <= COHORT_STORE_RES_SHARE,
          f"mlp307k_cohort store: residual values off {res_off}")
    # the store comparison's control: the CPU's rows of the next drawn
    # client in place of each client's own must fail it
    shifted_opt, shifted_res = store_rows_agreement(spied_state, 32, spied.client_store, cpu_runner.client_store,
                                                    distinct, np.roll(distinct, 1))
    check(min(shifted_opt) > COHORT_STORE_RTOL and min(share for share, _ in shifted_res) > COHORT_STORE_RES_SHARE,
          f"mlp307k_cohort store control: other clients' rows pass ({shifted_opt}, {shifted_res})")
    del spied, spied_state, card_params, cpu_params
    # the loss underflows to 0 by round 3 and the gradient norm falls from
    # ~1e3 to ~1e-14, so the grad norms are held as allclose with an atol
    # of COHORT_GNORM_ATOL times the run's largest
    gnorms = [(a.grad_norm, b.grad_norm) for a, b in zip(runner.history, cpu_runner.history)]
    g_atol = COHORT_GNORM_ATOL * max(b for _, b in gnorms)
    gnorm_excess = max(abs(a - b) / (COHORT_RTOL * abs(b) + g_atol) for a, b in gnorms)
    params_err = params_max_err(state, cpu_state)
    check(gnorm_excess <= 1.0 and params_err <= COHORT_PARAMS_ATOL,
          f"mlp307k_cohort vs cpu: grad_norm at {gnorm_excess} of its tolerance, params {params_err}")
    del cpu_runner, cpu_state
    # the control: the same optimizer and codec without participation (the
    # 32 clients of mlp307k), card against CPU; Adam moves a coordinate
    # whose gradient is near zero by about lr whatever its size, so the two
    # devices' roundings part by this much with or without cohorts
    control = MLP307K + [o for o in COHORT_MLP if o.startswith(("model.", "transport."))]
    _, c_state, *_ = run_scenario(torch, mods, "hierfavg_edge_iid", control, "cuda", mlp_params)
    _, c_cpu_state, *_ = run_scenario(torch, mods, "hierfavg_edge_iid", control, "cpu", mlp_params)
    control_err = params_max_err(c_state, c_cpu_state)
    control_opt = [float((a.cpu() - b).abs().max() / (b.abs().max() or 1.0))
                   for a, b in zip(sticky_rows(c_state, 32)["opt"], sticky_rows(c_cpu_state, 32)["opt"])]
    check(control_err <= COHORT_PARAMS_ATOL and max(control_opt) <= COHORT_STORE_RTOL,
          f"mlp307k_cohort control (no cohorts) vs cpu: params {control_err}, optimizer rows {control_opt}")
    del c_state, c_cpu_state

    ckpt = ["run.checkpoint_every=4", f"run.checkpoint_dir={CKPT_DIR / 'cohort'}"]
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        run_scenario(torch, mods, "hierfavg_edge_iid", overrides + ckpt + ["run.num_rounds=4"], "cuda", mlp_params)
        cut_s = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size for f in CKPT_DIR.rglob("*") if f.is_file())
        resumed, r_state, r_secs, r_launches, _ = run_scenario(torch, mods, "hierfavg_edge_iid", overrides + ckpt,
                                                               "cuda", mlp_params, resume=True)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    fields = lambda h: (h.round, h.step, h.loss, h.grad_norm, h.mask_alive, h.accuracy, h.wire_mb)
    check([h.round for h in resumed.history] == list(range(4, 8)), "mlp307k_cohort resume: rounds")
    check([fields(h) for h in resumed.history] == [fields(h) for h in runner.history[4:]],
          "mlp307k_cohort resume: the records differ from the uninterrupted run's")
    check(all(bit_equal(r_state.params[k], state.params[k]) for k in state.params),
          "mlp307k_cohort resume: final params differ from the uninterrupted run's")
    a, b = store.state(), resumed.client_store.state()
    check(bool(np.array_equal(a["touched"], b["touched"])), "mlp307k_cohort resume: touched clients differ")
    check(all(bool(np.array_equal(x[distinct], y[distinct])) for x, y in zip(a["leaves"], b["leaves"])),
          "mlp307k_cohort resume: store rows differ")
    torch.cuda.synchronize()
    emit({"phase": "mlp307k_cohort", **path_report(runner, secs, launches, {
        **agreement, "cpu_grad_norm_share_of_tolerance": gnorm_excess,
        "cpu_grad_norm_max_rel_err": max(abs(a - b) / abs(b) for a, b in gnorms if b),
        "cpu_grad_norms": [b for _, b in gnorms], "params_max_abs_err_vs_cpu": params_err,
        "control_no_cohort_params_max_abs_err_vs_cpu": control_err,
        "control_no_cohort_opt_rows_max_err_of_leaf_max": control_opt,
        "params_max_abs_err_vs_cpu_by_interval": interval_err, "swap_bit_equal_on_card": True,
        "store_vs_cpu": {"opt_max_err_of_leaf_max": opt_err, "residual_share_off_and_max_err": res_off,
                         "control_other_clients_rows": {"opt": shifted_opt, "residual": shifted_res}},
        "tolerance": {"loss_rtol": 1e-4, "grad_norm_rtol": COHORT_RTOL, "grad_norm_atol_of_max": COHORT_GNORM_ATOL,
                      "params_atol": COHORT_PARAMS_ATOL, "store_opt_rtol_of_leaf_max": COHORT_STORE_RTOL,
                      "store_residual_rtol_of_leaf_max": COHORT_STORE_RES_RTOL,
                      "store_residual_share_off": COHORT_STORE_RES_SHARE},
        "transport": runner.hier_config.transport.describe(), "final_accuracy": runner.history[-1].accuracy,
        "peak_memory_bytes": peak, "client_store_num_touched": store.num_touched,
        "distinct_clients_drawn": int(distinct.shape[0]), "client_store_logical_bytes": store.nbytes,
        "sticky_bytes_per_client": sum(x[0].nbytes for x in a["leaves"]),
        "first_run_host_swap_ms_per_interval": first_swap_ms,
        "resume": {"from_round": 4, "records_equal": True, "params_bit_equal": True, "store_equal": True,
                   "cut_run_seconds": cut_s, "checkpoint_bytes": ckpt_bytes, "resumed_seconds": r_secs,
                   "launches": r_launches},
        "profile": device_profile(torch, mods, "hierfavg_edge_iid", overrides, mlp_params),
        "k2_tables": offsets_miss_cost(torch, mods, overrides, mlp_params)})})
    return launches


def phase_cohort_identity(torch, mods):
    """Round-robin cohorts of the whole quickstart population against plain
    quickstart on the card, from the same init: the cohort stages are the
    full tree's, so both take K1 12 times an interval (edge 4, cloud 2 x 4)
    over 12 intervals, and agree bit for bit."""
    plain, p_state, p_secs, p_launches, params = run_scenario(torch, mods, "quickstart", (), "cuda")
    runner, state, secs, launches, _ = run_scenario(torch, mods, "quickstart", COHORT_IDENTITY, "cuda", params)
    check_launches(launches, {"grouped_mean": 144}, "cohort_identity")
    check(launches == p_launches, f"cohort_identity launches {launches} vs quickstart's {p_launches}")
    fields = lambda h: (h.round, h.step, h.loss, h.grad_norm, h.mask_alive, h.accuracy, h.wire_mb)
    check([fields(h) for h in runner.history] == [fields(h) for h in plain.history],
          "cohort_identity: the history differs from quickstart's")
    check(all(bit_equal(state.params[k], p_state.params[k]) for k in state.params),
          "cohort_identity: final params differ from quickstart's")
    emit({"phase": "cohort_identity", **path_report(runner, secs, launches, {
        "history_bit_equal": True, "params_bit_equal": True, "quickstart_seconds": p_secs,
        "final_accuracy": runner.history[-1].accuracy})})
    return launches


def history_rows(runner, skip=()):
    import dataclasses

    return [tuple(getattr(h, f.name) for f in dataclasses.fields(h) if f.name not in skip) for h in runner.history]


def deadline_engine(runner, what):
    check(type(runner._engine).__name__ == "DeadlineEngine", f"{what} ran {type(runner._engine).__name__}")
    walls = [h.wall_clock_s for h in runner.history]
    check(walls[0] > 0 and all(b > a for a, b in zip(walls, walls[1:])), f"{what}: wall clock {walls}")
    return runner._engine.gated_intervals


def phase_deadline_barrier(torch, mods):
    """The full-barrier deadline engine against the synchronous quickstart,
    bit for bit, from the same init."""
    sync, s_sync, _, l_sync, params = run_scenario(torch, mods, "quickstart", (), "cuda")
    runner, state, secs, launches, _ = run_scenario(torch, mods, "quickstart", DEADLINE_BARRIER, "cuda", params)
    gated = deadline_engine(runner, "deadline_barrier")
    check(gated == 0, f"deadline_barrier gated {gated} intervals")
    check(launches == l_sync, f"deadline_barrier launches {launches} vs {l_sync}")
    check(history_rows(runner, ("wall_clock_s",)) == history_rows(sync, ("wall_clock_s",)),
          "deadline_barrier: history differs from the synchronous run's")
    check(all(bit_equal(state.params[k], s_sync.params[k]) for k in state.params),
          "deadline_barrier: params differ from the synchronous run's")
    emit({"phase": "deadline_barrier", **path_report(runner, secs, launches, {
        "engine": "DeadlineEngine", "gated_intervals": gated, "history_bit_equal": True, "params_bit_equal": True,
        "wall_clock_s": [h.wall_clock_s for h in runner.history]})})
    return launches


def deadline_vs_cpu(torch, mods, runner, state, name, overrides, params):
    """The same run on the CPU from the same init: losses and accuracies
    (``history_agreement``), survivors and the event clock equal, final
    params within DEADLINE_PARAMS_ATOL, the same gated intervals."""
    cpu, c_state, *_ = run_scenario(torch, mods, name, overrides, "cpu", params=params)
    agreement = history_agreement(runner, cpu, f"{name} cuda vs cpu", "cpu")
    check([h.mask_alive for h in runner.history] == [h.mask_alive for h in cpu.history], f"{name}: survivors differ")
    check([h.wall_clock_s for h in runner.history] == [h.wall_clock_s for h in cpu.history],
          f"{name}: wall_clock_s differs from the CPU run's")
    err = params_max_err(state, c_state)
    check(err <= DEADLINE_PARAMS_ATOL, f"{name}: params {err} from the CPU run's")
    check(cpu._engine.gated_intervals == runner._engine.gated_intervals, f"{name}: gated intervals differ")
    return {**agreement, "cpu_params_max_abs_err": err, "wall_clock_s_equal_cpu": True}


def phase_deadline_scenarios(torch, mods):
    """The three registered deadline scenarios, card then CPU; the
    registered eval_every=1 refused."""
    from repro_torch.fed import scenarios

    total = {}
    for name in ("deadline_straggler", "fedbuff_k4", "stale_decay"):
        runner, state, secs, launches, params = run_scenario(torch, mods, name, DEADLINE_RUN, "cuda")
        # 18 edge syncs x 4 leaves + 2 cloud syncs x 2 stages x 4 leaves,
        # gated or not: the gate rides the top stage's weights
        check_launches(launches, {"grouped_mean": 2 * 44}, name)
        gated = deadline_engine(runner, name)
        check(gated >= 1, f"{name}: no gated interval")
        agreement = deadline_vs_cpu(torch, mods, runner, state, name, DEADLINE_RUN, params)
        try:
            scenarios.get(name, overrides=["run.num_rounds=20"]).run_experiment(device="cuda")
            refusal = None
        except ValueError as e:
            refusal = str(e)
        check(refusal == DEADLINE_REFUSAL, f"{name} with eval_every=1: {refusal!r}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        emit({"phase": f"deadline_scenarios/{name}", **path_report(runner, secs, launches, {
            **agreement, "gated_intervals": gated, "describe": runner.spec.describe(),
            "wall_clock_s": [h.wall_clock_s for h in runner.history], "eval_every_1_refused": refusal})})
    return total


def phase_deadline_ragged(torch, mods):
    runner, state, secs, launches, _ = run_scenario(torch, mods, "ragged_edges", DEADLINE_RAGGED, "cuda")
    check_launches(launches, {"segment_mean": 2 * 40, "grouped_mean": 2 * 4}, "deadline_ragged")
    gated = deadline_engine(runner, "deadline_ragged")
    check(gated >= 1, "deadline_ragged: no gated interval")
    check(all(bool(torch.isfinite(v).all()) for v in state.params.values()), "deadline_ragged params not finite")
    check(runner.history[-1].loss < runner.history[0].loss, "deadline_ragged loss did not fall")
    emit({"phase": "deadline_ragged", **path_report(runner, secs, launches, {
        "gated_intervals": gated, "wall_clock_s": [h.wall_clock_s for h in runner.history]})})
    return launches


def phase_mlp307k_deadline(torch, mods, mlp_params, mlp_profile):
    """``deadline_straggler`` at the full-width MLP: launches, gated
    intervals, the CPU run, a cut-and-resumed run bit for bit, the warm
    profile beside mlp307k's."""
    import shutil

    name, overrides = "deadline_straggler", MLP307K
    ckpt = lambda d: overrides + ["run.checkpoint_every=4", f"run.checkpoint_dir={CKPT_DIR / d}"]
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    base = reset_peak(torch)
    try:
        runner, state, secs, launches, _ = run_scenario(torch, mods, name, ckpt("straight"), "cuda", mlp_params)
        peak = torch.cuda.max_memory_allocated() - base
        check_launches(launches, {"grouped_mean": 4 * 12}, "mlp307k_deadline")  # as mlp307k: 16 edge + 32 cloud
        gated = deadline_engine(runner, "mlp307k_deadline")
        check(gated >= 1, "mlp307k_deadline: no gated interval")
        check(tuple(state.params["w1"].shape) == (32, 64, 4096), "mlp307k_deadline w1 shape")
        check(all(bool(torch.isfinite(v).all()) for v in state.params.values()), "mlp307k_deadline params not finite")
        run_scenario(torch, mods, name, ckpt("cut") + ["run.num_rounds=4"], "cuda", mlp_params)
        resumed, r_state, r_secs, r_launches, _ = run_scenario(torch, mods, name, ckpt("cut"), "cuda", mlp_params,
                                                               resume=True)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    check([h.round for h in resumed.history] == list(range(4, 8)), "mlp307k_deadline resume: rounds")
    check(history_rows(resumed) == history_rows(runner)[4:],
          "mlp307k_deadline resume: the records (wall clock included) differ from the uninterrupted run's")
    check(all(bit_equal(r_state.params[k], state.params[k]) for k in state.params),
          "mlp307k_deadline resume: final params differ from the uninterrupted run's")
    agreement = deadline_vs_cpu(torch, mods, runner, state, name, overrides, mlp_params)
    # the synchronous engine under the same straggler masks (the deadline
    # section off), so the deadline engine's own cost is apart from the
    # masks': warm walls in turns (A B B A), then its profile
    sync = overrides + ["deadline.enabled=false"]
    turns = []
    for label, ov in (("sync", sync), ("deadline", overrides), ("deadline", overrides), ("sync", sync)):
        r, _, t, *_ = run_scenario(torch, mods, name, ov, "cuda", mlp_params)
        check(type(r._engine).__name__ == ("DeadlineEngine" if label == "deadline" else "SuperRoundEngine"), label)
        turns.append([label, t * 1e3 / (r.cfg.num_rounds // 2)])
    emit({"phase": "mlp307k_deadline", **path_report(runner, secs, launches, {
        **agreement, "gated_intervals": gated, "cloud_intervals": runner.cfg.num_rounds // 2,
        "wall_clock_s": [h.wall_clock_s for h in runner.history], "mask_alive": [h.mask_alive for h in runner.history],
        "final_accuracy": runner.history[-1].accuracy, "peak_memory_bytes": peak,
        "resume": {"from_round": 4, "records_equal": True, "params_bit_equal": True, "seconds": r_secs,
                   "launches": r_launches},
        "profile": device_profile(torch, mods, name, overrides, mlp_params),
        "warm_wall_ms_per_interval_turns": turns,
        "sync_same_stragglers_profile": device_profile(torch, mods, name, sync, mlp_params),
        "mlp307k_profile_same_run": {k: mlp_profile[k] for k in (
            "warm_wall_ms_per_interval", "device_busy_ms_per_interval", "device_busy_share_of_warm_wall",
            "device_ops_per_interval", "busy_ms_per_interval_by_class")}})})
    return launches


def phase_train_lm100m_robust(torch, mods):
    """One cloud interval of ``train_lm100m``'s settings with a median edge
    sync and client failures, remat off and on; the robust statistics timed
    at lm-100m."""
    import numpy as np

    from repro_torch.core import aggregation
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    report, finals, params = {}, {}, None
    for tag, extra in (("plain", []), ("remat", REMAT)):
        ov = LM100M + LM_ROBUST + extra
        torch.cuda.empty_cache()
        base = reset_peak(torch)
        runner, state, secs, launches, params = run_scenario(torch, mods, "lm_edge_niid", ov, "cuda", params)
        peak = torch.cuda.max_memory_allocated() - base
        n_leaves = len(list(leaves(state.params)))
        # the median edge syncs launch nothing; the cloud sync's staged
        # weighted mean launches K1 once per leaf per stage
        check_launches(launches, {"grouped_mean": 2 * n_leaves}, f"train_lm100m_robust {tag}")
        losses = [h.loss for h in runner.history]
        check(all(bool(torch.isfinite(x).all()) for x in leaves(state.params)), f"train_lm100m_robust {tag} params")
        steps = runner.cfg.num_rounds * runner.hier_config.kappa1
        profile = device_profile(torch, mods, "lm_edge_niid", ov, params)
        report[tag] = {"first_call_wall_s": secs, "peak_memory_bytes": peak, "launches": launches,
                       "k1_cloud_sync_launches": launches["grouped_mean"], "losses": losses,
                       "mask_alive": [h.mask_alive for h in runner.history],
                       "device_ms_per_local_step": profile["device_busy_ms_per_interval"]
                       * profile["cloud_intervals"] / steps,
                       "warm_wall_ms_per_interval": profile["warm_wall_ms_per_interval"],
                       "device_busy_share_of_warm_wall": profile["device_busy_share_of_warm_wall"],
                       "busy_ms_per_interval_by_class": profile["busy_ms_per_interval_by_class"]}
        finals[tag] = state.params
        del state
    rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
              for a, b in zip(leaves(finals["remat"]), leaves(finals["plain"])))
    check(rel <= REMAT_RTOL, f"train_lm100m_robust: remat params {rel} from the plain run's")

    # the robust statistics at lm-100m: the median edge sync over the whole
    # tree (8 clients in 2 edges of 4), and both statistics on its largest
    # leaf, against the least time of the function (read once, write once)
    flush = flush_buffer(torch)
    p = finals["plain"]
    ids = np.repeat(np.arange(2), 4)
    mask = torch.tensor([1, 1, 0, 1, 1, 1, 1, 0], dtype=torch.float32, device="cuda")
    whole_ms = time_ms(lambda: aggregation.segment_coordinate_median(p, ids, 2, mask), flush=flush, reps=5, warmup=1)
    leaf = p["blocks"]["b0"]["mlp"]["w1"]
    leaf_bound = 2 * leaf.numel() * leaf.element_size() / HBM_BYTES_PER_S * 1e3
    tree_bytes = 2 * sum(x.numel() * x.element_size() for x in leaves(p))
    stats = {}
    for name, fn in (("coordinate_median", lambda: aggregation.segment_coordinate_median({"x": leaf}, ids, 2, mask)),
                     ("trimmed_mean:0.25", lambda: aggregation.segment_trimmed_mean({"x": leaf}, ids, 2, mask,
                                                                                     trim=0.25))):
        stats[name] = {"case": f"{tuple(leaf.shape)} f32, 2 x 4, one client masked per edge",
                       "ms": time_ms(fn, flush=flush, reps=10, warmup=2), "bound_ms": leaf_bound, "bound_by": "bytes"}
    del flush, finals, p, leaf
    torch.cuda.empty_cache()
    emit({"phase": "train_lm100m_robust", "arch": "lm-100m", "aggregators": "coordinate_median/weighted_mean",
          "failures": "p_fail=0.1", **report, "remat_params_max_rel_err": rel, "tolerance": {"rtol": REMAT_RTOL},
          "median_edge_sync_whole_tree_ms": whole_ms,
          "median_edge_sync_whole_tree_bound_ms": tree_bytes / HBM_BYTES_PER_S * 1e3,
          "robust_statistics_largest_leaf": stats, "phase_seconds": time.perf_counter() - t0})
    return {k: report["plain"]["launches"][k] + report["remat"]["launches"][k] for k in report["plain"]["launches"]}


def profile_call(torch, fn):
    """One call under torch.profiler: wall ms (host clock to a synchronise),
    device-busy ms by kernel class, busy share of the wall, top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_class, by_name = {}, {}
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    for e in events:
        by_class[kernel_class(e.name)] = by_class.get(kernel_class(e.name), 0.0) + e.device_time_total
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    busy_us = sum(by_class.values())
    check(busy_us > 0, "the profiler saw no device time")
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3, "device_busy_share": busy_us / 1e6 / wall,
            "device_ops": len(events), "busy_ms_by_class": {k: v / 1e3 for k, v in sorted(by_class.items())},
            "top_kernels_ms": [[n[:90], v / 1e3] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]]}


def layer_code_last_logits(torch, transformer, params, cfg, tokens):
    """The last position's logits of ``forward`` given the positions
    ``arange(S)`` explicitly: the layers then run their own code, not K7 or
    K8, which take only the positions the model builds itself."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    return transformer.forward(params, cfg, tokens, positions=positions)[:, -1]


def phase_serve_recurrentgemma9b(torch, mods):
    """recurrentgemma-9b at full width (bf16) through the serving entry
    point; the prefill with the kernels against the layer code (``forward``
    with explicit positions: a route the kernels do not take), decode
    consistency, a cut-depth f32 check of the route, and a warm prefill and
    decode step profiled."""
    import dataclasses

    from torch.utils._pytree import tree_leaves

    from repro_torch.configs.base import param_count
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    cfg = get_config("recurrentgemma-9b")
    B, P, G = 2, 4096, 16
    per_prefill = {"flash_attention": 12, "rglru_scan": 26}
    torch.cuda.empty_cache()
    base = reset_peak(torch)
    with torch.no_grad():
        params = transformer.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated() - base
    n_params = sum(t.numel() for t in tree_leaves(params))
    check(n_params == param_count(cfg) == 9_572_462_592, f"recurrentgemma-9b has {n_params} parameters")
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    torch.cuda.reset_peak_memory_stats()
    out, launches = counted_serve(torch, mods, cfg, params, batch=B, prompt_len=P, gen=G)
    peak = torch.cuda.max_memory_allocated() - base
    check_launches(launches, per_prefill, "serve_recurrentgemma9b")
    check(tuple(out["tokens"].shape) == (B, G) and bool(torch.isfinite(out["prefill_logits"]).all()),
          "serve_recurrentgemma9b: tokens or logits")
    warm, _ = counted_serve(torch, mods, cfg, params, batch=B, prompt_len=P, gen=G)
    del out["caches"], warm["caches"]

    # the prefill with the kernels against the layer code, on the card
    x = torch.from_numpy(serve.make_prompts(cfg, B, P + 1, seed=1)).cuda()
    max_len = P + G
    for m in mods:
        m.reset_launch_counts()
    with torch.inference_mode():
        kern, caches = transformer.prefill(params, cfg, x[:, :P], max_len)
        plain = layer_code_last_logits(torch, transformer, params, cfg, x[:, :P])
    routed = {k: v for m in mods for k, v in m.LAUNCHES.items()}
    check_launches(routed, per_prefill, "serve_recurrentgemma9b kernel vs layer-code prefills")
    plain_err, scale = max_err(kern, plain)
    check(bool(torch.isfinite(kern).all()) and plain_err <= K_BF16 * scale,
          f"serve_recurrentgemma9b: kernels vs layer code err {plain_err} (scale {scale})")
    top1 = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    with torch.inference_mode():
        dec, _ = transformer.decode_step(params, cfg, caches, x[:, P],
                                         torch.full((B,), P, dtype=torch.int32, device="cuda"))
        longer, _ = transformer.prefill(params, cfg, x, max_len)
    dec_err, dec_scale = max_err(dec, longer)
    check(bool(torch.isfinite(dec).all()) and dec_err <= K_BF16 * dec_scale,
          f"serve_recurrentgemma9b: decode vs prefill(P+1) err {dec_err} (scale {dec_scale})")

    # a warm prefill and decode step under the profiler
    tok = kern.argmax(-1).to(torch.int32)
    pos = torch.full((B,), P, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        prof_prefill = profile_call(torch, lambda: transformer.prefill(params, cfg, x[:, :P], max_len))
        prof_decode = profile_call(torch, lambda: transformer.decode_step(params, cfg, caches, tok, pos))
    del params, caches, kern, plain, dec, longer
    torch.cuda.empty_cache()

    # the route at cut depth in f32 (1 superblock + the 2-layer tail, full
    # widths): K7 with the window and MQA at hd 256, K8, against the layer
    # code; 3072 tokens wrap the window and divide the layer code's chunks
    cut = dataclasses.replace(cfg, num_layers=5, param_dtype="float32", compute_dtype="float32")
    with torch.no_grad():
        p32 = transformer.init_params(torch.Generator(device="cuda").manual_seed(2), cut)
    x32 = torch.from_numpy(serve.make_prompts(cut, 1, 3072, seed=2)).cuda()
    for m in mods:
        m.reset_launch_counts()
    with torch.inference_mode():
        k32, _ = transformer.prefill(p32, cut, x32, 3072)
        l32 = layer_code_last_logits(torch, transformer, p32, cut, x32)
    check_launches({k: v for m in mods for k, v in m.LAUNCHES.items()}, {"flash_attention": 1, "rglru_scan": 4},
                   "cut-depth f32 prefill")
    cut_err, cut_scale = max_err(k32, l32)
    check(cut_err <= K_F32 * cut_scale, f"serve_recurrentgemma9b cut-depth f32: err {cut_err} (scale {cut_scale})")
    del p32
    torch.cuda.empty_cache()
    emit({"phase": "serve_recurrentgemma9b", "arch": cfg.name, "params": n_params, "param_bytes": param_bytes,
          "dtype": "bfloat16", "batch": B, "prompt_len": P, "gen": G, **serve_report(out, warm, launches),
          "launches_per_prefill": per_prefill, "init_peak_memory_bytes": init_peak, "peak_memory_bytes": peak,
          "kernels_vs_layer_code": {"max_abs_err": plain_err, "max_abs_logit": scale, "top1_agreement": top1,
                                    "tolerance": f"{K_BF16} x max |logit|"},
          "decode_vs_prefill": {"position": P, "max_abs_err": dec_err, "max_abs_logit": dec_scale},
          "cut_depth_f32": {"layers": 5, "prompt_len": 3072, "max_abs_err": cut_err, "max_abs_logit": cut_scale,
                            "tolerance": f"{K_F32} x max |logit|"},
          "profile_prefill": prof_prefill, "profile_decode_step": prof_decode})
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.core import aggregation
    from repro_torch.core.hierarchy import as_hierarchy
    from repro_torch.fed import transport
    from repro_torch import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hier_aggregate as ha
    from repro_torch.kernels import megakernel as mk
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import rglru_scan as rg

    resolve_device("cuda")  # TF32 off: the plain versions' f32 products stay f32
    mods = (ha, qz, mk, fa, rg)
    t0 = time.perf_counter()
    libs = _build.build_all()
    ptxas = [ln.strip() for p in libs.values() for ln in Path(str(p) + ".log").read_text().splitlines()
             if "Used" in ln] if all(Path(str(p) + ".log").exists() for p in libs.values()) else []
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [str(p) for p in libs.values()], "ptxas": ptxas})

    summary = phase_kernels(torch, ha)
    summary.update(phase_transport_kernels(torch, ha, qz))
    summary.update(phase_edge_interval_kernel(torch, mk))
    summary.update(phase_attention_kernel(torch, fa))
    summary.update(phase_rglru_kernel(torch, rg))
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
    base = reset_peak(torch)
    runner, state, secs, launches, params = run_scenario(torch, mods, "hierfavg_edge_iid", MLP307K, "cuda")
    check(launches["grouped_mean"] == 4 * 12, f"mlp307k K1 launches {launches}")
    check(all(torch.isfinite(v).all() for v in state.params.values()), "mlp307k params not finite")
    check(tuple(state.params["w1"].shape) == (32, 64, 4096), "mlp307k w1 shape")
    check(runner.history[-1].loss < runner.history[0].loss, "mlp307k loss did not fall")
    check(runner.history[-1].accuracy >= 0.9, f"mlp307k accuracy {runner.history[-1].accuracy}")
    uncompressed_accuracy = runner.history[-1].accuracy
    mlp_runner, mlp_params, mlp_peak = runner, params, torch.cuda.max_memory_allocated() - base
    count(launches)
    mlp_profile = device_profile(torch, mods, "hierfavg_edge_iid", MLP307K, params)
    emit({"phase": "mlp307k", **path_report(runner, secs, launches, {
        "params_per_client": sum(v[0].numel() for v in state.params.values()),
        "peak_memory_bytes": mlp_peak, "profile": mlp_profile})})

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
    base = reset_peak(torch)
    runner, state, secs, launches, params = run_scenario(torch, mods, "int8_ef_both", MLP307K, "cuda")
    check(launches["quantize"] == launches["dequantize"] == 8 * 4, f"mlp307k_int8_ef K4/K5 launches {launches}")
    check(launches["grouped_mean"] == 4 * 12, f"mlp307k_int8_ef K1 launches {launches}")
    check(all(torch.isfinite(v).all() for v in state.params.values()), "mlp307k_int8_ef params not finite")
    check(runner.history[-1].loss < runner.history[0].loss, "mlp307k_int8_ef loss did not fall")
    acc = runner.history[-1].accuracy
    check(abs(acc - uncompressed_accuracy) <= 0.02, f"mlp307k_int8_ef accuracy {acc} vs {uncompressed_accuracy}")
    peak = torch.cuda.max_memory_allocated() - base
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
    del updates, encoded, fused, state, got, want, decoded, q, s  # free the device memory before the peak checks

    # K3 through its entry point against the client-blocked lowering
    count(phase_megakernel_vs_k3(torch, mods, mk))

    # the client-blocked engine at the full-width MLP (blocks of 2 clients
    # under the 4 MiB budget): one flat K1 mean per leaf per edge interval
    mk_overrides = MLP307K + MEGAKERNEL
    base = reset_peak(torch)
    runner, state, secs, launches, _ = run_scenario(torch, mods, "hierfavg_edge_iid", mk_overrides, "cuda", mlp_params)
    check(runner._engine.uses_megakernel and runner._engine.megakernel_reason is None,
          f"mlp307k_megakernel fell back to the superround: {runner._engine.megakernel_reason}")
    check(launches["grouped_mean"] == 4 * 8, f"mlp307k_megakernel K1 launches {launches}")
    check(all(torch.isfinite(v).all() for v in state.params.values()), "mlp307k_megakernel params not finite")
    check(tuple(state.params["w1"].shape) == (32, 64, 4096), "mlp307k_megakernel w1 shape")
    check(runner.history[-1].accuracy >= 0.9, f"mlp307k_megakernel accuracy {runner.history[-1].accuracy}")
    mk_runner, mk_peak = runner, torch.cuda.max_memory_allocated() - base
    vs_superround = history_agreement(runner, mlp_runner, "mlp307k_megakernel vs mlp307k", "superround")
    agreement = cpu_agreement(torch, mods, runner, "hierfavg_edge_iid", mk_overrides, mlp_params)
    count(launches)
    emit({"phase": "mlp307k_megakernel", **path_report(runner, secs, launches, {
        "uses_megakernel": True, "megakernel_reason": None, **vs_superround, **agreement,
        "final_accuracy": runner.history[-1].accuracy, "peak_memory_bytes": mk_peak,
        "superround_peak_memory_bytes": mlp_peak,
        "profile": device_profile(torch, mods, "hierfavg_edge_iid", mk_overrides, mlp_params)})})

    # the same with bf16 client state
    base = reset_peak(torch)
    runner, state, secs, launches, _ = run_scenario(
        torch, mods, "hierfavg_edge_iid", mk_overrides + BF16, "cuda", mlp_params)
    peak = torch.cuda.max_memory_allocated() - base
    check(runner._engine.uses_megakernel, f"mlp307k_megakernel_bf16 fell back: {runner._engine.megakernel_reason}")
    check(launches["grouped_mean"] == 4 * 8, f"mlp307k_megakernel_bf16 K1 launches {launches}")
    check(all(v.dtype == torch.bfloat16 and bool(torch.isfinite(v).all()) for v in state.params.values()),
          "mlp307k_megakernel_bf16: a param leaf is not finite bf16")
    l16 = torch.tensor([h.loss for h in runner.history], dtype=torch.float64)
    l32 = torch.tensor([h.loss for h in mk_runner.history], dtype=torch.float64)
    check(len(l16) == len(l32) and bool(((l16 - l32).abs() <= 0.01 + 0.05 * l32.abs()).all()),
          f"mlp307k_megakernel_bf16 losses {l16.tolist()} vs f32 {l32.tolist()}")
    acc16, acc32 = runner.history[-1].accuracy, mk_runner.history[-1].accuracy
    check(abs(acc16 - acc32) <= 0.05, f"mlp307k_megakernel_bf16 accuracy {acc16} vs f32 {acc32}")
    check(peak < mk_peak, f"mlp307k_megakernel_bf16 peak memory {peak} not below the f32 run's {mk_peak}")
    count(launches)
    emit({"phase": "mlp307k_megakernel_bf16", **path_report(runner, secs, launches, {
        "param_dtypes": sorted({str(v.dtype) for v in state.params.values()}),
        "loss_max_abs_err_vs_f32": float((l16 - l32).abs().max()), "final_accuracy": acc16,
        "f32_final_accuracy": acc32, "peak_memory_bytes": peak, "f32_peak_memory_bytes": mk_peak})})

    # robust aggregators under failure masks. trimmed_edge (16 rounds of
    # kappa (4, 2)): 8 cloud syncs x 2 stages x 4 leaves of K1, the trimmed
    # edge syncs none; median_cloud (20 rounds of (6, 10)): 18 weighted edge
    # syncs x 4 leaves, the median cloud syncs none; trimmed_int8: 2 cloud
    # syncs x 2 stages x 4 leaves, and K4 = K5 once per leaf per int8 cloud
    # sync
    count(phase_robust_scenario(torch, mods, "trimmed_edge", (), {"grouped_mean": 64}))
    count(phase_robust_scenario(torch, mods, "median_cloud", INT8_CLOUD, {"grouped_mean": 72}))
    count(phase_robust_scenario(torch, mods, "trimmed_int8", INT8_CLOUD,
                                {"grouped_mean": 16, "quantize": 8, "dequantize": 8}))
    count(phase_mlp307k_robust(torch, mods, mlp_params, uncompressed_accuracy))

    # the semi-synchronous deadline engine: the barrier bit for bit, the
    # registered scenarios against the CPU, K2 under the gate, full width
    count(phase_deadline_barrier(torch, mods))
    count(phase_deadline_scenarios(torch, mods))
    count(phase_deadline_ragged(torch, mods))
    count(phase_mlp307k_deadline(torch, mods, mlp_params, mlp_profile))

    # sampled participation: the population scenario, the full-width MLP
    # with sticky rows, and the identity cohort
    count(phase_n1m_cohort4096(torch, mods))
    count(phase_mlp307k_cohort(torch, mods, mlp_params))
    count(phase_cohort_identity(torch, mods))

    # federated LM training: K1 per leaf per level mean, K4/K5 per leaf per
    # compressed sync, K7/K8 never (the layer code runs under torch.func)
    del runner, state, mk_runner, mlp_runner, mlp_params, params
    count(phase_train_lm10m(torch, mods, "train_lm10m", LM_TRAIN))
    count(phase_train_lm10m(torch, mods, "train_lm10m_int8_ef", LM_INT8_EF))
    count(phase_train_lm100m(torch, mods))
    count(phase_train_lm100m_robust(torch, mods))

    # LM serving: K7 in every attention layer and K8 in every RG-LRU layer of
    # the prefill
    count(phase_serve_lm100m(torch, mods))
    count(phase_serve_recurrentgemma9b(torch, mods))

    check(all(total[name] > 0 for name in KERNELS), f"a kernel was never launched on its path: {total}")
    emit({"phase": "profiler", "short_traces_taken_again": TRACES_TAKEN_AGAIN[0]})
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
