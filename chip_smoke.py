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
              takes; each rank's shapes; the paper CNNs' largest leaf at
              their edge sync and the CIFAR CNN's at its cloud root), f32
              and bf16, with masked clients and a dead group;
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
              against this call's mlp307k run and the first cloud interval
              against the same on the CPU
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
  paper_figures/<script>
              the paper's figure and table scripts (``repro_torch.experiments``)
              at their own sizes: table1_cost_model (rows against the cost
              model), fig4_convergence (8 schedules of 50 clients on 5
              edges, 240 local steps each; guideline 1), table2_latency_energy
              with ``--sim`` (IIa, IIc's int8 cloud hop, IIb; T falls with
              kappa2, E U-shaped), fig2_topologies (``fig2_claims``),
              aggregation_scaling, compression_tradeoff, round_time_sim and
              wallclock_curves with their gates asserted; one line each with
              the rows printed, the wall, client steps a second, the
              launches against ``stand_in_launches`` (K1 once a leaf per
              level mean, K4 = K5 once a leaf per compressed sync; checked)
  paper_figures/fig4_cut
              one Fig. 4 schedule (edge-NIID, kappa (6, 10)) cut to one cloud
              interval, on the card and on the CPU from one init: losses
              rtol 1e-4, accuracies 0.01
  paper_cifar10
              the paper's CIFAR-10 CNN (5,537,578 parameters a client) at
              its setting (``configs/paper.py``): 50 clients on 5 edges,
              batch 20, SGD at lr 0.1 decayed 0.992 an epoch, kappa (5, 10),
              on a synthetic stand-in of 50,000 32x32x3 images partitioned
              edge-NIID, through ``build_super_round``: two cloud intervals
              (the first call, then warm), K1 198 an interval (18 leaves x
              (9 edge syncs + the cloud sync's 2 stages)), losses finite and
              falling, the peak, the cloud model's loss and accuracy on
              10,000 held-out images at w0 and after each interval
              (printed), a third interval profiled (convolutions,
              products, K1, the rest); one cloud interval of 4 clients on 2
              edges, kappa (2, 2), on the card against the CPU from one init
              (losses 1e-4, params 1e-4 |p| + 1e-5)
  divergence_cifar10
              Definition 1's delta and Delta over the 50 clients' full
              batches at w0 and after each interval of paper_cifar10, beta
              at w0 (on a fixed sample of 10,000 images), G_c, G_nc,
              Theorem 1 and both guidelines at the paper's kappa pairs; the
              divergences at the cut on the card against the CPU (1e-4)
  paper_mnist
              the MNIST CNN (21,840 parameters) at its setting, 50 clients
              on 5 edges, kappa (15, 4), one cloud interval: K1 40 (8 leaves
              x (3 + 2)); the held-out loss and accuracy; the same cut
              against the CPU
  roofline_calibration
              the card's f32 product and streaming-add peaks
              (``analysis.roofline.measure_host_peaks`` at n 8192) beside the
              data sheet's; K3 (``calibrate_megakernel(path="kernel")``) and
              its plain version at the JAX package's default shape and at
              K3's full-width case, every fraction in (0, 1.05]; lm-100m's
              model FLOPs a local step and the share of the measured peak
              that train_lm100m's warm interval reached (printed)
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
              one round of one local step on the card and on the CPU from
              the same init, against each other; then one warm cloud
              interval timed and profiled
  train_lm100m_robust
              one cloud interval of those settings with a coordinate-median
              edge sync and client failures, with remat off and on: device
              time per local step, peak memory, K1 at the cloud sync, K7 = K8
              = 0, remat's final params against the plain run's; the median
              and trimmed mean timed over the whole tree and on its largest
              leaf
  train_lm100m_accum2
              the same scenario through ``FederatedRunner(grad_accum=2)``:
              each client's 8 sequences as 2 microbatches of 4, K1 as
              ``train_lm100m``; under SGD the params within 1e-5 and the
              grad norms within 1e-4 of grad_accum 1 (the loss metric, the
              last microbatch's, reported); under Adam the gaps reported;
              peak memory and the warm wall an interval
  examples/quickstart, examples/compare_topologies, examples/serve_lm,
  examples/train_hier_lm
              the four examples (``repro_torch.examples``) on the card:
              quickstart (K1 144); compare_topologies' default sweep (the
              baselines and four trees, 100 rounds each; K2 on the ragged
              levels, all counted); serve_lm (the lm-serve cut, 4 x 32
              prompts, 24 tokens: K7 once a layer, 4 a prefill; the prefill
              against the CPU's; K7 at its shape against its plain version);
              train_hier_lm --preset 100m --rounds 8 (lm-100m at full width,
              K1 144, the checkpoint at round 8 written and removed)
  sharded_mlp307k_w1_nccl
              mlp307k through ``topology.mesh_axes=clients:1`` over a world
              of 1 under NCCL (in this process): the client-sharded engine,
              K1 32 (the cloud's root stage is the all-reduce), 4
              all-reduces; records and params against the single-device
              card run at JAX's mesh tolerances; kappa1 local steps and the
              edge sync bit for bit against the single-device path's
  sharded_mlp307k_w4, mlp307k_int8_ef_w2, sharded_ragged_w2,
  sharded_lm100m_w2, sharded_n1m_cohort_w2
              gloo worlds of ranks sharing the card (``dist.launch.spawn``;
              the kernels are built before the ranks start): mlp307k over 4
              ranks (one edge each), mlp307k_int8_ef, ragged_edges (phantom
              rows), lm-100m at full width (one edge of 4 clients a rank)
              and n1m_cohort4096 uncut over 2. Per rank: K1/K2/K4/K5 as
              counted on its own rows, one all-reduce per cloud interval
              (an eval's cloud model is one more, counted apart), the peak;
              the records and the final params against the single-device
              card run (params at JAX's mesh tolerance); mlp307k and n1m
              once more, warm and profiled, with each cloud all-reduce
              timed (ms, bytes; lm-100m's re-runs were cut for the
              script's wall: each held a 10.7 s state gather). The
              kernels phase holds K1/K2 at each
              rank's shapes against their plain versions
  train_cell_lm100m_w2
              ``launch.steps.build_train_cell`` at lm-100m (16 clients on 4
              edges, a 128 x 64 cut of train_4k: microbatch 4, accum 2) on
              a ("data",) mesh of 2 gloo ranks, one cloud interval (kappa
              cut to (2, 2): 4 calls), against the single-device cell over
              the same batches at JAX's mesh tolerances; K1 24 a rank (36 on
              one device), one all-reduce; the wall a call and each rank's
              peak
  tp_lm100m_m2
              tensor parallelism in the same world of 2 gloo ranks, on a
              ("data", "model") mesh of (1, 2): each rank holds half of
              every split leaf of lm-100m. The train cell (as above) against
              the single-device cell: losses and grad norms at rtol 1e-5,
              params at JAX's mesh tolerances, K1 36 a rank, 100
              tensor-parallel sums, 2 maxes, 2 gathers and one grad-norm sum
              a call, the last call's collectives timed (ms, bytes); the
              prefill and decode cells on 4 x 1024 prompts, f32: K7 12 a
              prefill a rank (6 query heads over 2 KV heads), the last
              logits and 8 greedy decode steps against one device (the same
              tokens, logits within 1e-4 of the largest), 24 sums and 2
              gathers a call, tokens/s, each rank's parameter bytes and
              peak. The kernels and attention_kernel phases hold K1 at a
              rank's largest slices and K7 at a rank's heads
  serve_lm100m
              ``repro_torch.launch.serve.serve`` on lm-100m at full width, f32,
              4 prompts of 1024 tokens, 32 generated: 12 K7 launches per
              prefill, none of K8; a 2 x 128 prefill on the card against the
              same on the CPU; decoding token P after prefill(P) against
              prefill(P + 1)
  train_xlstm350m
              ``lm_edge_niid`` on xlstm-350m at its published widths and
              depth (24 layers, 3:1 mLSTM:sLSTM, bf16; the scenario's
              vocabulary of 512) on 4 clients over 2 edges (8 do not fit
              in 80 GB) for 2 rounds: K1 once per leaf per level mean (123),
              K7 = K8 = 0, losses finite and falling, params finite, f32
              exactly on the gate, recurrence and bias leaves, the peak;
              one local step of its final state profiled, K1 timed per
              leaf; one cloud interval at 4 layers in f32 on 4
              clients (8-token sequences) against the CPU, with Adam and
              with SGD (losses, and SGD's params after the cloud sync). K1
              at this run's leaves is also among the kernels phase's cases.
              ``python3 chip_smoke.py --xlstm-train-memory`` runs only the
              build and this run's memory: 4 clients over one and four
              intervals, with remat, and 8 without and with it.
  serve_recurrentgemma9b
              the same on recurrentgemma-9b at full width (9.57B parameters,
              bf16), 2 prompts of 4096 tokens (the 2048-slot rings wrap), 16
              generated: 12 K7 and 26 K8 launches per prefill; the prefill
              with the kernels against the layer code on the card; decode
              consistency; a cut-depth f32 check of the K7/K8 route against
              the layer code; a warm prefill and decode step under
              torch.profiler
  serve_xlstm350m
              xlstm-350m uncut (480,633,856 parameters, bf16), 2 prompts of
              1024 tokens, 32 generated: no kernel launch (mLSTM and sLSTM
              are plain PyTorch, as in JAX); decode against the chunkwise
              forward over P + 1 tokens; card against the CPU in f32 on an
              8-token prompt (the sLSTM is chaotic at this width) and, on a
              cut of 3 mLSTM layers, on 2048 tokens (logits and each
              layer's carry); a warm prefill (with the sLSTM layers' host
              and device shares) and decode step under torch.profiler
  serve_deepseekv3_l1
              deepseek-v3-671b at full layer widths (MLA, 256 routed experts
              top-8 and a shared one), one layer deep (26.7 GB of bf16),
              1 prompt of 4096 tokens, 16 generated: K7 once per prefill (v
              zero-padded from 128 to the q/k head dim 192); the prefill
              against the layer code, the absorbed decode against prefill(P
              + 1), the MoE's output for 64 tokens against a per-token dense
              reference, the dropped assignments; a warm prefill and decode
              step under torch.profiler; the expert product's two bf16
              routes (bmm's f32 output, blocks upcast) timed; K7 at this
              shape against its plain version, timed beside its bound and
              SDPA
  serve_deepseekv3_l1_ep2
              the same layer through ``build_prefill_cell`` /
              ``build_decode_cell`` on 2 gloo ranks with a "data" axis of 2
              (expert-parallel: 128 experts and one request of 4096 tokens a
              rank): one dispatch and one combine all-to-all per MoE call,
              K7 once per prefill a rank; prefill and 15 decode steps
              against one device with G = 2 token groups (within 2^-7 of the
              largest logit, the first difference printed); the exchange's
              ms and bytes, tokens/s and each rank's peak
  dryrun      the dry run's op counter (``analysis.opcount``) against the
              card: lm-100m's single-device prefill (4 x 1024, f32, K7) and
              train cell (the 128 x 64 cut, its second call: the local step
              and the edge sync's K1) counted on real CUDA tensors and on
              meta tensors (the dry run's): equal FLOPs, bytes, kernel
              charges and collectives, the counted peak within 15 % of the
              allocator's, the counted roofline against a CUDA-event time;
              ``tp_lm100m_m2``'s prefill as its gloo ranks counted it
              against a fake (1, 2) world presented as gloo; then
              ``python -m repro_torch.launch.dryrun --arch yi-9b --mesh
              single`` and its report in subprocesses that see no card,
              started beside ``world2`` and collected here

The CPU runs the card runs are held to (``cpu_jobs``) run in one spawned,
lower-priority worker process from the start, beside the build; each phase
collects its reference (``cpu_ref``) and the ``wall`` line names how long
each waited and when the worker finished it. The 2- and 4-rank worlds'
ranks hand their results back through files (``handed_over``).

The quickstart, mlp307k, mlp307k_int8_ef, mlp307k_megakernel,
n1m_cohort4096, mlp307k_cohort, mlp307k_deadline and train_lm100m phases
then run their
scenario twice more, warm: once timed,
once under
``torch.profiler``, and report where the device time of a cloud interval
goes (by kernel class and top kernels) and the device's idle share. The
profiler traces the device alone (host ops only where a phase reads host
ranges), and its records are read raw (``device_events``); busy time is
the union of their spans (``busy_us``).

Then the script's whole wall (``wall``), a kernel summary line, the
card's name and power limit as nvidia-smi
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
T0_WALL = time.time()
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
# lm-100m's card-vs-CPU check: one round of one local step and its edge
# sync (4 local steps before: the CPU's lm-100m steps were the script's
# largest cost)
LM100M_CPU_ROUND = ["run.num_rounds=1", "schedule.kappas=1,2"]
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
# xlstm-350m's sLSTM recurrence at its published widths amplifies a
# rounding by about 1.15x a token (the init's recurrent matrices have std
# H^-0.5 = 0.5 over dh = 256 inputs), so two devices' f32 logits part by
# 3.5e-5 of the largest at token 8 and by O(1) at token 256 (the serve
# phase measures it on every run). Card against the CPU is therefore held
# on 8-token sequences: the serve phase's f32 logits within K_F32, and the
# training cut's loss within LM_RTOL (grad norm and params reported).
XLSTM = ["model.arch=xlstm-350m"]
XLSTM_CHAOS_PROMPTS = (4, 8, 16, 256)  # f32 card vs CPU distance measured at each
XLSTM_CHECK_PROMPT = 8
# federated training at the published widths and depth (bf16, as the config
# stores it; the scenario's vocabulary of 512) on 4 clients over 2 edges: 8
# clients take more than the card's 80 GB with and without remat
# (``--xlstm-train-memory`` measures each)
XLSTM_TRAIN = XLSTM + ["topology.clients_per_edge=2"]
XLSTM_TRAIN_CUTS = ["4 clients on 2 edges, not 8: 8 run out of memory on 80 GB with and without remat",
                    "2 rounds (1 cloud interval, 8 local steps), not 8: the script's wall"]
XLSTM_TRAIN_ROUNDS = ["run.num_rounds=2"]
# card against the CPU: one cloud interval (2 rounds: an edge sync, then the
# cloud sync) at one period of the 3:1 pattern (4 layers) in f32 on 4
# clients over 2 edges, 8-token sequences; SGD held to the params' atol, the
# scenario's Adam reported beside it
XLSTM_CUT = dict(num_layers=4, param_dtype="float32", compute_dtype="float32")
XLSTM_CUT_RUN = ["run.num_rounds=2", "schedule.kappas=2,2", "topology.clients_per_edge=2",
                 f"data.seq_len={XLSTM_CHECK_PROMPT + 1}"]  # 2 local steps a round: the script's wall
XLSTM_CUT_PARAMS_ATOL = 1e-5
XLSTM_PROFILE_P = 256  # the profiled xlstm-350m prefill: one mLSTM chunk
XLSTM_SERVE_PROMPT = 1024  # 2 x 1024 served (2048 before): the sLSTM's loop over time is host-bound
# the mLSTM layers alone against the CPU over the serving prompt's 8 chunks
XLSTM_MLSTM_CUT = dict(block_pattern=("mlstm",), num_layers=3, param_dtype="float32", compute_dtype="float32")
XLSTM_MLSTM_PROMPT = 2048
# deepseek-v3's MoE output against the per-token dense reference (the same
# roundings: h, g in f32, bf16 after silu(h) * g and after each expert's
# down product): within MOE_REF_RTOL of the largest |y|, a bf16 ulp's order
MOE_REF_RTOL = 2.0 ** -7
MOE_REF_TOKENS = 64
# tp_deepseekv3_l1_m2's MoE alone at a capacity its experts overflow:
# 4096 tokens at capacity factor 1.0, 136 slots an expert for a mean load of
# 128 assignments (the prefill's factor 1.25 drops none)
MOE_OVERFLOW = (4096, 1.0)


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


def rank_stage_ids(name, num_shards, rank, cohort_size=None):
    """The level-1 segment ids one rank's sub-top stages give K2 in the
    sharded run of scenario ``name`` (``ClientSharding.local_segments``):
    the shard placement, or with ``cohort_size`` the cohort's slot
    placement."""
    from repro_torch.core.hierarchy import as_hierarchy, plan_cohort_placement, plan_shard_placement
    from repro_torch.core.hierfavg import _cohort_quotas
    from repro_torch.fed import scenarios

    spec = as_hierarchy(scenarios.get(name).topology.build())
    if cohort_size is None:
        placement = plan_shard_placement(spec, num_shards)
    else:
        placement = plan_cohort_placement(spec, _cohort_quotas(spec, cohort_size), num_shards)
    return placement.local_segments(1)[rank]


def kernel_cases():
    """(kernel, label, N, D, the group count, segment ids or a cohort
    ``Stage``) at the main path's shapes. A ``Stage`` is called as the
    cohort engine calls K2: with the ``offsets=`` table that
    ``stage_host_tables`` builds, uploaded."""
    import numpy as np

    # the sharded phases' ranks: n1m's 2048 slots on 500 edges, and
    # ragged_edges' rank 0 (edges of 16 and 7 clients, 4 phantom rows)
    n1m_rank = rank_stage_ids("n1m_cohort4096", 2, 0, cohort_size=4096)
    ragged_rank = rank_stage_ids("ragged_edges", 2, 0)

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
        # train_xlstm350m's syncs (4 clients on 2 edges): the largest leaf,
        # wq of the 18 mLSTM layers (4 x 6 x 2048 x 2048, bf16 in the run),
        # at the edge sync and the cloud sync's root stage, and the sLSTM's
        # recurrent r_i (4 x 6 x 4 x 256 x 256, f32 in the run)
        ("grouped_mean", "xlstm-350m wq edge (4x25165824, G=2)", 4, 25165824, 2),
        ("grouped_mean", "xlstm-350m wq cloud root (2x25165824, G=1)", 2, 25165824, 1),
        ("grouped_mean", "xlstm-350m r_i edge (4x1572864, G=2)", 4, 1572864, 2),
        # paper_cifar10's and paper_mnist's syncs (50 clients on 5 edges,
        # f32): the largest leaf, f1w (2048 x 2048 and 320 x 50), at the
        # edge sync (also the cloud sync's edge stage) and the CIFAR CNN's
        # at the cloud sync's root stage
        ("grouped_mean", "paper_cifar10 f1w edge (50x4194304, G=5)", 50, 4194304, 5),
        ("grouped_mean", "paper_cifar10 f1w cloud root (5x4194304, G=1)", 5, 4194304, 1),
        ("grouped_mean", "paper_mnist f1w edge (50x16000, G=5)", 50, 16000, 5),
        # the sharded phases' ranks (the last case of each kernel stays the
        # summary's): each rank's edge sync and its cloud sync's edge stage
        # (before the all-reduce) over its own rows.
        # lm-100m over 2 ranks (4 clients, one edge a rank); mlp307k over 4
        # (8 clients, one edge) and over 2 (16 clients, two edges)
        ("grouped_mean", "lm-100m mlp w1 one rank of 2 (4x18874368, G=1)", 4, 18874368, 1),
        ("grouped_mean", "mlp307k w1 one rank of 4 (8x262144, G=1)", 8, 262144, 1),
        ("grouped_mean", "mlp307k w1 one rank of 2 (16x262144, G=2)", 16, 262144, 2),
        # tp_lm100m_m2's train cell (16 clients on 4 edges), one of 2 model
        # ranks: the stacked MLP weight's half (16 x 12 x 768 x 1024) and
        # the LM head's (16 x 768 x 16384, the largest slice) at the edge
        # stage
        ("grouped_mean", "lm-100m w1 TP slice, one of 2 model ranks (16x9437184, G=4)", 16, 9437184, 4),
        ("grouped_mean", "lm-100m lm_head TP slice, one of 2 model ranks (16x12582912, G=4)", 16, 12582912, 4),
        # tp_xlstm350m_m2's train cell (4 clients on 2 edges, f32), one of 2
        # model ranks: the LM head's half (4 x 1024 x 25152, the largest
        # slice) at the edge stage
        ("grouped_mean", "xlstm-350m lm_head TP slice, one of 2 model ranks (4x25755648, G=2)", 4, 25755648, 2),
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
        ("segment_mean", f"n1m cohort w1 one rank of 2 ({n1m_rank.shape[0]}x768, "
                         f"{int(n1m_rank.max()) + 1} segments)", n1m_rank.shape[0], 768, n1m_rank),
        ("segment_mean", f"ragged_edges w1 rank 0 of 2 ({ragged_rank.shape[0]}x768, "
                         f"{int(ragged_rank.max()) + 1} segments)", ragged_rank.shape[0], 768, ragged_rank),
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
    gen = torch.Generator(device="cuda").manual_seed(0)
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
            # drawn on the card: host normals for the largest cases took tens of seconds of the phase
            x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
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


# traces taken again (a window that lost its edges, or a kernel); the most
# leading spins one kept trace lost
TRACE_STATS = {"whole": 0, "taken_again": 0, "leading_spins_lost_max": 0}
# leading spins a trace starts with: the tracer has lost up to 50 in one
# window on an H100, and each retake runs the call again
TRACE_LEAD = 32
SPIN_CYCLES = 2_000_000  # torch.cuda._sleep's clock cycles: about 1 ms on an H100


def bracketed_trace(torch, fn, activities, attempts: int = 12):
    """``fn`` once under ``torch.profiler``, the card idle on either side of
    the call, between leading spin kernels (``torch.cuda._sleep``, about
    1 ms each, no kernel of ours) and one trailing spin. On an H100 the
    tracer drops the records that start in the first part of a window, a
    few percent of the time and at times for dozens of windows in a row
    (it once dropped K1's record from 16 windows of one call), so a trace
    counts only if a leading spin survived before the call's first record
    and the trailing one after its last: then nothing of the call was lost.
    A trace that lost every leading spin is taken again with twice as many
    (TRACE_LEAD at first, up to 256). Returns (profiler, the call's device records,
    seconds of the call to a synchronise, ``fn``'s result); raises if no
    trace was whole."""
    from torch.profiler import profile

    lead = TRACE_LEAD
    for attempt in range(attempts):
        time.sleep(0.05 * attempt)
        torch.cuda.synchronize()
        prof = profile(activities=activities)
        with prof:
            for _ in range(lead):
                torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        events = sorted(device_events(torch, prof), key=lambda ev: ev[1])
        spins = [i for i, ev in enumerate(events) if "spin_kernel" in ev[0]]
        call = [i for i, ev in enumerate(events) if "spin_kernel" not in ev[0]]
        # with no record of the call, one leading spin and the trailing one
        first, last = (call[0], call[-1]) if call else (spins[-1] if spins else 0, spins[0] if spins else 0)
        leading = sum(i < first for i in spins)
        if leading and spins[-1] > last:
            TRACE_STATS["leading_spins_lost_max"] = max(TRACE_STATS["leading_spins_lost_max"], lead - leading)
            TRACE_STATS["whole"] += 1
            return prof, [events[i] for i in call], seconds, out
        TRACE_STATS["taken_again"] += 1
        if not leading:
            lead = min(2 * lead, 256)
    raise AssertionError(f"{attempts} profiler traces in a row lost the edges of the call's window")


def traced_kernels(torch, fn, needle: str, attempts: int = 4, want: int = 0) -> list:
    """The names of the device kernels holding ``needle`` that one call of
    ``fn`` ran, from a whole trace (``bracketed_trace``), one entry per
    launch. A whole trace with fewer than ``want`` such kernels is taken
    again, up to ``attempts`` whole traces, and the most seen is returned:
    a kernel that never ran still shows none."""
    from torch.profiler import ProfilerActivity

    best = []
    for _ in range(attempts):
        _, events, _, _ = bracketed_trace(torch, fn, [ProfilerActivity.CUDA])
        names = [name for name, _, _ in events if needle in name]
        best = names if len(names) > len(best) else best
        if best and len(best) >= want:
            break
        TRACE_STATS["taken_again"] += 1
    return best


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


def run_scenario(torch, mods, name, overrides, device, params=None, profiler=None, resume=False, spy=None,
                 grad_accum=1):
    """Build, init and run a scenario; returns (runner, state, seconds,
    launches, params) with the launch counts of every kernel module in
    ``mods`` reset just before the run and read just after it, so they count
    this run only. ``profiler`` (a ``torch.profiler.profile``) wraps
    ``runner.run`` alone. ``resume`` starts from the latest checkpoint of
    ``run.checkpoint_dir`` (``restore_or_init``). ``spy(runner)`` is called
    after the init (``spy_cohort_engine``). ``grad_accum`` cuts each
    client's batch into that many microbatches (``spec.build(grad_accum=)``)."""
    from repro_torch.fed import scenarios

    spec = scenarios.get(name, overrides=overrides)
    runner = spec.build(device=device, grad_accum=grad_accum)
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


# -- CPU references in worker processes ---------------------------------------
#
# The CPU runs that the card runs are held to take minutes of host time. They
# depend on nothing the card computes (each starts from its scenario's seeded
# init), so a spawned worker process runs them beside the card phases,
# from the end of the build, and a phase collects its reference when it
# needs it (``cpu_ref``). Each worker keeps CPU_WORKER_THREADS intra-op
# threads at a lower priority (CPU_WORKER_NICE), and while it lives the main
# process keeps the other cores' worth of intra-op threads (``MAIN_THREADS``):
# more threads than cores made each of the main process's host ops wait on
# a descheduled thread (a CIFAR-10 interval's host-bound wall 1.6 s -> 8.1
# s). The workers end with the last collection, and the main process takes
# its threads back.
CPU_WORKERS = 1
CPU_WORKER_THREADS = 3
CPU_WORKER_NICE = 19
CPU_REFS = {}  # job name -> Future
CPU_POOL = []
MAIN_THREADS = []  # the main process's intra-op threads before the workers started


def cpu_jobs():
    """Job name -> ``cpu_reference``'s arguments (scenario, overrides, the
    scenario and overrides whose seeded init the card run used, a model
    config cut, whether to keep the final params), in the order the phases
    need them."""
    mk = MLP307K + MEGAKERNEL
    jobs = {"quickstart": ("quickstart", ())}
    jobs.update({name: (name, overrides) for name, overrides in (("int8_cloud", INT8_CLOUD),
                                                               ("int8_ef_both", INT8_EF_BOTH))})
    jobs["mlp307k_int8_ef"] = ("int8_ef_both", MLP307K)
    jobs["mlp307k_megakernel"] = ("hierfavg_edge_iid", mk + ["run.num_rounds=2"], ("hierfavg_edge_iid", MLP307K))
    jobs.update({name: (name, overrides) for name, overrides in (("trimmed_edge", ()), ("median_cloud", INT8_CLOUD),
                                                               ("trimmed_int8", INT8_CLOUD))})
    for name in ("deadline_straggler", "fedbuff_k4", "stale_decay"):
        jobs[name] = (name, DEADLINE_RUN, None, None, True)
    jobs["mlp307k_deadline"] = ("deadline_straggler", MLP307K, ("hierfavg_edge_iid", MLP307K), None, True)
    jobs["n1m_cohort4096"] = ("n1m_cohort4096", ["run.num_rounds=2"], ("n1m_cohort4096", ()), None, True)
    jobs["mlp307k_cohort"] = None  # cohort_cpu_reference
    for phase, overrides in (("train_lm10m", LM_TRAIN), ("train_lm10m_int8_ef", LM_INT8_EF)):
        jobs[phase] = ("lm_edge_niid", overrides, None, None, True)
    jobs["train_lm100m"] = ("lm_edge_niid", LM100M + LM100M_CPU_ROUND, ("lm_edge_niid", LM100M + LM_TRAIN))
    for opt in ("adam", "sgd"):
        jobs[f"xlstm_cut_{opt}"] = ("lm_edge_niid", XLSTM + XLSTM_CUT_RUN + [f"model.optimizer={opt}"],
                                    ("lm_edge_niid", XLSTM + XLSTM_CUT_RUN), XLSTM_CUT, True)
    return jobs


def cpu_reference(name, overrides, init=None, cut=None, keep_params=False):
    """(In a worker.) ``run_scenario`` on the CPU from the seeded init of
    ``init``'s scenario (default: this one's), under ``lm_config_cut(**cut)``:
    its records, round count, seconds and (``keep_params``) final params
    as numpy leaves in ``tree.leaves`` order."""
    import os

    import torch

    from repro_torch.fed import scenarios
    from repro_torch.tree import leaves

    if os.nice(0) < CPU_WORKER_NICE:  # the main process, driving the card, goes first
        os.nice(CPU_WORKER_NICE - os.nice(0))
    torch.set_num_threads(CPU_WORKER_THREADS)
    with lm_config_cut(**cut) if cut else contextlib.nullcontext():
        params = None
        if init is not None:
            ref = scenarios.get(init[0], overrides=list(init[1]))
            params = ref.init_params(ref.run.seed + 1, "cpu")
        runner, state, seconds, _, _ = run_scenario(torch, (), name, list(overrides), "cpu", params=params)
    return {"history": runner.history, "num_rounds": runner.cfg.num_rounds, "seconds": seconds,
            "gated_intervals": getattr(runner._engine, "gated_intervals", None),
            "params": [x.detach().float().numpy() for x in leaves(state.params)] if keep_params else None,
            "done_at": time.time()}


def cohort_cpu_reference():
    """(In a worker.) ``mlp307k_cohort``'s two CPU runs from mlp307k's init:
    the cohort run spied (``spy_cohort_engine``: the params after each
    interval), with its records, final params and its store's rows at the
    drawn ids and at those ids rolled by one (the control's), as numpy;
    and the no-cohort control's final params and sticky optimizer rows."""
    import numpy as np
    import torch

    from repro_torch.fed import scenarios
    from repro_torch.fed.client_store import sticky_rows
    from repro_torch.tree import leaves

    torch.set_num_threads(CPU_WORKER_THREADS)
    ref = scenarios.get("hierfavg_edge_iid", overrides=MLP307K)
    params = ref.init_params(ref.run.seed + 1, "cpu")
    after = []
    runner, state, *_ = run_scenario(torch, (), "hierfavg_edge_iid", MLP307K + COHORT_MLP, "cpu", params,
                                     spy=lambda r: spy_cohort_engine(r, after))
    ids = drawn_ids(runner)
    store = runner.client_store.state()["leaves"]
    out = {"history": runner.history, "num_rounds": runner.cfg.num_rounds, "seconds": 0.0, "gated_intervals": None,
           "params": [x.numpy() for x in leaves(state.params)],
           "after": [{k: v.numpy() for k, v in p.items()} for p in after],
           "store_rows": [x[ids] for x in store], "store_rows_rolled": [x[np.roll(ids, 1)] for x in store]}
    control = MLP307K + [o for o in COHORT_MLP if o.startswith(("model.", "transport."))]
    _, c_state, *_ = run_scenario(torch, (), "hierfavg_edge_iid", control, "cpu", params)
    out["control_params"] = [x.numpy() for x in leaves(c_state.params)]
    out["control_opt"] = [x.numpy() for x in sticky_rows(c_state, 32)["opt"]]
    out["done_at"] = time.time()
    return out


class CpuRun:
    """What the checks read of a CPU run made in a worker: ``history``,
    ``cfg.num_rounds``, and ``state.params`` (a list of leaves)."""

    def __init__(self, out):
        import types

        import torch

        self.history, self.seconds, self.gated_intervals = out["history"], out["seconds"], out["gated_intervals"]
        self.cfg = types.SimpleNamespace(num_rounds=out["num_rounds"])
        params = None if out["params"] is None else [torch.from_numpy(x) for x in out["params"]]
        self.state = types.SimpleNamespace(params=params)


def start_cpu_refs():
    """Submit every ``cpu_jobs`` entry to CPU_WORKERS spawned processes, and
    leave the main process the other cores' worth of intra-op threads."""
    import concurrent.futures
    import multiprocessing
    import os

    import torch

    pool = concurrent.futures.ProcessPoolExecutor(CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    CPU_POOL.append(pool)
    for key, args in cpu_jobs().items():
        CPU_REFS[key] = pool.submit(cohort_cpu_reference) if args is None else pool.submit(cpu_reference, *args)
    MAIN_THREADS.append(torch.get_num_threads())
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) - CPU_WORKERS * CPU_WORKER_THREADS))


def cpu_ref(key) -> CpuRun:
    """The worker's run for ``key``, waiting for it if it is not done; the
    seconds the phase waited, and when (from the start) the worker finished
    it, are kept (``CPU_WAITS``, ``CPU_DONE``)."""
    t0 = time.perf_counter()
    out = CPU_REFS.pop(key).result()
    CPU_WAITS[key] = time.perf_counter() - t0
    CPU_DONE[key] = out["done_at"] - T0_WALL
    if not CPU_REFS:
        stop_cpu_refs()
    run = CpuRun(out)
    run.extra = {k: v for k, v in out.items() if k not in ("history", "num_rounds", "seconds", "params", "done_at")}
    return run


CPU_WAITS = {}
CPU_DONE = {}


CHILDREN = []  # subprocesses a phase started and collects later (the dry run's)


def stop_cpu_refs():
    """End the workers, the running jobs too (a failed check leaves them),
    and give the main process its intra-op threads back."""
    for pool in CPU_POOL:
        for proc in list(getattr(pool, "_processes", {}).values()):
            proc.terminate()
        pool.shutdown(wait=True, cancel_futures=True)
    CPU_POOL.clear()
    if MAIN_THREADS:
        import torch

        torch.set_num_threads(MAIN_THREADS.pop())


def host_cpus() -> dict:
    """The cores this process may run on and the cgroup's CPU quota (read
    only), beside the wall: a host that throttles its cgroup slows every
    process in it, whatever its priority."""
    import os

    quota = None
    for path in ("/sys/fs/cgroup/cpu.max", "/sys/fs/cgroup/cpu/cpu.cfs_quota_us"):
        try:
            quota = Path(path).read_text().strip()
            break
        except OSError:
            continue
    return {"affinity": len(os.sched_getaffinity(0)), "cpu_count": os.cpu_count(), "cgroup_cpu_max": quota}


def stop_all():
    """The workers and the subprocesses still running (a failed check
    leaves them)."""
    for child in CHILDREN:
        child.kill()
    CHILDREN.clear()
    stop_cpu_refs()


def history_agreement(runner, ref_runner, what, prefix):
    """Per-round losses within rtol 1e-4 and accuracies within 0.01 of
    ``ref_runner``'s, checked. A round whose reference loss is exactly 0
    (the full-width MLP separates its data and the cross-entropy
    underflows) is held to |loss| <= 1e-6 instead."""
    n = ref_runner.cfg.num_rounds  # a shorter reference holds the run's first rounds
    check(len(runner.history) >= n == len(ref_runner.history) and n <= runner.cfg.num_rounds, f"{what} rounds")
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


def cpu_agreement(runner, key, name):
    """The same run on the CPU (plain versions) from the same init, made by
    a worker (``cpu_ref(key)``; a shorter one holds the first rounds), held
    to ``history_agreement``."""
    return history_agreement(runner, cpu_ref(key), f"{name} cuda vs cpu", "cpu")


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
    low = name.lower()
    if any(t in low for t in ("convolution", "convolve", "conv2d", "conv_depthwise", "fprop", "dgrad", "wgrad",
                              "winograd", "fft2d", "flip_filter", "cudnn", "nchwtonhwc", "nhwctonchw")):
        return "convolutions"  # cuDNN's kernels and its layout transposes (the paper's CNNs)
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
    if "gemm" in low or "gemv" in low or "cutlass" in low or "matmul" in low or "nvjet" in low:
        return "matrix products"
    return "other"


def device_events(torch, prof):
    """(name, start us, end us) of every device-side record of a finished
    ``torch.profiler`` run (kernels, copies, memsets; annotation ranges
    left out), read from kineto's raw records: tracing host ops too and
    building the profiler's ``FunctionEvent`` list made the trace reading
    most of a profiled call's cost at tens of thousands of records."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events() if e.device_type() == cuda and not e.is_user_annotation()]


def busy_us(events) -> float:
    """The device's busy time: the union of the records' spans. cuDNN runs
    a grouped convolution's kernels on several streams at once (a CIFAR-10
    interval's kernels sum to about 3x their union), so the sum overstates
    it."""
    total, start, end = 0.0, None, None
    for _, s, e in sorted(events, key=lambda ev: ev[1]):
        if end is None or s > end:
            total += 0.0 if end is None else end - start
            start, end = s, e
        else:
            end = max(end, e)
    return total + (0.0 if end is None else end - start)


def by_kernel(events):
    """Device us summed by kernel class and by kernel name."""
    by_class, by_name = {}, {}
    for name, s, e in events:
        by_class[kernel_class(name)] = by_class.get(kernel_class(name), 0.0) + e - s
        by_name[name] = by_name.get(name, 0.0) + e - s
    return by_class, by_name


def device_profile(torch, mods, name, overrides, params):
    """Where the device time of a warm ``runner.run`` goes, per cloud
    interval: the run once more timed, then once under ``torch.profiler``
    tracing the device alone (kernels, copies, memsets; busy time the union
    of their spans, ``busy_us``)."""
    from torch.profiler import ProfilerActivity, profile

    runner, _, warm_s, *_ = run_scenario(torch, mods, name, overrides, "cuda", params)
    prof = profile(activities=[ProfilerActivity.CUDA])
    _, _, window_s, *_ = run_scenario(torch, mods, name, overrides, "cuda", params, profiler=prof)
    events = device_events(torch, prof)
    by_class, by_name = by_kernel(events)
    busy = busy_us(events)
    check(busy > 0, f"{name}: the profiler saw no device time")
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
        "device_busy_ms_per_interval": busy / 1e3 / intervals,
        "device_busy_share_of_warm_wall": busy / 1e6 / warm_s,
        "device_idle_share_profiled": 1.0 - busy / 1e6 / window_s,
        "device_ops_per_interval": len(events) / intervals,
        "busy_ms_per_interval_by_class": {k: v / 1e3 / intervals for k, v in sorted(by_class.items())},
        "top_kernels_ms_per_interval": [[n[:90], v / 1e3 / intervals] for n, v in top],
    }


def attention_cases():
    """(label, B, S, H, Hkv, hd, window, dtype name[, v head dim where it is
    not hd]); K7 is causal on every path of the port."""
    cases = [(f"jax case s{s} window {w}", 3, s, 1, 1, 64, w, dt)
             for s, w in ((128, 0), (200, 0), (256, 33), (120, 64)) for dt in ("float32", "bfloat16")]
    return cases + [
        ("kernel_bench (4 x 1024 x 64)", 4, 1024, 1, 1, 64, 0, "bfloat16"),
        ("lm-100m prefill", 4, 1024, 12, 4, 64, 0, "float32"),
        ("lm-100m prefill, one of 2 model ranks", 4, 1024, 6, 2, 64, 0, "float32"),
        ("recurrentgemma-9b prefill", 2, 4096, 16, 1, 256, 2048, "bfloat16"),
        # tp_recurrentgemma9b_m2's and tp_deepseekv3_l1_m2's ranks: 8 of the
        # 16 query heads over the one KV head; 64 of MLA's 128 heads with v
        # head dim 128 (K7 takes v zero-padded to the q/k head dim 192, as
        # mla_attention pads it; the plain version, SDPA and the bound take
        # the 128-wide v)
        ("recurrentgemma-9b prefill, one of 2 model ranks", 2, 4096, 8, 1, 256, 2048, "bfloat16"),
        ("deepseek-v3 MLA prefill, one of 2 model ranks (v 128, padded to 192 for K7)", 1, 4096, 64, 64, 192,
         0, "bfloat16", 128),
        ("yi-9b prefill", 1, 4096, 32, 4, 128, 0, "bfloat16"),
    ]


def visible_pairs(s: int, window: int) -> int:
    """(query, key) pairs of a causal self-attention of length s that a
    window (0: none) leaves visible."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def k7_bound(b, s, h, hkv, hd, window, isz, dv=None):
    """(bound ms, "bytes" or "operations") of one causal attention with q/k
    head dim hd and v head dim dv (default hd): q, k, v read once and out
    written once at the HBM rate, against 2 (hd + dv) operations per visible
    pair per query head at the tensor cores' bf16 rate (bf16) or the f32 rate
    without TF32 (f32)."""
    dv = hd if dv is None else dv
    nbytes = b * s * (h + hkv) * (hd + dv) * isz
    flops = 2 * (hd + dv) * visible_pairs(s, window) * b * h
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
    flush = flush_buffer(torch)
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows, summary, paths = [], {}, {}
    for label, b, s, h, hkv, hd, window, dname, *dv in attention_cases():
        dtype, dv = getattr(torch, dname), (dv[0] if dv else hd)
        q, k, v = (torch.randn((b, s, n, w), generator=gen, device="cuda").to(dtype)
                   for n, w in ((h, hd), (hkv, hd), (hkv, dv)))
        vk = v if dv == hd else torch.nn.functional.pad(v, (0, hd - dv))
        kernel = lambda: fa.attention(q, k, vk, causal=True, window=window)  # noqa: E731
        got, again = kernel()[..., :dv], kernel()[..., :dv]
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
            paths[dname] = k7_path(torch, kernel)
        path = paths[dname]
        want_path = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
        check(path == want_path, f"{what}: ran the {path} template, want {want_path}")
        library = sdpa_call(torch, q, k, v, window)
        lib_err = float((library().transpose(1, 2).float() - want.float()).abs().max())
        bound, bound_by = k7_bound(b, s, h, hkv, hd, window, q.element_size(), dv)
        big = s >= 4096
        row = {"kernel": "flash_attention", "case": label, "b": b, "s": s, "h": h, "hkv": hkv, "hd": hd,
               "dv": dv,
               "window": window, "dtype": dname, "path": path, "max_abs_err": float(diff.max()),
               "rms_err_rel": rms, "max_err_over_tol": float((diff / tol).max()), "control_window_plus_1": control,
               "bit_equal_relaunch": True,
               "visible_pairs_per_head": visible_pairs(s, window),
               "ms": time_ms(kernel, flush=flush, reps=10 if big else 25),
               "plain_ms": time_ms(lambda: fa.attention_plain(q, k, v, causal=True, window=window), flush=flush,
                                   reps=5, warmup=1),
               "bound_ms": bound, "bound_by": bound_by,
               "library_ms": time_ms(library, flush=flush, reps=10 if big else 25),
               "library_max_abs_err": lib_err}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        if label == "recurrentgemma-9b prefill":
            summary["flash_attention"] = {k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                               "library_ms")}
        del q, k, v, vk, kernel, got, again, want, diff
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
              ("recurrentgemma-9b prefill, one of 2 model ranks", 2, 4096, 2048, "float32"),
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
    cpu_runner = cpu_ref(phase)
    cpu_state, cpu_secs = cpu_runner.state, cpu_runner.seconds
    agreement = lm_agreement(runner, cpu_runner, f"{phase} cuda vs cpu")
    emit({"phase": phase, **path_report(runner, secs, launches, {
        "arch": runner.spec.model.arch, "transport": runner.spec.transport.levels, "launches_want": want,
        "losses": losses, "grad_norms": [h.grad_norm for h in runner.history],
        "wire_mb": runner.history[-1].wire_mb, "cpu": agreement, "cpu_seconds": cpu_secs,
        "params_max_abs_err_vs_cpu": params_max_err(state, cpu_state),
        "phase_seconds": time.perf_counter() - t0})})
    return launches


def phase_train_lm100m(torch, mods):
    """``lm_edge_niid`` at lm-100m's full width: 8 rounds on the card; one
    round of one local step on the card and on the CPU, against each other;
    then one warm cloud interval profiled."""
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
    REFS["lm100m"] = stash(runner, state)
    del state
    torch.cuda.empty_cache()
    # card against the CPU over one round of one local step and its edge
    # sync (LM100M_CPU_ROUND), from the same init
    card_round, *_ = run_scenario(torch, mods, "lm_edge_niid", LM100M + LM100M_CPU_ROUND, "cuda", params=params)
    cpu_runner = cpu_ref("train_lm100m")
    cpu_s = cpu_runner.seconds
    agreement = lm_agreement(card_round, cpu_runner, "train_lm100m round 0 cuda vs cpu", rounds=1)
    profile = device_profile(torch, mods, "lm_edge_niid", LM100M + ["run.num_rounds=2"], params)
    REFS["lm100m_peak_memory_bytes"] = peak
    REFS["lm100m_warm_wall_ms_per_interval"] = profile["warm_wall_ms_per_interval"]
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
    cpu_runner = cpu_ref(name)
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


def store_rows_agreement(state, cohort_size, store, ref_rows, ids):
    """A run's store at the rows ``ids`` against ``ref_rows`` (a reference
    store's rows, leaf by leaf), relative to the reference leaf's largest
    |value|: the optimizer rows' largest difference, and for each residual
    leaf (the share of values further apart than COHORT_STORE_RES_RTOL of
    it, the largest difference): an int8 code that rounds the other way
    moves a residual by a whole code step."""
    import numpy as np

    from repro_torch.fed.client_store import sticky_rows

    n_opt = len(sticky_rows(state, cohort_size)["opt"])
    opt, res = [], []
    for i, (a, b) in enumerate(zip(store.state()["leaves"], ref_rows)):
        a, b = a[ids].astype(np.float64), b.astype(np.float64)
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
    REFS["n1m_cohort4096"] = stash(runner, state)
    cpu_runner = cpu_ref("n1m_cohort4096")
    cpu_state = cpu_runner.state
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

    import types

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
    card_params = []
    spied, spied_state, *_ = run_scenario(torch, mods, "hierfavg_edge_iid", overrides, "cuda", mlp_params,
                                          spy=lambda r: spy_cohort_engine(r, card_params))
    cpu_runner = cpu_ref("mlp307k_cohort")  # the same spied run on the CPU, in a worker
    cpu_state = cpu_runner.state
    cpu_params = [{k: torch.from_numpy(v) for k, v in p.items()} for p in cpu_runner.extra["after"]]
    check(all(bit_equal(spied_state.params[k], state.params[k]) for k in state.params),
          "mlp307k_cohort: the spied card run differs from the first")
    agreement = history_agreement(runner, cpu_runner, "mlp307k_cohort cuda vs cpu", "cpu")
    check(len(card_params) == len(cpu_params) == 4, "mlp307k_cohort: params after 4 intervals")
    interval_err = [max(float((a[k] - b[k]).abs().max()) for k in a) for a, b in zip(card_params, cpu_params)]
    check(max(interval_err) <= COHORT_PARAMS_ATOL, f"mlp307k_cohort params vs cpu by interval: {interval_err}")
    opt_err, res_off = store_rows_agreement(spied_state, 32, spied.client_store, cpu_runner.extra["store_rows"],
                                            distinct)
    check(max(opt_err) <= COHORT_STORE_RTOL, f"mlp307k_cohort store: optimizer rows {opt_err} of the leaf's largest")
    check(max(share for share, _ in res_off) <= COHORT_STORE_RES_SHARE,
          f"mlp307k_cohort store: residual values off {res_off}")
    # the store comparison's control: the CPU's rows of the next drawn
    # client in place of each client's own must fail it
    shifted_opt, shifted_res = store_rows_agreement(spied_state, 32, spied.client_store,
                                                    cpu_runner.extra["store_rows_rolled"], distinct)
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
    del cpu_state
    # the control: the same optimizer and codec without participation (the
    # 32 clients of mlp307k), card against CPU; Adam moves a coordinate
    # whose gradient is near zero by about lr whatever its size, so the two
    # devices' roundings part by this much with or without cohorts
    control = MLP307K + [o for o in COHORT_MLP if o.startswith(("model.", "transport."))]
    _, c_state, *_ = run_scenario(torch, mods, "hierfavg_edge_iid", control, "cuda", mlp_params)
    c_cpu_state = types.SimpleNamespace(params=[torch.from_numpy(x) for x in cpu_runner.extra["control_params"]])
    control_err = params_max_err(c_state, c_cpu_state)
    control_opt = [float((a.cpu() - b).abs().max() / (b.abs().max() or 1.0))
                   for a, b in zip(sticky_rows(c_state, 32)["opt"],
                                   [torch.from_numpy(x) for x in cpu_runner.extra["control_opt"]])]
    check(control_err <= COHORT_PARAMS_ATOL and max(control_opt) <= COHORT_STORE_RTOL,
          f"mlp307k_cohort control (no cohorts) vs cpu: params {control_err}, optimizer rows {control_opt}")
    del c_state, c_cpu_state, cpu_runner

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


def deadline_vs_cpu(runner, state, name, key):
    """The same run on the CPU from the same init (a worker's, ``cpu_ref(key)``):
    losses and accuracies (``history_agreement``), survivors and the event
    clock equal, final params within DEADLINE_PARAMS_ATOL, the same gated
    intervals."""
    cpu = cpu_ref(key)
    c_state = cpu.state
    agreement = history_agreement(runner, cpu, f"{name} cuda vs cpu", "cpu")
    check([h.mask_alive for h in runner.history] == [h.mask_alive for h in cpu.history], f"{name}: survivors differ")
    check([h.wall_clock_s for h in runner.history] == [h.wall_clock_s for h in cpu.history],
          f"{name}: wall_clock_s differs from the CPU run's")
    err = params_max_err(state, c_state)
    check(err <= DEADLINE_PARAMS_ATOL, f"{name}: params {err} from the CPU run's")
    check(cpu.gated_intervals == runner._engine.gated_intervals, f"{name}: gated intervals differ")
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
        agreement = deadline_vs_cpu(runner, state, name, name)
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
    agreement = deadline_vs_cpu(runner, state, name, "mlp307k_deadline")
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


def profile_call(torch, fn, ranges=()):
    """One call under torch.profiler: wall ms (host clock to a synchronise),
    device-busy ms (the union of the device records' spans), ms by kernel
    class, busy share of the wall, top kernels. The device alone is traced
    unless ``ranges`` names ``record_function`` ranges: then host ops are
    traced too (which slows the call: an xlstm-350m local step took 5.06 s
    so against 2.36 s on an H100), and for each range its host ms and the
    device ms of the kernels launched inside it, summed over its ranges.
    A trace that lost records is taken again (``bracketed_trace``), so
    ``fn`` must give the same result when called twice."""
    from torch.profiler import ProfilerActivity

    prof, events, wall, _ = bracketed_trace(
        torch, fn, [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ranges else []))
    by_class, by_name = by_kernel(events)
    busy = busy_us(events)
    check(busy > 0, "the profiler saw no device time")
    out = {"wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3, "device_busy_share": busy / 1e6 / wall,
           "device_ops": len(events), "busy_ms_by_class": {k: v / 1e3 for k, v in sorted(by_class.items())},
           "top_kernels_ms": [[n[:90], v / 1e3] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]]}
    if ranges:
        marks = {r: [e for e in prof.events() if e.name == r and e.device_type == torch.autograd.DeviceType.CPU]
                 for r in ranges}
        out["ranges"] = {r: {"count": len(es), "host_ms": sum(e.cpu_time_total for e in es) / 1e3,
                             "device_ms": sum(e.device_time_total for e in es) / 1e3} for r, es in marks.items()}
    return out


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


@contextlib.contextmanager
def around_slstm(before, after):
    """Each sLSTM block's sequence pass runs between ``before()`` and
    ``after()`` while the block runs."""
    from repro_torch.models import recurrent

    inner = recurrent.slstm_sequence

    def wrapped(*a, **k):
        before()
        try:
            return inner(*a, **k)
        finally:
            after()

    recurrent.slstm_sequence = wrapped
    try:
        yield
    finally:
        recurrent.slstm_sequence = inner


def slstm_host_share(torch, fn):
    """One call of ``fn`` timed by the host clock to a synchronise, with the
    sLSTM passes timed the same way: (wall ms, sLSTM ms)."""
    spent, t = [0.0], [0.0]

    def start():
        torch.cuda.synchronize()
        t[0] = time.perf_counter()

    def stop():
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t[0]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with around_slstm(start, stop):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, spent[0] * 1e3


def slstm_profile(torch, fn):
    """``profile_call`` of ``fn`` with each sLSTM block's sequence pass in
    a ``record_function`` range: adds the ranges' host time and the device
    time of the kernels they launched, and their shares of the call's wall
    and device busy time."""
    from torch.profiler import record_function

    ranges = []
    with around_slstm(lambda: ranges.append(record_function("slstm_sequence").__enter__()),
                      lambda: ranges.pop().__exit__(None, None, None)):
        out = profile_call(torch, fn, ranges=("slstm_sequence",))
    r = out.pop("ranges")["slstm_sequence"]
    check(r["count"] > 0 and r["device_ms"] > 0, f"the profiler saw no sLSTM range: {r}")
    out["slstm"] = {**r, "host_share_of_wall": r["host_ms"] / out["wall_ms"],
                    "device_share_of_busy": r["device_ms"] / out["device_busy_ms"]}
    return out


def phase_serve_xlstm350m(torch, mods):
    """xlstm-350m uncut (bf16) through the serving entry point: no kernel
    on its path (mLSTM, sLSTM plain); decode against the chunkwise forward
    over P + 1 tokens (prefill(P + 1) takes whole chunks only); card
    against the CPU at full width and depth in f32 (an 8-token prompt held,
    the distance measured by prompt length), and on 2048 tokens through
    mLSTM layers alone (``xlstm_mlstm_card_vs_cpu``); the sLSTM layers' share of the
    prefill's host time, and a prefill of one chunk and a decode step
    profiled, with the sLSTM layers' shares."""
    import dataclasses

    from torch.utils._pytree import tree_leaves, tree_map

    from repro_torch.configs.base import param_count
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    cfg = get_config("xlstm-350m")
    B, P, G = 2, XLSTM_SERVE_PROMPT, 32
    torch.cuda.empty_cache()
    base = reset_peak(torch)
    with torch.no_grad():
        params = transformer.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    n_params = sum(t.numel() for t in tree_leaves(params))
    check(n_params == param_count(cfg) == 480_633_856, f"xlstm-350m has {n_params} parameters")
    out, launches = counted_serve(torch, mods, cfg, params, batch=B, prompt_len=P, gen=G)
    peak = torch.cuda.max_memory_allocated() - base
    check_launches(launches, {}, "serve_xlstm350m")
    check(tuple(out["tokens"].shape) == (B, G) and bool(torch.isfinite(out["prefill_logits"]).all()),
          "serve_xlstm350m: tokens or logits")
    warm, _ = counted_serve(torch, mods, cfg, params, batch=B, prompt_len=P, gen=G)
    del out["caches"], warm["caches"]

    x = torch.from_numpy(serve.make_prompts(cfg, B, P + 1, seed=1)).cuda()
    with torch.inference_mode():
        last, caches = transformer.prefill(params, cfg, x[:, :P], P + G)
        dec, _ = transformer.decode_step(params, cfg, caches, x[:, P],
                                         torch.full((B,), P, dtype=torch.int32, device="cuda"))
        chunkwise = transformer.forward(params, cfg, x)[:, -1]
    dec_err, dec_scale = max_err(dec, chunkwise)
    check(bool(torch.isfinite(dec).all()) and dec_err <= K_BF16 * dec_scale,
          f"serve_xlstm350m: decode vs forward(P+1) err {dec_err} (scale {dec_scale})")
    tok = last.argmax(-1).to(torch.int32)
    pos = torch.full((B,), P, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        wall_ms, slstm_ms = slstm_host_share(torch, lambda: transformer.prefill(params, cfg, x[:, :P], P + G))
        # the profiler's cost grows with the sLSTM's steps (150 device ops a
        # token a layer): profile one chunk's prompt
        prof_prefill = slstm_profile(torch, lambda: transformer.prefill(params, cfg, x[:, :XLSTM_PROFILE_P],
                                                                        XLSTM_PROFILE_P + 1))
        prof_decode = profile_call(torch, lambda: transformer.decode_step(params, cfg, caches, tok, pos))
    del caches, last, dec, chunkwise

    # card against the CPU at full width and depth in f32 (the same weights
    # upcast): every position's logits of an 8-token prompt within K_F32 of
    # the largest; the distance at each of XLSTM_CHAOS_PROMPTS measured (the
    # sLSTM's recurrence amplifies roundings), and bf16's at 256 tokens
    f32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    t0 = time.perf_counter()
    with torch.inference_mode():
        p32 = tree_map(lambda t: t.float(), params)
        cpu32 = tree_map(lambda t: t.cpu(), p32)
        chaos = {}
        for n in XLSTM_CHAOS_PROMPTS:
            prompt = torch.from_numpy(serve.make_prompts(cfg, 1, n, seed=2))
            card = transformer.forward(p32, f32, prompt.cuda())[0].float().cpu()
            cpu = transformer.forward(cpu32, f32, prompt)[0]
            rel = (card - cpu).abs().amax(-1) / cpu.abs().amax(-1)
            chaos[n] = {"max_rel_err": float(rel.max()), "last_rel_err": float(rel[-1])}
        short = torch.from_numpy(serve.make_prompts(cfg, 1, 256, seed=2))
        card16, _ = transformer.prefill(params, cfg, short.cuda(), 260)
        cpu16, _ = transformer.prefill(tree_map(lambda t: t.cpu(), params), cfg, short, 260)
    cpu_s = time.perf_counter() - t0
    cpu_err = chaos[XLSTM_CHECK_PROMPT]["max_rel_err"]
    check(cpu_err <= K_F32, f"serve_xlstm350m: f32 card vs CPU logits rel err {cpu_err} at {XLSTM_CHECK_PROMPT}")
    del p32, cpu32
    mlstm_long = xlstm_mlstm_card_vs_cpu(torch, cfg)
    bf16_err, bf16_scale = max_err(card16, cpu16)
    del params
    torch.cuda.empty_cache()
    emit({"phase": "serve_xlstm350m", "arch": cfg.name, "params": n_params, "dtype": "bfloat16",
          "layers": {k: cfg.block_pattern.count(k) * cfg.num_superblocks for k in ("mlstm", "slstm")},
          "batch": B, "prompt_len": P, "gen": G, **serve_report(out, warm, launches),
          "launches_per_prefill": {}, "peak_memory_bytes": peak,
          "decode_vs_chunkwise_forward": {"position": P, "max_abs_err": dec_err, "max_abs_logit": dec_scale,
                                          "tolerance": f"{K_BF16} x max |logit|"},
          "card_vs_cpu": {"dtype": "float32", "prompt_len": XLSTM_CHECK_PROMPT, "max_rel_err": cpu_err,
                          "tolerance": f"{K_F32} x max |logit| at every position",
                          "f32_by_prompt_len": chaos, "seconds": cpu_s,
                          "bf16_prompt_256": {"max_abs_err": bf16_err, "max_abs_logit": bf16_scale},
                          "mlstm_only": mlstm_long},
          "prefill_host": {"wall_ms": wall_ms, "slstm_ms": slstm_ms, "slstm_share_of_wall": slstm_ms / wall_ms},
          "profile_prefill": {"batch": B, "prompt_len": XLSTM_PROFILE_P, **prof_prefill},
          "profile_decode_step": prof_decode})
    return launches


def xlstm_mlstm_card_vs_cpu(torch, cfg):
    """Card against the CPU in f32 at xlstm-350m's widths over a
    ``XLSTM_MLSTM_PROMPT``-token prompt, on a cut of ``XLSTM_MLSTM_CUT``
    (mLSTM blocks alone: the sLSTM's chaos stays out, the chunks' carry is
    in): the logits at every position and the last position's from the
    prefill within K_F32 of the largest, and each layer's carry (C, n, m)
    after the prefill within K_F32 of its largest; checked."""
    import dataclasses

    from torch.utils._pytree import tree_flatten_with_path, tree_map

    from repro_torch.launch import serve
    from repro_torch.models import transformer

    cut = dataclasses.replace(cfg, **XLSTM_MLSTM_CUT)
    t0 = time.perf_counter()
    with torch.no_grad():
        cpu_p = transformer.init_params(torch.Generator().manual_seed(4), cut)
    card_p = tree_map(lambda t: t.cuda(), cpu_p)
    prompt = torch.from_numpy(serve.make_prompts(cut, 1, XLSTM_MLSTM_PROMPT, seed=5))
    with torch.inference_mode():
        logits = {dev: transformer.forward(p, cut, prompt.to(dev))[0].float().cpu()
                  for dev, p in (("cuda", card_p), ("cpu", cpu_p))}
        last = {dev: transformer.prefill(p, cut, prompt.to(dev), XLSTM_MLSTM_PROMPT + 1)
                for dev, p in (("cuda", card_p), ("cpu", cpu_p))}
    rel = ((logits["cuda"] - logits["cpu"]).abs().amax(-1) / logits["cpu"].abs().amax(-1))
    out = {"config": {k: list(v) if isinstance(v, tuple) else v for k, v in XLSTM_MLSTM_CUT.items()},
           "prompt_len": XLSTM_MLSTM_PROMPT, "chunks": XLSTM_MLSTM_PROMPT // cut.mlstm_chunk,
           "logits_max_rel_err": float(rel.max()),
           "prefill_last_rel_err": float((last["cuda"][0].cpu() - last["cpu"][0]).abs().max()
                                         / last["cpu"][0].abs().max()),
           "tolerance": f"{K_F32} x the largest |value|"}
    carries = {}
    for (path, got), (_, want) in zip(tree_flatten_with_path(last["cuda"][1])[0],
                                      tree_flatten_with_path(last["cpu"][1])[0]):
        name = path[-1].key
        err = float((got.cpu() - want).abs().max() / want.abs().max().clamp_min(1e-30))
        carries[name] = max(carries.get(name, 0.0), err)
    out["carry_max_rel_err"] = carries
    out["seconds"] = time.perf_counter() - t0
    check(sorted(carries) == ["C", "m", "n"], f"serve_xlstm350m mLSTM cut: carries {sorted(carries)}")
    check(max(out["logits_max_rel_err"], out["prefill_last_rel_err"], *carries.values()) <= K_F32,
          f"serve_xlstm350m mLSTM cut: card vs CPU at {XLSTM_MLSTM_PROMPT} tokens {out}")
    return out


@contextlib.contextmanager
def lm_config_cut(**changes):
    """The LM scenarios' model config with ``changes`` (a cut of depth or
    dtype) while the block runs."""
    import dataclasses

    from repro_torch.fed import api

    full = api._lm_config
    api._lm_config = lambda spec: dataclasses.replace(full(spec), **changes)
    try:
        yield
    finally:
        api._lm_config = full


def phase_train_xlstm350m(torch, mods):
    """``lm_edge_niid`` on xlstm-350m at its published widths and depth (4
    clients on 2 edges, kappa (4, 2), Adam with warmup-cosine, 2 rounds):
    K1 on every leaf at every sync, losses finite and falling, params
    finite, f32 exactly on the gate, recurrence and bias leaves; one local
    step of the run's final state profiled, K1 timed on every leaf at the
    interval's syncs (the warm re-run of the interval was cut for the
    script's wall: the first call's wall is reported); then one cloud
    interval at 4 layers in f32, card against the CPU
    (``xlstm_cut_vs_cpu``)."""
    import math

    from torch.utils._pytree import tree_flatten_with_path

    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    base = reset_peak(torch)
    runner, state, secs, launches, params = run_scenario(torch, mods, "lm_edge_niid", XLSTM_TRAIN + XLSTM_TRAIN_ROUNDS,
                                                          "cuda")
    peak = torch.cuda.max_memory_allocated() - base
    want = lm_launches(runner, state, 0)
    check_launches(launches, want, "train_xlstm350m")
    n_leaves = len(list(leaves(state.params)))
    check(n_leaves == 41 and want["grouped_mean"] == 3 * n_leaves, f"train_xlstm350m: {n_leaves} leaves, {want}")
    n_params = sum(x[0].numel() for x in leaves(state.params))
    f32_leaves = sorted({path[-1].key for path, x in tree_flatten_with_path(state.params)[0]
                         if x.dtype == torch.float32})
    check(f32_leaves == ["a_f", "a_i", "b", "r_f", "r_i", "r_o", "r_z"] and all(
        x.dtype in (torch.float32, torch.bfloat16) for x in leaves(state.params)),
        f"train_xlstm350m: f32 leaves {f32_leaves}")
    wq = state.params["blocks"]["b0"]["cell"]["wq"]
    check(tuple(wq.shape) == (4, 6, 2048, 2048) and wq.dtype == torch.bfloat16, f"train_xlstm350m wq {wq.shape}")
    losses = [h.loss for h in runner.history]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], f"train_xlstm350m losses {losses}")
    check(all(bool(torch.isfinite(x).all()) for x in leaves(state.params)), "train_xlstm350m params not finite")
    del params
    profile = xlstm_interval_profile(torch, runner, state, launches)
    del state
    torch.cuda.empty_cache()
    cut_vs_cpu = xlstm_cut_vs_cpu(torch, mods)
    emit({"phase": "train_xlstm350m", **path_report(runner, secs, launches, {
        "arch": runner.spec.model.arch, "params_per_client": n_params, "clients": runner.topology.num_clients,
        "edges": runner.topology.num_edges, "leaves": n_leaves, "f32_leaves": f32_leaves, "cuts": XLSTM_TRAIN_CUTS,
        "tokens_per_local_step": runner.topology.num_clients * runner.spec.data.batch_size * runner.spec.data.seq_len,
        "launches_want": want, "losses": losses, "grad_norms": [h.grad_norm for h in runner.history],
        "first_call_wall_s": secs, "allocated_at_start_bytes": base, "peak_memory_bytes": peak,
        "profile": profile, "cut_vs_cpu": cut_vs_cpu,
        "phase_seconds": time.perf_counter() - t0})})
    return launches


def xlstm_cut_vs_cpu(torch, mods):
    """One cloud interval (round 0 ends in an edge sync, round 1 in the
    cloud sync) of ``lm_edge_niid`` on xlstm-350m cut to ``XLSTM_CUT``, on
    4 clients over 2 edges, on the card and on the CPU from one init, with
    the scenario's Adam and with SGD: both rounds' losses within LM_RTOL
    (round 1's steps start from the edge means), and SGD's params after
    the cloud sync within XLSTM_CUT_PARAMS_ATOL. Adam's params are
    reported: where a gradient is near zero, Adam's step is near +-lr
    whatever the gradient's size, so two devices' roundings of it can part
    by lr a step. Checked."""
    from repro_torch.fed import scenarios
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    out = {"config": XLSTM_CUT, "clients": 4, "edges": 2, "rounds": 2, "seq_len": XLSTM_CHECK_PROMPT,
           "tolerance": {"loss_rtol": LM_RTOL, "sgd_params_atol": XLSTM_CUT_PARAMS_ATOL}}
    with lm_config_cut(**XLSTM_CUT):
        cut = scenarios.get("lm_edge_niid", overrides=XLSTM + XLSTM_CUT_RUN)
        cut_params = cut.init_params(cut.run.seed + 1, "cpu")
        for opt in ("adam", "sgd"):
            overrides = XLSTM + XLSTM_CUT_RUN + [f"model.optimizer={opt}"]
            card, card_state, _, launches, _ = run_scenario(torch, mods, "lm_edge_niid", overrides, "cuda",
                                                            params=cut_params)
            cpu = cpu_ref(f"xlstm_cut_{opt}")
            cpu_state = cpu.state
            pairs = list(zip(card.history, cpu.history))
            check(len(pairs) == 2 and launches["grouped_mean"] == 3 * len(list(leaves(card_state.params))),
                  f"train_xlstm350m cut {opt}: rounds {len(pairs)}, launches {launches}")
            out[opt] = {"loss_rel_err": [abs(a.loss - b.loss) / abs(b.loss) for a, b in pairs],
                        "grad_norm_rel_err": [abs(a.grad_norm - b.grad_norm) / abs(b.grad_norm) for a, b in pairs],
                        "params_max_abs_err": params_max_err(card_state, cpu_state),
                        "launches": launches["grouped_mean"]}
            del card_state, cpu_state
    check(max(out["adam"]["loss_rel_err"] + out["sgd"]["loss_rel_err"]) <= LM_RTOL
          and out["sgd"]["params_max_abs_err"] <= XLSTM_CUT_PARAMS_ATOL, f"train_xlstm350m cut: {out}")
    out["seconds"] = time.perf_counter() - t0
    return out


def xlstm_interval_profile(torch, runner, state, launches):
    """On the xlstm-350m run's final state: one local step (the clients'
    grad(vmap(loss))) under the profiler, since a whole interval's 380,000
    device ops take the profiler minutes to read; K1 timed (CUDA events) on
    every leaf at the interval's three stages (the edge sync, and the cloud
    sync's edge and root stages), and on the largest leaf beside its bound
    and its plain version."""
    from repro_torch.core import hierfavg
    from repro_torch.kernels import hier_aggregate as ha
    from repro_torch.tree import leaves

    intervals = runner.cfg.num_rounds / runner.hier_config.kappa2_effective
    batch = {k: torch.from_numpy(v).cuda() for k, v in runner.batcher.next_batch().items()}
    grad_fn = hierfavg._client_grads(runner.loss_fn, runner.hier_config.precision)
    grad_fn(state.params, batch, None)  # warm
    step = profile_call(torch, lambda: grad_fn(state.params, batch, None))
    flush = flush_buffer(torch)
    n, edges = runner.topology.num_clients, runner.topology.num_edges
    w = torch.ones(n, device="cuda")
    k1_ms, largest = 0.0, None
    for leaf in leaves(state.params):
        rows = leaf.reshape(n, -1)
        edge_ms = time_ms(lambda: ha.grouped_mean(rows, w, edges), flush=flush, reps=5)
        k1_ms += 2 * edge_ms + time_ms(lambda: ha.grouped_mean(rows[:edges], w[:edges], 1), flush=flush, reps=5)
        if largest is None or rows.numel() > largest["rows"][0] * largest["rows"][1]:
            nbytes = 2 * rows.numel() * rows.element_size() + n * 4  # rows read and written, weights read
            largest = {"rows": list(rows.shape), "dtype": str(rows.dtype).replace("torch.", ""), "groups": edges,
                       "ms": edge_ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                       "plain_ms": time_ms(lambda: ha.grouped_mean_plain(rows, w, edges), flush=flush, reps=5)}
    del flush
    steps = runner.hier_config.kappa1 * runner.hier_config.kappa2_effective
    return {"cloud_intervals": intervals, "local_steps_per_interval": steps, "local_step": step,
            "local_step_busy_share": step["device_busy_share"],
            "k1_ms_per_interval": k1_ms, "k1_launches_per_interval": launches["grouped_mean"] / intervals,
            "k1_largest_leaf": largest}


def xlstm_train_memory(torch, mods):
    """``lm_edge_niid`` on xlstm-350m at full width: 4 clients over 2 edges
    for one cloud interval and for four (the peak must not grow after the
    first: the engine writes each interval back into the caller's state),
    then with remat, then 8 clients without and with remat (one interval
    each): whether it fits, the memory allocated before it and the peak
    (both absolute: a run that ran out of memory may leave some
    allocated)."""
    import gc

    rows = []
    for clients_per_edge, remat, rounds in ((2, False, 2), (2, False, 8), (2, True, 2), (4, False, 2), (4, True, 2)):
        overrides = XLSTM + [f"run.num_rounds={rounds}", f"topology.clients_per_edge={clients_per_edge}"]
        overrides += REMAT if remat else []
        torch.cuda.empty_cache()
        row = {"clients": 2 * clients_per_edge, "remat": remat, "rounds": rounds,
               "allocated_before_bytes": reset_peak(torch)}
        try:
            _, state, secs, *_ = run_scenario(torch, mods, "lm_edge_niid", overrides, "cuda")
            row.update(fits=True, seconds=secs)
            del state
        except torch.OutOfMemoryError:
            row.update(fits=False)
        row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        gc.collect()
        torch.cuda.empty_cache()
        rows.append(row)
    emit({"phase": "xlstm_train_memory", "card_bytes": torch.cuda.get_device_properties(0).total_memory,
          "runs": rows})


def moe_dense_reference(torch, moe, x, cfg, n):
    """The MoE layer's output for the first ``n`` of the tokens ``x`` (T,
    d), one token and one expert at a time: the same routing over all T
    tokens, each assignment's rank counted by a running sum (the
    assignments to an expert before it, token-major), those of rank C or
    more left out; h and g in f32, rounded after silu(h) * g, the down
    product in bf16; the gated sum and the shared branch in f32. Returns
    (y (n, d), the dropped assignments over all T tokens)."""
    import torch.nn.functional as F

    from repro_torch.models import layers

    m = cfg.moe
    T, K, E = x.shape[0], m.top_k, m.num_experts
    C = layers.moe_capacity(T, cfg)
    probs = torch.softmax(x.float() @ moe["router"], dim=-1)
    gates, ids = torch.topk(probs, K, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    flat = ids.reshape(-1)
    before = torch.cumsum((flat[:, None] == torch.arange(E, device=x.device)).int(), dim=0) - 1
    kept = (before[torch.arange(T * K, device=x.device), flat] < C).reshape(T, K)
    rows = []
    for t in range(n):
        acc = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
        for j in range(K):
            if not bool(kept[t, j]):
                continue
            e = int(ids[t, j])
            h = x[t].float() @ moe["w1"][e].float()
            g = x[t].float() @ moe["w3"][e].float()
            acc += (((F.silu(h) * g).to(x.dtype) @ moe["w2"][e]).to(x.dtype)).float() * gates[t, j]
        rows.append(acc + layers.mlp_apply(moe["shared"], x[t:t + 1])[0].float())
    return torch.stack(rows).to(x.dtype), int((~kept).sum())


def phase_serve_deepseekv3_l1(torch, mods, fa):
    """deepseek-v3-671b at full layer widths, one layer deep, through the
    serving entry point: K7 once per prefill (MLA, v zero-padded to the
    q/k head dim); the prefill against the layer code, the absorbed
    decode against prefill(P + 1), the MoE's output on the path against
    the per-token dense reference, a warm prefill and decode step
    profiled, the expert product's two bf16 routes timed, and K7 at this
    shape against its plain version, timed beside its bound and torch's
    SDPA."""
    import dataclasses

    import torch.nn.functional as F
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs.base import param_count
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import layers, transformer

    cfg = dataclasses.replace(get_config("deepseek-v3-671b"), num_layers=1)
    B, P, G = 1, 4096, 16
    torch.cuda.empty_cache()
    base = reset_peak(torch)
    with torch.no_grad():
        params = transformer.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated() - base
    n_params = sum(t.numel() for t in tree_leaves(params))
    check(n_params == param_count(cfg), f"deepseek-v3 one layer has {n_params} parameters")
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    torch.cuda.reset_peak_memory_stats()
    out, launches = counted_serve(torch, mods, cfg, params, batch=B, prompt_len=P, gen=G)
    peak = torch.cuda.max_memory_allocated() - base
    check_launches(launches, {"flash_attention": 1}, "serve_deepseekv3_l1")
    check(tuple(out["tokens"].shape) == (B, G) and bool(torch.isfinite(out["prefill_logits"]).all()),
          "serve_deepseekv3_l1: tokens or logits")
    warm, _ = counted_serve(torch, mods, cfg, params, batch=B, prompt_len=P, gen=G)
    del out["caches"], warm["caches"]

    # the prefill (K7) against the layer code; the MoE's input and output on
    # the prefill's path kept for the dense reference
    x = torch.from_numpy(serve.make_prompts(cfg, B, P + 1, seed=1)).cuda()
    seen = []
    moe_apply = layers.moe_apply

    def kept(p, h, c):
        y, aux = moe_apply(p, h, c)
        seen.append((h, y))
        return y, aux

    for m in mods:
        m.reset_launch_counts()
    layers.moe_apply = kept
    try:
        with torch.inference_mode():
            kern, caches = transformer.prefill(params, cfg, x[:, :P], P + G)
    finally:
        layers.moe_apply = moe_apply
    with torch.inference_mode():
        plain = layer_code_last_logits(torch, transformer, params, cfg, x[:, :P])
    check_launches({k: v for m in mods for k, v in m.LAUNCHES.items()}, {"flash_attention": 1},
                   "serve_deepseekv3_l1 kernel vs layer-code prefills")
    plain_err, scale = max_err(kern, plain)
    check(bool(torch.isfinite(kern).all()) and plain_err <= K_BF16 * scale,
          f"serve_deepseekv3_l1: K7 vs layer code err {plain_err} (scale {scale})")
    with torch.inference_mode():
        dec, _ = transformer.decode_step(params, cfg, caches, x[:, P],
                                         torch.full((B,), P, dtype=torch.int32, device="cuda"))
        longer, _ = transformer.prefill(params, cfg, x, P + G)
    dec_err, dec_scale = max_err(dec, longer)
    check(bool(torch.isfinite(dec).all()) and dec_err <= K_BF16 * dec_scale,
          f"serve_deepseekv3_l1: decode vs prefill(P+1) err {dec_err} (scale {dec_scale})")
    tok = kern.argmax(-1).to(torch.int32)
    pos = torch.full((B,), P, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        prof_prefill = profile_call(torch, lambda: transformer.prefill(params, cfg, x[:, :P], P + G))
        prof_decode = profile_call(torch, lambda: transformer.decode_step(params, cfg, caches, tok, pos))
    del caches, dec, longer, plain

    check(len(seen) == 1 and seen[0][0].shape == (P, cfg.d_model), f"MoE calls in the prefill: {len(seen)}")
    moe_in, moe_out = seen.pop()
    moe = params["blocks"]["b0"]["moe"]
    moe_p = {k: (v[0] if k != "shared" else {n: w[0] for n, w in v.items()}) for k, v in moe.items()}
    with torch.inference_mode():
        ref, dropped = moe_dense_reference(torch, moe_p, moe_in, cfg, MOE_REF_TOKENS)
    moe_err, moe_scale = max_err(moe_out[:MOE_REF_TOKENS], ref)
    check(moe_err <= MOE_REF_RTOL * moe_scale, f"serve_deepseekv3_l1: MoE vs dense reference err {moe_err} "
          f"(scale {moe_scale})")
    del moe_in, moe_out, ref

    # the expert product (E, C, d) @ (E, d, f) at this prefill's shape by
    # both of ``_matmul_f32``'s bf16 routes: bmm's f32 output, and
    # blocks of experts upcast
    flush = flush_buffer(torch)
    with torch.inference_mode():
        w1 = moe_p["w1"]
        buf = torch.randn((w1.shape[0], layers.moe_capacity(B * P, cfg), cfg.d_model), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(3)).to(torch.bfloat16)
        direct = torch.bmm(buf, w1, out_dtype=torch.float32)
        upcast = layers._expert_matmul_upcast(buf, w1)
        routes = {"shape": {"a": list(buf.shape), "w": list(w1.shape)},
                  "max_abs_diff": float((direct - upcast).abs().max()), "max_abs": float(upcast.abs().max()),
                  "out_dtype_ms": time_ms(lambda: torch.bmm(buf, w1, out_dtype=torch.float32), flush=flush, reps=10),
                  "upcast_ms": time_ms(lambda: layers._expert_matmul_upcast(buf, w1), flush=flush, reps=10)}
        check(routes["max_abs_diff"] <= 1e-4 * routes["max_abs"], f"the expert product's routes differ: {routes}")
    del buf, direct, upcast

    # K7 at the MLA prefill's shape, on the layer's own q, k, v
    attn = {k: v[0] for k, v in params["blocks"]["b0"]["attn"].items()}
    with torch.inference_mode():
        h = layers.rmsnorm(params["embed"][x[:, :P]], params["blocks"]["b0"]["norm1"][0], cfg.norm_eps)
        pos = torch.arange(P, dtype=torch.int32, device="cuda").expand(B, P)
        q, k, v = (t.contiguous() for t in layers.mla_qkv(attn, h, cfg, pos)[:3])
        vp = F.pad(v, (0, q.shape[-1] - v.shape[-1]))
        got = fa.attention(q, k, vp, causal=True)[..., :v.shape[-1]]
        want = fa.attention_plain(q, k, v, causal=True)
        tol = fa.bf16_tolerance(q, k, v, got, want, K7_ATOL, causal=True)
        err_over_tol = float(((got.float() - want.float()).abs() / tol).max())
        check(bool(torch.isfinite(got).all()) and err_over_tol <= 1, f"K7 at the MLA shape: {err_over_tol} of tol")
        del tol
        library = sdpa_call(torch, q, k, v, 0)
        bound, bound_by = k7_bound(B, P, cfg.num_heads, cfg.num_heads, q.shape[-1], 0, 2, v.shape[-1])
        k7 = {"shape": {"b": B, "s": P, "h": cfg.num_heads, "dqk": q.shape[-1], "dv": v.shape[-1],
                        "padded_dv": vp.shape[-1]},
              "max_abs_err": float((got.float() - want.float()).abs().max()), "max_err_over_tol": err_over_tol,
              "rms_err_rel": rms_rel(got, want),
              "ms": time_ms(lambda: fa.attention(q, k, vp, causal=True), flush=flush, reps=10),
              "plain_ms": time_ms(lambda: fa.attention_plain(q, k, v, causal=True), flush=flush, reps=3, warmup=1),
              "bound_ms": bound, "bound_by": bound_by,
              "library_ms": time_ms(library, flush=flush, reps=10),
              "library_max_abs_err": float((library().transpose(1, 2).float() - want.float()).abs().max())}
        k7["bound_share"] = k7["bound_ms"] / k7["ms"]
    del flush, params, q, k, v, vp, got, want, h
    torch.cuda.empty_cache()
    emit({"phase": "serve_deepseekv3_l1", "arch": cfg.name, "layers": 1, "params": n_params,
          "param_bytes": param_bytes, "dtype": "bfloat16", "batch": B, "prompt_len": P, "gen": G,
          **serve_report(out, warm, launches), "launches_per_prefill": {"flash_attention": 1},
          "init_peak_memory_bytes": init_peak, "peak_memory_bytes": peak,
          "moe": {"capacity": layers.moe_capacity(B * P, cfg), "assignments": B * P * cfg.moe.top_k,
                  "dropped": dropped, "vs_dense_reference": {"tokens": MOE_REF_TOKENS, "max_abs_err": moe_err,
                                                             "max_abs_y": moe_scale,
                                                             "tolerance": f"{MOE_REF_RTOL} x max |y|"}},
          "kernel_vs_layer_code": {"max_abs_err": plain_err, "max_abs_logit": scale,
                                   "tolerance": f"{K_BF16} x max |logit|"},
          "decode_vs_prefill": {"position": P, "max_abs_err": dec_err, "max_abs_logit": dec_scale},
          "k7_mla": k7, "expert_matmul_routes": routes, "profile_prefill": prof_prefill, "profile_decode_step": prof_decode})
    return launches


# ---------------------------------------------------------------------------
# The client-sharded superround over torch.distributed ranks
# ---------------------------------------------------------------------------
# one card: several ranks share it under gloo (PyTorch's gloo takes CUDA
# tensors for all_reduce and broadcast), a world of 1 runs under NCCL. Each
# sharded run is held to the single-device card run of the same scenario at
# JAX's own mesh tolerances (tests/test_sharded.py:500-501): params within
# SHARDED_ATOL + SHARDED_RTOL |ref|, per-round loss and grad norm within
# SHARDED_LOSS_ATOL + SHARDED_LOSS_RTOL |ref|; lm-100m's at LM_RTOL
SHARDED_RTOL, SHARDED_ATOL = 3e-6, 2e-7
SHARDED_LOSS_RTOL, SHARDED_LOSS_ATOL = 1e-5, 1e-7
RAGGED = ["run.num_rounds=20", "run.eval_every=10"]
# single-device card runs the sharded phases are held to (numpy)
REFS = {}


def stash(runner, state=None):
    """A run's per-round records and (when given) its final params as host
    numpy: the reference a sharded phase is held to."""
    out = {"loss": [h.loss for h in runner.history], "grad_norm": [h.grad_norm for h in runner.history],
           "step": [h.step for h in runner.history], "accuracy": [h.accuracy for h in runner.history],
           "mask_alive": [h.mask_alive for h in runner.history]}
    if state is not None:
        out["params"] = params_numpy(state)
    return out


def params_numpy(state):
    """The final params' leaves as host numpy f32. A leaf whose rows all
    equal its first (every client after a cloud sync) keeps that row alone,
    (1, ...), which compares against the other run's rows by broadcasting:
    lm-100m's 8 clients are one 305 MB copy, not eight."""
    from repro_torch.tree import leaves

    out = []
    for x in leaves(state.params):
        same = x.dim() > 0 and bool((x == x[:1]).all())
        out.append((x[:1] if same else x).detach().float().cpu().numpy())
    return out


def sharded_agreement(got, ref, what, loss_rtol=SHARDED_LOSS_RTOL, loss_atol=SHARDED_LOSS_ATOL):
    """A sharded run's records and final params against a single-device
    card run's; checked. Returns the largest errors."""
    import numpy as np

    check(got["step"] == ref["step"] and got["mask_alive"] == ref["mask_alive"], f"{what}: steps or survivors differ")
    out = {}
    for key in ("loss", "grad_norm"):
        a, b = np.asarray(got[key], np.float64), np.asarray(ref[key], np.float64)
        excess = float(np.max(np.abs(a - b) - (loss_atol + loss_rtol * np.abs(b))))
        check(excess <= 0, f"{what}: {key} {a.tolist()} vs {b.tolist()}")
        out[f"{key}_max_abs_err"] = float(np.max(np.abs(a - b)))
    acc = [abs(x - y) for x, y in zip(got["accuracy"], ref["accuracy"]) if x is not None]
    out["accuracy_max_gap"] = max(acc, default=0.0)
    check(out["accuracy_max_gap"] <= 0.01, f"{what}: accuracy gap {out['accuracy_max_gap']}")
    check("params" in got and "params" in ref, f"{what}: no params to compare")
    worst, excess = 0.0, -1.0
    for a, b in zip(got["params"], ref["params"]):
        diff = np.abs(a.astype(np.float64) - b)
        worst = max(worst, float(diff.max()))
        excess = max(excess, float(np.max(diff - (SHARDED_ATOL + SHARDED_RTOL * np.abs(b)))))
    check(excess <= 0, f"{what}: params {worst} apart")
    out["params_max_abs_err"] = worst
    out["tolerance"] = {"params": [SHARDED_RTOL, SHARDED_ATOL], "loss": [loss_rtol, loss_atol]}
    return out


def sharded_scenario(torch, mods, name, overrides, world, profiler=None):
    """``run_scenario`` with ``topology.mesh_axes=clients:<world>`` on this
    rank, its collectives counted from 0 with the kernel launches."""
    from repro_torch.dist import sharding

    sharding.reset_counts()
    out = run_scenario(torch, mods, name, list(overrides) + [f"topology.mesh_axes=clients:{world}"], "cuda",
                       profiler=profiler)
    return out + (dict(sharding.COUNTS),)


def timed_all_reduces(torch):
    """Wrap ``dist.sharding.all_reduce_sum`` to time each call (the device
    drained before and after it, so the time is the collective's alone);
    returns (restore, calls [(ms, bytes)])."""
    from repro_torch.dist import sharding

    orig, calls = sharding.all_reduce_sum, []

    def timed(vec, mesh, counter="all_reduce", **kw):
        if counter != "all_reduce":  # an eval's: not the cloud interval's one
            return orig(vec, mesh, counter, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(vec, mesh, counter, **kw)
        torch.cuda.synchronize()
        calls.append(((time.perf_counter() - t0) * 1e3, vec.numel() * vec.element_size()))
        return out

    sharding.all_reduce_sum = timed
    return (lambda: setattr(sharding, "all_reduce_sum", orig)), calls


def rank_profile(torch, mods, name, overrides, world):
    """On this rank: the run once more (warm), under ``torch.profiler`` with
    its all-reduces timed. The profiler sees this process's kernels only,
    so the busy share is the rank's own."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    dist.barrier()
    prof = profile(activities=[ProfilerActivity.CUDA])
    restore, calls = timed_all_reduces(torch)
    try:
        runner, _, window_s, *_ = sharded_scenario(torch, mods, name, overrides, world, profiler=prof)
    finally:
        restore()
    gather_s = runner._engine._layout.gather_seconds  # the end's gather of the state
    events = device_events(torch, prof)
    busy = busy_us(events)
    intervals = runner.cfg.num_rounds / runner.hier_config.kappa2_effective
    by_class, _ = by_kernel(events)
    return {
        "profiled_wall_ms_per_interval": window_s * 1e3 / intervals,
        "profiled_state_gathers_ms": gather_s * 1e3,
        "profiled_wall_ms_per_interval_without_gathers": (window_s - gather_s) * 1e3 / intervals,
        "device_busy_ms_per_interval": busy / 1e3 / intervals,
        "device_busy_share_of_profiled_wall": busy / 1e6 / window_s,
        "busy_ms_per_interval_by_class": {k: v / 1e3 / intervals for k, v in sorted(by_class.items())},
        "all_reduce_ms": [c[0] for c in calls], "all_reduce_bytes": sorted({c[1] for c in calls}),
    }


def sharded_job(torch, mods, world, job):
    """One sharded run on this rank (``job``: phase, scenario, overrides,
    whether to profile); rank 0 also returns the final params."""
    from repro_torch.tree import leaves

    torch.cuda.empty_cache()
    base = reset_peak(torch)
    runner, state, secs, launches, _params, collectives = sharded_scenario(
        torch, mods, job["name"], job["overrides"], world)
    peak = torch.cuda.max_memory_allocated() - base
    mesh = runner.mesh
    engine = runner._engine
    out = {"rank": mesh.rank, "device": str(mesh.device), "backend": mesh.backend, "seconds": secs,
           "launches": launches, "collectives": collectives, "peak_memory_bytes": peak,
           "sharded": engine is not None and engine.mesh is not None, "mesh_reason": runner._mesh_reason,
           "placement": None if engine is None or engine.placement is None else engine.placement.describe(),
           "capacity": None if engine is None or engine.placement is None else engine.placement.capacity,
           "params_finite": all(bool(torch.isfinite(x).all()) for x in leaves(state.params)),
           "state_rows": int(next(leaves(state.params)).shape[0]), **stash(runner)}
    if mesh.rank == 0:
        out["params"] = params_numpy(state)
    del runner, state, engine
    torch.cuda.empty_cache()
    if job.get("profile"):
        out["profile"] = rank_profile(torch, mods, job["name"], job["overrides"], world)
        torch.cuda.empty_cache()
    return out


def sharded_rank(rank, world, jobs):
    """``dist.launch.spawn`` entry: the jobs on this rank of a gloo world
    whose ranks share the card."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.kernels import hier_aggregate as ha
    from repro_torch.kernels import quantize as qz

    entered = time.time()
    resolve_device("cuda")  # TF32 off
    return handed_over([sharded_job(torch, (ha, qz), world, job) for job in jobs], f"world{world}_rank{rank}",
                       entered)


def edge_interval_bit_equal(torch, runner, params, mesh):
    """kappa1 local steps and the edge sync of the single-device path
    against the sharded path's (``_sharded_local_step``,
    ``build_level_sync(shard=)``) on the same state and batches: the world
    of 1 must change nothing below the cloud. Returns the largest |diff|."""
    from repro_torch.core import hierfavg as th
    from repro_torch.core.hierarchy import as_hierarchy, plan_shard_placement
    from repro_torch.data.pipeline import to_device
    from repro_torch.tree import leaves

    spec, hier = as_hierarchy(runner.topology), runner.hier_config
    batches = to_device(runner.batcher.next_batches(hier.kappa1), runner.device)
    shard = th.ClientSharding.build("clients", plan_shard_placement(spec, 1), runner.weights, mesh=mesh)
    out = []
    for step, sync in ((th.build_local_step(runner.loss_fn, runner.optimizer),
                        th.build_level_sync(spec, hier, runner.weights, 1)),
                       (th._sharded_local_step(runner.loss_fn, runner.optimizer, None),
                        th.build_level_sync(spec, hier, runner.weights, 1, shard=shard))):
        state = runner.init(torch.Generator(device="cuda").manual_seed(0), params)
        for j in range(hier.kappa1):
            state = step(state, {k: v[j] for k, v in batches.items()})[0]
        out.append(list(leaves(sync(state).params)))
    return max(float((a - b).abs().max()) for a, b in zip(*out)), all(torch.equal(a, b) for a, b in zip(*out))


def phase_sharded_w1_nccl(torch, mods, mlp_params):
    """mlp307k over a world of 1 under NCCL, in this process: K1 32 (an
    edge sync and the cloud sync's edge stage per interval, 4 leaves, 4
    intervals; the single-device run's third launch per leaf, the cloud's
    root stage, is the all-reduce), 4 all-reduces, records and params
    against the single-device card run, an edge interval bit for bit."""
    import torch.distributed as dist

    from repro_torch.fed import scenarios

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        runner, state, secs, launches, _, collectives = sharded_scenario(
            torch, mods, "hierfavg_edge_iid", MLP307K, 1)
        check(runner._engine.mesh is not None and runner.mesh.backend == "nccl", "w1: not the NCCL sharded engine")
        check_launches(launches, {"grouped_mean": 32}, "sharded_mlp307k_w1_nccl")
        check(collectives["all_reduce"] == 4, f"sharded_mlp307k_w1_nccl collectives {collectives}")
        evals = sum(h.accuracy is not None for h in runner.history)
        check(collectives["eval_all_reduce"] == evals, f"sharded_mlp307k_w1_nccl: {evals} evals, {collectives}")
        agreement = sharded_agreement(stash(runner, state), REFS["mlp307k"], "sharded_mlp307k_w1_nccl")
        spec = scenarios.get("hierfavg_edge_iid", overrides=MLP307K)
        single = spec.build(device="cuda")
        err, equal = edge_interval_bit_equal(torch, single, mlp_params, runner.mesh)
        check(equal, f"sharded_mlp307k_w1_nccl: the edge interval differs from the single-device one by {err}")
        emit({"phase": "sharded_mlp307k_w1_nccl", **path_report(runner, secs, launches, {
            "collectives": collectives, "backend": "nccl", "world": 1, "vs_single_device_card": agreement,
            "edge_interval_bit_equal": equal, "edge_interval_max_abs_diff": err})})
    finally:
        dist.destroy_process_group()
    return launches


# the client-sharded scenarios of the 2-rank world (``phase_world2``)
W2_SHARDED = [
    {"phase": "mlp307k_int8_ef_w2", "name": "int8_ef_both", "overrides": MLP307K},
    {"phase": "sharded_ragged_w2", "name": "ragged_edges", "overrides": RAGGED},
    {"phase": "sharded_lm100m_w2", "name": "lm_edge_niid", "overrides": LM100M + LM_TRAIN},
    {"phase": "sharded_n1m_cohort_w2", "name": "n1m_cohort4096", "overrides": (), "profile": True}]
# per sharded phase: (launches a rank, cloud intervals, the single-device
# run in REFS it is held to, the loss rtol). Launches and all-reduces per
# rank (every rank its own K1/K2/K4/K5 on its rows): mlp307k K1 32 = 4
# intervals x (edge sync + the cloud's edge stage) x 4 leaves; int8_ef also
# K4 = K5 = 8 syncs x 4 leaves; ragged K2 80 = 2 intervals x 10 sub-top
# stages x 4 leaves and no K1 (the root is the all-reduce); lm-100m K1 96 =
# 4 intervals x 2 stages x 12 leaves; n1m K2 32 = 4 intervals x 2 stages x 4
# leaves (4 or 5 slots an edge: ragged). One all-reduce per cloud interval
# everywhere.
SHARDED_WANTS = {
    "sharded_mlp307k_w4": ({"grouped_mean": 32}, 4, "mlp307k", SHARDED_LOSS_RTOL),
    "mlp307k_int8_ef_w2": ({"grouped_mean": 32, "quantize": 32, "dequantize": 32}, 4, "mlp307k_int8_ef",
                           SHARDED_LOSS_RTOL),
    "sharded_ragged_w2": ({"segment_mean": 80}, 2, "ragged", SHARDED_LOSS_RTOL),
    "sharded_lm100m_w2": ({"grouped_mean": 96}, 4, "lm100m", LM_RTOL),
    "sharded_n1m_cohort_w2": ({"segment_mean": 32}, 4, "n1m_cohort4096", SHARDED_LOSS_RTOL),
}


def phase_sharded_w4(torch):
    """mlp307k over a gloo world of 4 ranks on the one card, one edge each
    (the 2-rank scenarios run in ``phase_world2``'s world)."""
    from repro_torch.dist import launch

    torch.cuda.empty_cache()
    t0, spawned = time.perf_counter(), time.time()
    w4, times = taken_back(launch.spawn(sharded_rank, 4, "gloo", ([
        {"phase": "sharded_mlp307k_w4", "name": "hierfavg_edge_iid", "overrides": MLP307K,
         "profile": True}],)), spawned)
    sharded_checks("sharded_mlp307k_w4", [r[0] for r in w4], time.perf_counter() - t0, times)


def sharded_checks(phase, ranks, world_s, world_times=None):
    """One sharded scenario's ranks (``SHARDED_WANTS``): the sharded engine,
    its launches and all-reduces on every rank, the ranks' records equal,
    and the run held to the single-device card run."""
    want, intervals, ref, rtol = SHARDED_WANTS[phase]
    for r in ranks:
        check(r["sharded"], f"{phase} rank {r['rank']}: no sharded engine ({r['mesh_reason']})")
        check_launches(r["launches"], want, f"{phase} rank {r['rank']}")
        check(r["collectives"]["all_reduce"] == intervals, f"{phase} rank {r['rank']}: {r['collectives']}")
        evals = sum(a is not None for a in r["accuracy"])
        check(r["collectives"]["eval_all_reduce"] == evals, f"{phase} rank {r['rank']}: {evals} evals, "
                                                             f"{r['collectives']}")
        check(r["params_finite"], f"{phase} rank {r['rank']}: params not finite")
        check(r["loss"] == ranks[0]["loss"], f"{phase}: the ranks' records differ")
    agreement = sharded_agreement(ranks[0], REFS[ref], phase, loss_rtol=rtol,
                                  loss_atol=0.0 if rtol == LM_RTOL else SHARDED_LOSS_ATOL)
    emit({"phase": phase, "world": len(ranks), "backend": ranks[0]["backend"], "device": ranks[0]["device"],
          "world_seconds_with_spawn": world_s, "world_times": world_times, "placement": ranks[0]["placement"],
          "vs_single_device_card": agreement, "losses": ranks[0]["loss"],
          "ranks": [{k: r[k] for k in ("rank", "seconds", "launches", "collectives", "peak_memory_bytes",
                                       "state_rows", "capacity")} | ({"profile": r["profile"]} if "profile" in r
                                                                     else {}) for r in ranks]})


# ---------------------------------------------------------------------------
# Microbatch accumulation, the launch cells, MoE's expert-parallel exchange
# ---------------------------------------------------------------------------
# the train cells' cut of lm-100m's train_4k shape: 128 sequences of 64 over
# 16 clients (b 8, microbatch 4, accum 2), one cloud interval at kappa (2, 2)
TRAIN_CUT = ("train_cut", 64, 128, "train")
TRAIN_CELL_KAPPAS = (2, 2)
TRAIN_CELL_CUTS = ["lm-100m's kappa (8, 4) cut to (2, 2): one cloud interval of 4 calls, not 32, for the script's "
                   "wall; the edge sync at call 2 and the cloud sync at call 4 run as at (8, 4)"]
# tp_lm100m_m2's serving cells: serve_lm100m's shape, f32
TP_BATCH, TP_PROMPT, TP_GEN = 4, 1024, 8
EP_PROMPT, EP_GEN = 4096, 16  # serve_deepseekv3_l1_ep2: 2 requests, one a rank
# tensor parallelism over ("data", "model") of (1, 2) for the RG-LRU, MLA,
# MoE and xLSTM families in the 2-rank world: each serving job's (arch, its
# config's cut, batch, prompt, decode steps, launches a prefill). The
# decode steps take the single-device run's greedy tokens
TP_FAMILY_SERVE = {
    "tp_recurrentgemma9b_m2": ("recurrentgemma-9b", {}, 2, 4096, 8, {"flash_attention": 12, "rglru_scan": 26}),
    "tp_deepseekv3_l1_m2": ("deepseek-v3-671b", {"num_layers": 1}, 1, 4096, 8, {"flash_attention": 1}),
    "tp_xlstm350m_m2": ("xlstm-350m", {"param_dtype": "float32", "compute_dtype": "float32"}, 2,
                        XLSTM_CHECK_PROMPT, 8, {}),
}
# xlstm-350m is served in f32 (its config stores bf16): in bf16 the two
# ranks' products, summed in f32 and rounded once, round apart from one
# device's, and the sLSTM grows that past K_BF16 within the first decode
# step (on an H100: 0.54 of a largest 4.81 at position 8, 1.63 of 5.5 by
# the eighth step; the prefill within it; PERF.md §6). Its 2 x 256
# prefill's gap to one device is reported, not held
TP_XLSTM_GAP_PROMPT = 256
# in f32 the ranks' logits part from one device's by about 1.15x a token
# too (on an H100: 5.1e-4 of a largest 4.64 at decode step 5, position 13,
# past K_F32). The prefill and the first decode step are held
TP_XLSTM_HELD_STEPS = 1
# tp_xlstm350m_m2's train cell: xlstm-350m's published widths, one
# superblock, f32, 4 clients on 2 edges, kappa (2, 2), 8-token sequences
# (b 2, microbatch 1, accum 2)
TP_XLSTM_CUT = ("train_cut", XLSTM_CHECK_PROMPT, 8, "train")
TP_XLSTM_CUTS = [
    "one superblock (3 mLSTM + 1 sLSTM), not 6: the two ranks' and the reference's states share the card",
    "f32 held at the mesh tolerances; bf16 (the config's own dtype) held within one device's bf16 gap from "
    "f32: a bf16 product rounds a reordered f32 sum apart from one device's, past the f32 loss tolerance",
    "4 clients on 2 edges, kappa (2, 2): one cloud interval of 4 calls",
    f"{XLSTM_CHECK_PROMPT}-token sequences: the sLSTM amplifies a rounding about 1.15x a token at full width"]


def accum_params_gap(state, ref_params) -> float:
    """The largest |difference| between a run's final params and a stashed
    run's (``params_numpy``: one row where every client holds the same)."""
    import numpy as np

    return max(float(np.max(np.abs(a.astype(np.float64) - b)))
               for a, b in zip(params_numpy(state), ref_params))


def phase_train_lm100m_accum2(torch, mods):
    """``lm_edge_niid`` at lm-100m's full width through
    ``FederatedRunner(grad_accum=2)``: each client's 8 sequences as 2
    microbatches of 4 (lm-100m's ``microbatch``), leaves (2, 8, 4, 64). K1
    as ``train_lm100m``'s (36 an interval, 144). Held to the same run at
    grad_accum 1 on the card: under SGD the params within 1e-5 and every
    round's grad norm (the accumulated gradient is the whole batch's)
    within LM_RTOL; the losses are reported, not held: an accumulating
    step's loss metric is its last microbatch's (JAX's scan carry), the
    reference's the whole batch's. Under the registered Adam the largest
    param and loss differences are reported beside the grad-norm gap (near
    zero-gradient coordinates move by about lr on any rounding). Peak
    memory, and the warm wall an interval (the Adam run, the third in a
    row), beside ``train_lm100m``'s from this call."""
    import math

    t0 = time.perf_counter()
    sgd = LM100M + LM_TRAIN + ["model.optimizer=sgd"]
    torch.cuda.empty_cache()
    ref, ref_state, ref_s, *_ = run_scenario(torch, mods, "lm_edge_niid", sgd, "cuda")
    ref_params = params_numpy(ref_state)
    del ref_state
    out, total = {}, {}
    for opt, overrides, reference in (("sgd", sgd, (ref, ref_params)),
                                      ("adam", LM100M + LM_TRAIN, (None, REFS["lm100m"]["params"]))):
        torch.cuda.empty_cache()
        base = reset_peak(torch)
        runner, state, secs, launches, _ = run_scenario(torch, mods, "lm_edge_niid", overrides, "cuda", grad_accum=2)
        peak = torch.cuda.max_memory_allocated() - base
        check(runner.grad_accum == 2 and runner._engine is not None, f"train_lm100m_accum2 {opt}: not accumulating")
        check_launches(launches, lm_launches(runner, state, 0), f"train_lm100m_accum2 {opt}")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        want_losses = reference[0].history if reference[0] is not None else None
        losses = [h.loss for h in runner.history]
        gnorms = [h.grad_norm for h in runner.history]
        ref_losses = [h.loss for h in want_losses] if want_losses else REFS["lm100m"]["loss"]
        ref_gnorms = [h.grad_norm for h in want_losses] if want_losses else REFS["lm100m"]["grad_norm"]
        check(all(math.isfinite(x) for x in losses + gnorms) and len(losses) == len(ref_losses),
              f"train_lm100m_accum2 {opt}: losses {losses}")
        gap = accum_params_gap(state, reference[1])
        row = {"seconds": secs, "intervals": runner.cfg.num_rounds // runner.hier_config.kappa2_effective,
               "launches": launches, "losses": losses, "losses_grad_accum_1": ref_losses, "grad_norms": gnorms,
               "loss_max_rel_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
               "grad_norm_max_rel_err": max(abs(a - b) / abs(b) for a, b in zip(gnorms, ref_gnorms)),
               "params_max_abs_err": gap, "peak_memory_bytes": peak}
        row["wall_ms_per_interval"] = secs * 1e3 / row["intervals"]
        if opt == "sgd":
            check(gap <= 1e-5, f"train_lm100m_accum2 sgd: params {gap} from grad_accum 1")
            check(row["grad_norm_max_rel_err"] <= LM_RTOL, f"train_lm100m_accum2 sgd: grad norms {row}")
        out[opt] = row
        del state, runner
    torch.cuda.empty_cache()
    emit({"phase": "train_lm100m_accum2", "arch": "lm-100m", "grad_accum": 2, "microbatch": 4,
          "batch_leaf": [2, 8, 4, 64], "sgd_grad_accum_1_seconds": ref_s, **out,
          "train_lm100m_peak_memory_bytes": REFS.get("lm100m_peak_memory_bytes"),
          "train_lm100m_warm_wall_ms_per_interval": REFS.get("lm100m_warm_wall_ms_per_interval"),
          "tolerance": {"sgd_params_atol": 1e-5, "sgd_grad_norm_rtol": LM_RTOL},
          "phase_seconds": time.perf_counter() - t0})
    return total


def cell_batches(cfg, cell, steps: int):
    """``steps`` global train batches of the cell's stand-in shapes, random
    tokens from a fixed seed (every process draws the same)."""
    import numpy as np

    rng = np.random.default_rng(7)
    shape = tuple(cell.arg_structs[1]["inputs"].shape)
    return [{k: rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32) for k in ("inputs", "targets")}
            for _ in range(steps)]


def train_cell_config():
    """lm-100m with the train cells' kappa cut (``TRAIN_CELL_KAPPAS``)."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    cfg = get_config("lm-100m")
    k1, k2 = TRAIN_CELL_KAPPAS
    return dataclasses.replace(cfg, fed=dataclasses.replace(cfg.fed, kappa1=k1, kappa2=k2))


def timed_tp_collectives(torch):
    """Wrap the tensor-parallel all-reduces and gathers
    (``dist.sharding._model_all_reduce`` / ``_model_all_gather``) to time
    each call, the device drained before and after it; returns (restore,
    calls [(kind, ms, bytes)])."""
    from repro_torch.dist import sharding

    calls, origs = [], {n: getattr(sharding, n) for n in ("_model_all_reduce", "_model_all_gather")}

    def wrap(name, fn):
        def timed(x, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(x, *a, **k)
            torch.cuda.synchronize()
            calls.append((name, (time.perf_counter() - t0) * 1e3, x.numel() * x.element_size()))
            return out
        return timed

    for n, fn in origs.items():
        setattr(sharding, n, wrap(n, fn))
    return (lambda: [setattr(sharding, n, fn) for n, fn in origs.items()]), calls


def tp_collectives_report(calls):
    """The timed collectives of one call by kind: count, summed ms, the
    median ms and the distinct byte sizes."""
    out = {}
    for kind in sorted({c[0] for c in calls}):
        ms = [c[1] for c in calls if c[0] == kind]
        out[kind.strip("_")] = {"calls": len(ms), "ms_total": sum(ms), "ms_median": statistics.median(ms),
                                "bytes": sorted({c[2] for c in calls if c[0] == kind}),
                                "bytes_total": sum(c[2] for c in calls if c[0] == kind)}
    return out


def train_cell_run(torch, mods, mesh, cfg=None, cut=TRAIN_CUT):
    """``build_train_cell`` at lm-100m (or ``cfg``, at the shape ``cut``)
    over one cloud interval (kappa cut to ``TRAIN_CELL_KAPPAS``), on this
    rank's clients or tensor-parallel slices (``mesh``) or on one device
    (None): per step the clients' losses
    and squared grad norms (or the global loss and grad norm) on the host,
    the final params (row-compressed, ``params_numpy``) with each leaf's
    model-split dim, the K1 launches and collectives a call, the warm wall
    a call and the peak. Over a model axis the last call's collectives are
    timed (and left out of the warm wall)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist import sharding
    from repro_torch.launch import steps
    from repro_torch.tree import leaves

    cfg = train_cell_config() if cfg is None else cfg
    tp = mesh is not None and sharding.model_size(mesh) > 1
    torch.cuda.empty_cache()
    base = reset_peak(torch)
    cell = steps.build_train_cell(cfg, ShapeSpec(*cut), mesh, lr=1e-3, device="cuda")
    calls = cell.meta["kappa1"] * cell.meta["kappa2"]
    batches = cell_batches(cfg, cell, calls)
    params = steps.transformer.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    state = steps.init_train_state(cfg, mesh, params, torch.Generator(device="cuda").manual_seed(0))
    state, _ = steps.shard_args(cell, (state, None), mesh, "cuda")
    del params
    torch.cuda.empty_cache()
    for m in mods:
        m.reset_launch_counts()
    sharding.reset_counts()
    per_step, walls, counts, timed = [], [], [], []
    for j, b in enumerate(batches):
        _, batch = steps.shard_args(cell, (None, {k: torch.from_numpy(v) for k, v in b.items()}), mesh, "cuda")
        restore = None
        if tp and j == len(batches) - 1:
            restore, timed = timed_tp_collectives(torch)
        before = dict(sharding.COUNTS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            state, m = cell.fn(state, batch)
            torch.cuda.synchronize()
        finally:
            if restore is not None:
                restore()
        walls.append(time.perf_counter() - t0)
        counts.append({k: v - before[k] for k, v in sharding.COUNTS.items()})
        if "gsq" in m:
            per_step.append((m["loss"].cpu().numpy(), m["gsq"].cpu().numpy()))
        else:
            per_step.append((float(m["loss"]), float(m["grad_norm"])))
    warm = walls[1:-1] if tp else walls[1:]
    launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    out = {"meta": {k: v for k, v in cell.meta.items()}, "per_step": per_step, "launches": launches,
           "collectives": dict(sharding.COUNTS), "collectives_per_call": counts, "wall_ms_first_call": walls[0] * 1e3,
           "warm_wall_ms_per_call": sum(warm) * 1e3 / len(warm),
           "state_rows": int(next(leaves(state.params)).shape[0]),
           "peak_memory_bytes": torch.cuda.max_memory_allocated() - base}
    if tp:
        out["timed_call_collectives"] = tp_collectives_report(timed)
        out["timed_call_wall_ms"] = walls[-1] * 1e3
    if mesh is None or mesh.rank == 0 or tp:
        out["params"] = params_numpy(state)
        out["model_dims"] = [model_dim(spec) for spec in leaves(cell.arg_specs[0].params)]
    del state
    torch.cuda.empty_cache()
    return out


def tp_serve_run(torch, mods, mesh):
    """lm-100m (f32) through ``build_prefill_cell`` / ``build_decode_cell``
    on this rank's tensor-parallel slices (``mesh``: ("data", "model") of
    (1, 2)) or on one device (None): ``TP_BATCH`` x ``TP_PROMPT`` prompts,
    the prefill's last logits and ``TP_GEN`` greedy decode steps; each
    call's collectives and K7 launches, the first and a warm prefill and
    decode, the collectives of a third run timed, the bytes of params held
    and the peak."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import sharding
    from repro_torch.launch import serve, steps
    from repro_torch.models import transformer
    from repro_torch.tree import leaves, tree_map

    cfg = get_config("lm-100m")
    B, P, G = TP_BATCH, TP_PROMPT, TP_GEN
    torch.cuda.empty_cache()
    base = reset_peak(torch)
    pre = steps.build_prefill_cell(cfg, ShapeSpec("prefill", P + G, B, "prefill"), mesh)
    dec = steps.build_decode_cell(cfg, ShapeSpec("decode", P + G, B, "decode"), mesh)
    with torch.no_grad():
        params = transformer.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
        if mesh is not None:  # this rank's slices, copied, the whole init freed
            params = tree_map(torch.clone, sharding.rank_params(params, mesh, cfg))
    torch.cuda.empty_cache()
    held = sum(x.numel() * x.element_size() for x in leaves(params))
    _, x = steps.shard_args(pre, (None, torch.from_numpy(serve.make_prompts(cfg, B, P, seed=1))), mesh, "cuda")

    def run():
        for m in mods:
            m.reset_launch_counts()
        sharding.reset_counts()
        if mesh is not None:
            dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, caches = pre.fn(params, x)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        report = {"prefill_s": pre_s, "prefill_tokens_per_s": B * P / pre_s,
                  "prefill_collectives": dict(sharding.COUNTS),
                  "k7": {k: v for mod in mods for k, v in mod.LAUNCHES.items()}.get("flash_attention", 0)}
        found = {"prefill": logits.float().cpu().numpy(), "tokens": [], "decode": []}
        sharding.reset_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            for j in range(G):  # greedy: each step feeds the argmax of the last logits
                tok = logits.argmax(-1).to(torch.int32)
                found["tokens"].append(tok)
                logits, caches = dec.fn(params, caches, tok, torch.full((B,), P + j, dtype=torch.int32,
                                                                         device="cuda"))
                found["decode"].append(logits)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        report.update(decode_s=dec_s, decode_tokens_per_s=B * G / dec_s,
                      decode_collectives_per_step={k: v / G for k, v in sharding.COUNTS.items()})
        found["tokens"] = torch.stack(found["tokens"], dim=1).cpu().numpy()
        found["decode"] = [d.float().cpu().numpy() for d in found["decode"]]
        return report, found

    first, found = run()
    warm, _ = run()
    timed = []
    if mesh is not None:
        restore, timed = timed_tp_collectives(torch)
        try:
            run()
        finally:
            restore()
    out = {"first": first, "warm": warm, **found, "param_bytes": held,
           "timed_run_collectives": tp_collectives_report(timed),
           "peak_memory_bytes": torch.cuda.max_memory_allocated() - base}
    if mesh is not None:  # the dry run's counter on this rank's prefill (phase_dryrun (b))
        from repro_torch.analysis import opcount

        counted = steps.build_prefill_cell(cfg, ShapeSpec("prefill", P, B, "prefill"), mesh)
        with torch.no_grad():
            _, summary = opcount.count(counted.fn, params, x, mesh=mesh, device="cuda")
        out["counted_prefill"] = counted_record(summary)
    del params
    torch.cuda.empty_cache()
    return out


def serve_ep_run(torch, mods, mesh, tokens):
    """deepseek-v3's one layer through ``build_prefill_cell`` /
    ``build_decode_cell`` on this rank's request (``mesh``: "data" of 2,
    expert-parallel) or on one device with G = 2 token groups and every
    expert (``mesh`` None, the reference): the prefill's last logits and
    EP_GEN - 1 decode steps fed ``tokens`` (B, EP_GEN - 1) (None: greedy,
    the reference's), each call's all-to-alls and K7 launches, the
    exchanges' ms and bytes, the first and a warm prefill and decode, the
    peak."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import sharding
    from repro_torch.launch import serve, steps
    from repro_torch.models import transformer
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config("deepseek-v3-671b"), num_layers=1)
    B, P = 2, EP_PROMPT
    torch.cuda.empty_cache()
    base = reset_peak(torch)
    pre = steps.build_prefill_cell(cfg, ShapeSpec("prefill", P + EP_GEN, B, "prefill"),
                                   mesh) if mesh is not None else None
    dec = steps.build_decode_cell(cfg, ShapeSpec("decode", P + EP_GEN, B, "decode"), mesh) if mesh is not None else None
    ranks = mesh.size if mesh is not None else 1
    held = None
    for turn in range(ranks):  # one rank at a time draws the whole layer, then keeps its experts
        if mesh is None or mesh.rank == turn:
            with torch.no_grad():
                params = transformer.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
                if mesh is not None:
                    params = sharding.expert_rows(params, mesh)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            held = sum(x.numel() * x.element_size() for x in leaves(params))
        if mesh is not None:
            dist.barrier()
    prompts = torch.from_numpy(serve.make_prompts(cfg, B, P, seed=1))
    rows = slice(None) if mesh is None else slice(mesh.rank * (B // ranks), (mesh.rank + 1) * (B // ranks))
    x = prompts[rows].cuda()

    def prefill():
        if pre is None:
            with sharding.using_hint_mesh(_Groups2()), torch.inference_mode():
                return transformer.prefill(params, cfg, x, P + EP_GEN)
        with torch.inference_mode():
            return pre.fn(params, x)

    def decode(caches, tok, pos):
        if dec is None:
            with sharding.using_hint_mesh(_Groups2()), torch.inference_mode():
                return transformer.decode_step(params, cfg, caches, tok, pos)
        with torch.inference_mode():
            return dec.fn(params, caches, tok, pos)

    exchanges = []
    orig = sharding.exchange_blocks

    def timed(t, m, axis):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = orig(t, m, axis)
        torch.cuda.synchronize()
        exchanges.append(((time.perf_counter() - t0) * 1e3, t.numel() * t.element_size()))
        return r

    runs = []
    for timed_run in (False, True):  # the first call, then a warm one with the exchanges timed
        if timed_run:
            sharding.exchange_blocks = timed
        try:
            for m in mods:
                m.reset_launch_counts()
            sharding.reset_counts()
            if mesh is not None:
                dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = prefill()
            torch.cuda.synchronize()
            pre_s = time.perf_counter() - t0
            pre_counts = dict(sharding.COUNTS)
            k7 = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}["flash_attention"]
            steps_out, step_counts = [], []
            if mesh is not None:
                dist.barrier()
            t0 = time.perf_counter()
            step_logits, fed = logits, []
            for j in range(EP_GEN - 1):
                sharding.reset_counts()
                if tokens is None:  # greedy (the reference)
                    tok = step_logits.argmax(-1).to(torch.int32)
                else:
                    tok = torch.from_numpy(tokens[rows, j]).cuda()
                fed.append(tok.cpu().numpy())
                pos = torch.full((tok.shape[0],), P + j, dtype=torch.int32, device="cuda")
                step_logits, caches = decode(caches, tok, pos)
                steps_out.append(step_logits.float().cpu().numpy())
                step_counts.append(dict(sharding.COUNTS))
            torch.cuda.synchronize()
            dec_s = time.perf_counter() - t0
        finally:
            sharding.exchange_blocks = orig
        runs.append({"prefill_s": pre_s, "decode_s": dec_s, "prefill_collectives": pre_counts, "k7": k7,
                     "step_collectives": step_counts})
        last_logits = {"prefill": logits.float().cpu().numpy(), "decode": steps_out}
        del caches
    out = {"runs": runs, "logits": last_logits, "param_bytes": held,
           "exchanges_ms_bytes": exchanges, "peak_memory_bytes": torch.cuda.max_memory_allocated() - base,
           "ep_mode": None if pre is None else pre.meta["ep_mode"]}
    out["tokens"] = np.stack(fed, axis=1).astype(np.int32)
    del params
    torch.cuda.empty_cache()
    return out


class _Groups2:
    """The single-device reference's hint mesh: a data axis of 2 (G = 2
    token groups) with every expert on the device, so the MoE dispatches
    both groups locally (what the exchange computes)."""

    axis_names = ("data",)
    shape = {"data": 2}


def world_rank(rank, world, jobs):
    """``dist.launch.spawn`` entry of the one 2-rank gloo world whose ranks
    share the card: the jobs, in order, each freeing its tensors before the
    next. "sharded" a client-sharded scenario (``sharded_job``); "train_cell"
    the train cell on a mesh of the job's shape and axes (lm-100m, or
    xlstm-350m's cut in the job's "tp_family" dtype); "tp_serve" lm-100m served over ("data", "model") of
    (1, 2); "serve_ep" deepseek-v3's layer expert-parallel over ("data",);
    "tp_family" a tensor-parallel serving job of ``TP_FAMILY_SERVE`` over
    (1, 2)."""
    import gc

    import torch

    from repro_torch import resolve_device
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hier_aggregate as ha
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.launch import mesh as lmesh

    entered = time.time()
    resolve_device("cuda")  # TF32 off
    tp_mesh = lambda: lmesh.make_host_mesh((1, world), ("data", "model"), device="cuda")  # noqa: E731
    out = []
    for job in jobs:
        t0 = time.perf_counter()
        kind = job["kind"]
        if kind == "sharded":
            out.append(sharded_job(torch, (ha, qz), world, job))
        elif kind == "train_cell":
            mesh = lmesh.make_host_mesh(job["shape"], job["axes"], device="cuda")
            cfg = tp_xlstm_train_config(job["tp_family"]) if "tp_family" in job else None
            out.append(train_cell_run(torch, (ha,), mesh, cfg, TP_XLSTM_CUT if cfg is not None else TRAIN_CUT))
        elif kind == "tp_serve":
            out.append(tp_serve_run(torch, (fa,), tp_mesh()))
        elif kind == "serve_ep":
            out.append(serve_ep_run(torch, (fa,), lmesh.make_host_mesh((world,), ("data",), device="cuda"),
                                    job["tokens"]))
        else:
            out.append(tp_family_serve_run(torch, (fa, rg), tp_mesh(), job["name"], job["tokens"]))
        out[-1]["job_seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    return handed_over(out, f"world{world}_rank{rank}", entered)


def handed_over(out, name, entered):
    """A rank's results written to a file under ``build/`` (pickle protocol
    5: arrays in one copy) and its path returned in their place, with when
    the rank entered and left its jobs: the parent reads the file back
    (``taken_back``). The pipe of ``dist.launch.spawn`` moved a rank's
    gigabytes of params at about 250 MB/s on an 8-core x86 host, one rank
    after the other."""
    import pickle

    path = ROOT / "build" / "worlds" / f"{name}.pkl"
    path.parent.mkdir(parents=True, exist_ok=True)
    left = time.time()
    with open(path, "wb") as f:
        pickle.dump(out, f, protocol=5)
    return {"path": str(path), "entered": entered, "left": left, "written": time.time()}


def taken_back(handed, spawned):
    """The ranks' results from their files (removed once read), and the
    world's times from the spawn (wall clock ``spawned``): when each rank
    entered its jobs, its jobs' seconds, its file's seconds, and the
    seconds from the last file to the results read."""
    import pickle

    outs = []
    for h in handed:
        with open(h["path"], "rb") as f:
            outs.append(pickle.load(f))
        Path(h["path"]).unlink()
    times = {"entered_s": [h["entered"] - spawned for h in handed],
             "jobs_s": [h["left"] - h["entered"] for h in handed],
             "write_s": [h["written"] - h["left"] for h in handed],
             "after_last_write_s": time.time() - max(h["written"] for h in handed)}
    return outs, times


def phase_world2(torch, mods, fa):
    """Every 2-rank job in one gloo world whose ranks share the card (one
    spawn and one init, where four worlds once took four): the client-sharded
    scenarios over 2 ranks (``W2_SHARDED``), ``train_cell_lm100m_w2``,
    ``tp_lm100m_m2``, ``serve_deepseekv3_l1_ep2``, and the tensor-parallel
    families over ("data", "model") of (1, 2): ``tp_recurrentgemma9b_m2``,
    ``tp_deepseekv3_l1_m2``, ``tp_xlstm350m_m2``. Each job's single-device
    reference runs here first, on the card, and is freed before the world
    starts; each phase then checks and reports its jobs. Returns the
    references' launches (the main path's)."""
    from repro_torch.dist import launch

    t0 = time.perf_counter()
    single = train_cell_run(torch, (mods[0],), None)
    serve_single = tp_serve_run(torch, (fa,), None)
    ep_ref = serve_ep_run(torch, (fa,), None, None)
    fam = {name: tp_family_serve_run(torch, mods, None, name, None) for name in TP_FAMILY_SERVE}
    xlstm_single = {dt: train_cell_run(torch, (mods[0],), None, tp_xlstm_train_config(dt), TP_XLSTM_CUT)
                    for dt in ("float32", "bfloat16")}
    torch.cuda.empty_cache()
    refs_s = time.perf_counter() - t0
    sharded = [dict(job, kind="sharded") for job in W2_SHARDED]
    train_w2 = {"kind": "train_cell", "shape": (2,), "axes": ("data",)}
    train_m2 = {"kind": "train_cell", "shape": (1, 2), "axes": ("data", "model")}
    serve_m2 = {"kind": "tp_serve"}
    ep2 = {"kind": "serve_ep", "tokens": ep_ref["tokens"]}
    xlstm_train = {dt: {"kind": "train_cell", "shape": (1, 2), "axes": ("data", "model"), "tp_family": dt}
                   for dt in xlstm_single}
    fam_jobs = {name: {"kind": "tp_family", "name": name, "tokens": fam[name]["tokens"]}
                for name in TP_FAMILY_SERVE}
    jobs = sharded + [train_w2, train_m2, serve_m2, ep2, *xlstm_train.values(), *fam_jobs.values()]
    t1, spawned = time.perf_counter(), time.time()
    ranks, times = taken_back(launch.spawn(world_rank, 2, "gloo", (jobs,)), spawned)
    world_s = time.perf_counter() - t1
    emit({"phase": "world2", "jobs": [j.get("phase", j.get("name", j["kind"])) for j in jobs],
          "references_seconds": refs_s, "world_seconds_with_spawn": world_s, "world_times": times,
          "rank_job_seconds": [[r["job_seconds"] for r in rank] for rank in ranks]})
    at = {id(j): i for i, j in enumerate(jobs)}
    part = lambda job: [rank[at[id(job)]] for rank in ranks]  # noqa: E731
    for job in sharded:
        sharded_checks(job["phase"], part(job), world_s)
    train_cell_checks(single, part(train_w2), world_s, refs_s)
    phase_tp_lm100m_m2(single, serve_single, part(train_m2), part(serve_m2))
    REFS["tp_prefill_counted"] = [r["counted_prefill"] for r in part(serve_m2)]
    ep2_checks(ep_ref, part(ep2), world_s)
    launches = dict(single["launches"])
    launches["flash_attention"] = launches.get("flash_attention", 0) + sum(
        r["runs"][0]["k7"] for r in part(ep2))
    phase_tp_recurrentgemma9b_m2(fam["tp_recurrentgemma9b_m2"], part(fam_jobs["tp_recurrentgemma9b_m2"]))
    phase_tp_deepseekv3_l1_m2(fam["tp_deepseekv3_l1_m2"], part(fam_jobs["tp_deepseekv3_l1_m2"]))
    phase_tp_xlstm350m_m2(xlstm_single, {dt: part(job) for dt, job in xlstm_train.items()},
                          fam["tp_xlstm350m_m2"], part(fam_jobs["tp_xlstm350m_m2"]))
    for ref in list(fam.values()) + list(xlstm_single.values()):
        for k, v in ref["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches


def train_cell_checks(single, data, world_s, refs_s):
    """``train_cell_lm100m_w2``: ``build_train_cell`` at lm-100m under
    ``fed_rules`` over a ("data",) mesh of 2 gloo ranks sharing the card
    (``data``, each rank's result): ``topology_for`` gives 16 clients on 4 edges, 8 (two whole
    edges) a rank; the cut shape ``TRAIN_CUT`` gives b 8, microbatch 4,
    accum 2; one cloud interval of kappa ``TRAIN_CELL_KAPPAS``, 4 calls.
    Held to the single-device cell over the same batches (``single``) at
    JAX's mesh tolerances; K1 one per leaf per level mean on each rank (the
    edge sync and the cloud's edge stage x 12 leaves: 24; the
    single-device cell's 36), one all-reduce, at the cloud sync."""
    import numpy as np

    t0 = time.perf_counter()
    check(single["meta"]["grad_accum"] == 2 and single["meta"]["num_clients"] == 16, f"train cell {single['meta']}")
    check(single["launches"]["grouped_mean"] == 36, f"train_cell single device launches {single['launches']}")
    for r in data:
        check(r["meta"]["sharded"] and r["state_rows"] == 8, f"train_cell_lm100m_w2: rank rows {r['state_rows']}")
        check(r["launches"]["grouped_mean"] == 24, f"train_cell_lm100m_w2 K1 {r['launches']}")
        check(r["collectives"]["all_reduce"] == 1 and r["collectives"]["all_to_all"] == 0,
              f"train_cell_lm100m_w2 collectives {r['collectives']}")
    loss_err = gnorm_err = 0.0
    for j, (loss, gnorm) in enumerate(single["per_step"]):
        losses = np.concatenate([r["per_step"][j][0] for r in data]).astype(np.float64)
        gsq = np.concatenate([r["per_step"][j][1] for r in data]).astype(np.float64)
        got = (losses.mean(), np.sqrt(gsq.sum()))
        for g, w, name in ((got[0], loss, "loss"), (got[1], gnorm, "grad_norm")):
            check(abs(g - w) <= SHARDED_LOSS_ATOL + SHARDED_LOSS_RTOL * abs(w),
                  f"train_cell_lm100m_w2 call {j} {name} {g} vs {w}")
        loss_err, gnorm_err = max(loss_err, abs(got[0] - loss)), max(gnorm_err, abs(got[1] - gnorm))
    worst = params_within_mesh_tolerance(data[0]["params"], single["params"], "train_cell_lm100m_w2")
    emit({"phase": "train_cell_lm100m_w2", "arch": "lm-100m", "shape": list(TRAIN_CUT), "mesh": {"data": 2},
          "kappas": list(TRAIN_CELL_KAPPAS), "cuts": TRAIN_CELL_CUTS, "meta": single["meta"],
          "calls": len(single["per_step"]), "references_seconds": refs_s,
          "world_seconds_with_spawn_and_every_job": world_s,
          "rank_job_seconds": [r["job_seconds"] for r in data],
          "single_device": {k: single[k] for k in ("launches", "wall_ms_first_call", "warm_wall_ms_per_call",
                                                   "peak_memory_bytes")},
          "ranks": [{k: r[k] for k in ("launches", "collectives", "wall_ms_first_call", "warm_wall_ms_per_call",
                                       "state_rows", "peak_memory_bytes")} for r in data],
          "vs_single_device_cell": {"loss_max_abs_err": loss_err, "grad_norm_max_abs_err": gnorm_err,
                                    "params_max_abs_err": worst,
                                    "tolerance": {"params": [SHARDED_RTOL, SHARDED_ATOL],
                                                  "loss": [SHARDED_LOSS_RTOL, SHARDED_LOSS_ATOL]}},
          "phase_seconds": time.perf_counter() - t0})


def params_within_mesh_tolerance(got, want, what) -> float:
    """Two runs' ``params_numpy`` leaves within JAX's mesh tolerances
    (``SHARDED_RTOL``, ``SHARDED_ATOL``); checked. Returns the largest
    difference."""
    import numpy as np

    worst, excess = 0.0, -1.0
    check(len(got) == len(want), f"{what}: {len(got)} leaves against {len(want)}")
    for a, b in zip(got, want):
        diff = np.abs(a.astype(np.float64) - b)
        worst = max(worst, float(diff.max()))
        excess = max(excess, float(np.max(diff - (SHARDED_ATOL + SHARDED_RTOL * np.abs(b)))))
    check(excess <= 0, f"{what}: params {worst} from the single-device cell")
    return worst


def model_dim(spec):
    """How a train cell leaf splits over "model" (``model_assembled``): the
    split dim, ("blocks", dim, blocks) for a ``BlockSplit`` dim (the sLSTM
    bias: the rank's part of each block), or None (whole)."""
    from repro_torch.dist import sharding

    for i, member in enumerate(spec):
        if isinstance(member, sharding.BlockSplit):
            return ("blocks", i, member.blocks)
        if member == "model":
            return i
    return None


def model_assembled(ranks, what="tp_lm100m_m2"):
    """The model ranks' ``params_numpy`` leaves put back together: a leaf
    split over "model" concatenated along its split dim in rank order (a
    ``BlockSplit`` leaf block by block), a whole one rank 0's (every rank's
    held within the mesh tolerance of it)."""
    import numpy as np

    out = []
    for i, dim in enumerate(ranks[0]["model_dims"]):
        parts = [r["params"][i] for r in ranks]
        if dim is None:
            params_within_mesh_tolerance(parts[1:], parts[:1] * (len(parts) - 1), f"{what} whole leaf {i}")
            out.append(parts[0])
        elif isinstance(dim, tuple):
            _, d, n = dim
            split = [p.reshape(p.shape[:d] + (n, -1) + p.shape[d + 1:]) for p in parts]
            whole = np.concatenate(split, axis=d + 1)
            out.append(whole.reshape(whole.shape[:d] + (-1,) + whole.shape[d + 2:]))
        else:
            out.append(np.concatenate(parts, axis=dim))
    return out


def phase_tp_lm100m_m2(single, serve_single, train, serve):
    """Tensor parallelism over a ("data", "model") mesh of (1, 2): the two
    gloo ranks of ``train_cell_lm100m_w2``'s world, each holding half of
    every split leaf of lm-100m (wq..wv, w1, w3, lm_head and embed's
    columns, wo and w2's rows; the norms whole).

    The train cell (16 clients on 4 edges, the 128 x 64 cut, microbatch 4,
    accum 2, kappa cut to ``TRAIN_CELL_KAPPAS``: 4 calls) against the
    single-device cell over the same batches and init: losses and grad
    norms at ``SHARDED_LOSS_RTOL``, the params after the cloud sync at
    JAX's mesh tolerances; K1 36 a rank (12 leaves x (the edge sync + the
    cloud's 2 stages), as on one device); a call's collectives (2 x (4 x 12
    + 2) sums, 2 maxes, 2 gathers, 1 grad-norm sum) and the last call's
    timed. Serving (``TP_BATCH`` x ``TP_PROMPT``, f32): K7 12 a prefill a
    rank (6 query heads over 2 KV heads, hd 64); the prefill's last
    logits and ``TP_GEN`` greedy decode steps against one device: the same
    tokens, logits within ``K_F32`` of the largest."""
    import numpy as np

    t0 = time.perf_counter()
    layers = 12
    for r in train:
        check(r["meta"]["model"] == 2 and not r["meta"]["sharded"] and r["state_rows"] == 16,
              f"tp_lm100m_m2 train meta {r['meta']}, rows {r['state_rows']}")
        check(r["launches"]["grouped_mean"] == 36, f"tp_lm100m_m2 K1 {r['launches']}")
        for c in r["collectives_per_call"]:
            want = {"tp_all_reduce": 2 * (4 * layers + 2), "tp_all_reduce_max": 2, "tp_all_gather": 2,
                    "tp_grad_norm": 1, "all_reduce": 0, "all_to_all": 0}
            check(all(c[k] == v for k, v in want.items()), f"tp_lm100m_m2 collectives a call {c}, want {want}")
    loss_err = gnorm_err = 0.0
    for j, (loss, gnorm) in enumerate(single["per_step"]):
        for r in train:
            got_loss, got_gnorm = r["per_step"][j]
            for g, w, name in ((got_loss, loss, "loss"), (got_gnorm, gnorm, "grad_norm")):
                check(abs(g - w) <= SHARDED_LOSS_ATOL + SHARDED_LOSS_RTOL * abs(w),
                      f"tp_lm100m_m2 call {j} {name} {g} vs {w}")
            loss_err, gnorm_err = max(loss_err, abs(got_loss - loss)), max(gnorm_err, abs(got_gnorm - gnorm))
    params_err = params_within_mesh_tolerance(model_assembled(train), single["params"], "tp_lm100m_m2")

    worst, scale = 0.0, 0.0
    for r in serve:
        check(r["first"]["k7"] == 12 and r["warm"]["k7"] == 12, f"tp_lm100m_m2 K7 a prefill {r['first']['k7']}")
        check(np.array_equal(r["tokens"], serve_single["tokens"]),
              f"tp_lm100m_m2 greedy tokens {r['tokens'].tolist()} vs {serve_single['tokens'].tolist()}")
        for got, want in [(r["prefill"], serve_single["prefill"])] + list(zip(r["decode"], serve_single["decode"])):
            err, big = float(np.abs(got - want).max()), float(np.abs(want).max())
            check(err <= K_F32 * big, f"tp_lm100m_m2 logits {err} of {big}")
            worst, scale = max(worst, err), max(scale, big)
        pc, dc = r["first"]["prefill_collectives"], r["first"]["decode_collectives_per_step"]
        check(pc["tp_all_reduce"] == 2 * layers and pc["tp_all_gather"] == 2 and dc["tp_all_reduce"] == 2 * layers
              and dc["tp_all_gather"] == 2, f"tp_lm100m_m2 serving collectives {pc}, {dc}")
    keep = ("prefill_s", "prefill_tokens_per_s", "decode_s", "decode_tokens_per_s")
    emit({"phase": "tp_lm100m_m2", "arch": "lm-100m", "mesh": {"data": 1, "model": 2}, "backend": "gloo",
          "train": {"shape": list(TRAIN_CUT), "kappas": list(TRAIN_CELL_KAPPAS), "cuts": TRAIN_CELL_CUTS,
                    "calls": len(single["per_step"]),
                    "single_device": {k: single[k] for k in ("launches", "wall_ms_first_call",
                                                             "warm_wall_ms_per_call", "peak_memory_bytes")},
                    "ranks": [{k: r[k] for k in ("launches", "wall_ms_first_call", "warm_wall_ms_per_call",
                                                 "timed_call_wall_ms", "timed_call_collectives",
                                                 "peak_memory_bytes")} | {"collectives_a_call":
                                                                          r["collectives_per_call"][1]}
                              for r in train],
                    "vs_single_device_cell": {"loss_max_abs_err": loss_err, "grad_norm_max_abs_err": gnorm_err,
                                              "params_max_abs_err": params_err,
                                              "tolerance": {"params": [SHARDED_RTOL, SHARDED_ATOL],
                                                            "loss": [SHARDED_LOSS_RTOL, SHARDED_LOSS_ATOL]}}},
          "serve": {"batch": TP_BATCH, "prompt_len": TP_PROMPT, "gen": TP_GEN, "dtype": "float32",
                    "single_device": {**{f"first_{k}": serve_single["first"][k] for k in keep},
                                      **{f"warm_{k}": serve_single["warm"][k] for k in keep},
                                      "param_bytes": serve_single["param_bytes"],
                                      "peak_memory_bytes": serve_single["peak_memory_bytes"]},
                    "ranks": [{**{f"first_{k}": r["first"][k] for k in keep},
                               **{f"warm_{k}": r["warm"][k] for k in keep},
                               "k7_a_prefill": r["first"]["k7"], "prefill_collectives": r["first"]["prefill_collectives"],
                               "decode_collectives_per_step": r["first"]["decode_collectives_per_step"],
                               "timed_run_collectives": r["timed_run_collectives"], "param_bytes": r["param_bytes"],
                               "peak_memory_bytes": r["peak_memory_bytes"]} for r in serve],
                    "vs_single_device": {"tokens_equal": True, "logits_max_abs_err": worst,
                                         "max_abs_logit": scale, "tolerance": f"{K_F32} x max |logit|"}},
          "phase_seconds": time.perf_counter() - t0})


def tp_family_config(name):
    """(config, batch, prompt, decode steps, launches a prefill) of a
    ``TP_FAMILY_SERVE`` job."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    arch, cut, b, p, g, launches = TP_FAMILY_SERVE[name]
    return dataclasses.replace(get_config(arch), **cut), b, p, g, launches


def tp_xlstm_train_config(dtype="float32"):
    """xlstm-350m cut to ``TP_XLSTM_CUTS``: one superblock in ``dtype`` on 4
    clients over 2 edges, kappa (2, 2)."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    cfg = get_config("xlstm-350m")
    return dataclasses.replace(cfg, num_layers=4, param_dtype=dtype, compute_dtype=dtype,
                               fed=dataclasses.replace(cfg.fed, edges_per_pod=2, clients_per_edge=2, kappa1=2,
                                                       kappa2=2))


@contextlib.contextmanager
def moe_drops(record):
    """Every MoE dispatch's assignments while the block runs, appended to
    ``record`` on the host: (expert ids (T K,), dropped (T K,) bool)."""
    from repro_torch.models import layers

    dispatch = layers._moe_dispatch

    def spy(xg, ids, num_experts, capacity):
        out = dispatch(xg, ids, num_experts, capacity)
        record.append((out[1].cpu().numpy(), (out[2] >= capacity).cpu().numpy()))
        return out

    layers._moe_dispatch = spy
    try:
        yield
    finally:
        layers._moe_dispatch = dispatch


def tp_family_serve_run(torch, mods, mesh, name, tokens):
    """One ``TP_FAMILY_SERVE`` job on this rank's tensor-parallel slices
    (``mesh``: ("data", "model") of (1, 2)) through ``build_prefill_cell``
    / ``build_decode_cell``, or on one device (None) through
    ``transformer.prefill`` / ``decode_step``. The ranks draw the init one
    at a time (``init_params(mesh=)``: each block cut to the rank's slices
    as it is drawn). The prefill's last logits and the launches a prefill,
    then the decode steps fed ``tokens`` (B, steps) (None: greedy), each
    step's logits; the MoE's dispatches (``moe_drops``); over the mesh every
    sum and gather timed (``timed_tp_collectives``, the device drained
    around each); the walls, tokens/s, param bytes and peak. xlstm-350m
    also prefills 2 x ``TP_XLSTM_GAP_PROMPT`` tokens (its gap to one device
    is reported, not held)."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist import sharding
    from repro_torch.launch import serve, steps
    from repro_torch.models import transformer
    from repro_torch.tree import leaves

    cfg, B, P, G, _ = tp_family_config(name)
    torch.cuda.empty_cache()
    base = reset_peak(torch)
    cells = None
    if mesh is not None:
        cells = (steps.build_prefill_cell(cfg, ShapeSpec("prefill", P + G, B, "prefill"), mesh),
                 steps.build_decode_cell(cfg, ShapeSpec("decode", P + G, B, "decode"), mesh))
    for turn in range(1 if mesh is None else mesh.size):  # one rank at a time draws the whole init
        if mesh is None or mesh.rank == turn:
            with torch.no_grad():
                params = transformer.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, mesh=mesh)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        if mesh is not None:
            dist.barrier()
    held = sum(x.numel() * x.element_size() for x in leaves(params))
    init_peak = torch.cuda.max_memory_allocated() - base

    def prefill(x, max_len):
        with torch.inference_mode():
            if cells is None:
                return transformer.prefill(params, cfg, x, max_len)
            return cells[0].fn(params, x)

    def decode(caches, tok, pos):
        with torch.inference_mode():
            if cells is None:
                return transformer.decode_step(params, cfg, caches, tok, pos)
            return cells[1].fn(params, caches, tok, pos)

    x = torch.from_numpy(serve.make_prompts(cfg, B, P, seed=1)).cuda()
    restore, timed = timed_tp_collectives(torch) if mesh is not None else (None, [])
    drops = []
    try:
        for m in mods:
            m.reset_launch_counts()
        sharding.reset_counts()
        if mesh is not None:
            dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with moe_drops(drops):
            logits, caches = prefill(x, P + G)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
        pre_counts, pre_timed = dict(sharding.COUNTS), len(timed)
        out = {"prefill": logits.float().cpu().numpy(), "decode": [], "tokens": []}
        sharding.reset_counts()
        t0 = time.perf_counter()
        with moe_drops(drops):
            for j in range(G):
                tok = logits.argmax(-1).to(torch.int32) if tokens is None else torch.from_numpy(tokens[:, j]).cuda()
                out["tokens"].append(tok.cpu().numpy())
                logits, caches = decode(caches, tok, torch.full((B,), P + j, dtype=torch.int32, device="cuda"))
                out["decode"].append(logits.float().cpu().numpy())
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        dec_counts = {k: v / G for k, v in sharding.COUNTS.items()}
    finally:
        if restore is not None:
            restore()
    del caches
    out.update(tokens=np.stack(out["tokens"], axis=1), launches=launches, param_bytes=held,
               init_peak_memory_bytes=init_peak, prefill_s=pre_s, prefill_tokens_per_s=B * P / pre_s,
               decode_s=dec_s, decode_tokens_per_s=B * G / dec_s, prefill_collectives=pre_counts,
               decode_collectives_per_step=dec_counts, drops=drops,
               prefill_timed_collectives=tp_collectives_report(timed[:pre_timed]),
               decode_timed_collectives=tp_collectives_report(timed[pre_timed:]))
    if name == "tp_xlstm350m_m2":
        xg = torch.from_numpy(serve.make_prompts(cfg, 2, TP_XLSTM_GAP_PROMPT, seed=2)).cuda()
        out["gap_prefill"] = prefill(xg, TP_XLSTM_GAP_PROMPT)[0].float().cpu().numpy()
    if name == "tp_deepseekv3_l1_m2":
        out["overflow"] = moe_overflow_run(torch, cfg, params, mesh)
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated() - base
    del params
    torch.cuda.empty_cache()
    return out


def moe_overflow_run(torch, cfg, params, mesh):
    """deepseek-v3's MoE layer alone (``layers.moe_apply``) on
    ``MOE_OVERFLOW``'s random bf16 tokens at its capacity factor, where the
    busiest experts overflow, on this rank's slices of each expert under
    ``mesh``'s hint (None: one device, every column): y on the host in f32
    and the dispatch's (expert ids, dropped)."""
    import dataclasses

    from repro_torch.dist import sharding
    from repro_torch.models import layers
    from repro_torch.tree import tree_map

    tokens, factor = MOE_OVERFLOW
    low = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))
    moe = tree_map(lambda v: v[0], params["blocks"]["b0"]["moe"])
    x = torch.randn((tokens, cfg.d_model), generator=torch.Generator(device="cuda").manual_seed(5),
                    device="cuda").to(torch.bfloat16)
    drops = []
    with torch.inference_mode(), moe_drops(drops), sharding.using_hint_mesh(mesh):
        y, _ = layers.moe_apply(moe, x, low)
    return {"y": y.float().cpu().numpy(), "drops": drops, "capacity": layers.moe_capacity(tokens, low)}


def tp_family_agreement(what, ref, ranks, rtol, held_steps=None):
    """Each rank's prefill and decode logits against one device's (``ref``,
    the same tokens fed): the prefill and the first ``held_steps`` decode
    steps (None: every one) within ``rtol`` of the largest |logit| of
    their call, checked; every call's gap reported. Returns the report."""
    import numpy as np

    worst, scale, calls = 0.0, 0.0, {}
    for r in ranks:
        check(np.array_equal(r["tokens"], ref["tokens"]), f"{what}: the fed tokens differ")
        for j, (call, got, want) in enumerate([("prefill", r["prefill"], ref["prefill"])] + [
                (f"decode_{j}", g, w) for j, (g, w) in enumerate(zip(r["decode"], ref["decode"]))]):
            err, big = float(np.abs(got - want).max()), float(np.abs(want).max())
            calls[call] = max(calls.get(call, 0.0), err / big)
            if held_steps is None or j <= held_steps:
                check(np.isfinite(got).all() and err <= rtol * big, f"{what} {call}: logits {err} of {big}")
                worst, scale = max(worst, err), max(scale, big)
    top1 = float(np.mean([np.mean(r["prefill"].argmax(-1) == ref["prefill"].argmax(-1)) for r in ranks]))
    return {"logits_max_abs_err": worst, "max_abs_logit": scale, "tolerance": f"{rtol} x max |logit|",
            "held_calls": "all" if held_steps is None else f"prefill and decode_0..{held_steps - 1}",
            "err_over_max_logit_by_call": calls, "prefill_top1_agreement": top1}


def tp_family_report(ref, ranks):
    keep = ("prefill_s", "prefill_tokens_per_s", "decode_s", "decode_tokens_per_s", "param_bytes",
            "peak_memory_bytes", "init_peak_memory_bytes")
    return {"single_device": {k: ref[k] for k in keep},
            "ranks": [{**{k: r[k] for k in keep}, "launches_a_prefill": r["launches"],
                       "prefill_collectives": r["prefill_collectives"],
                       "decode_collectives_per_step": r["decode_collectives_per_step"],
                       "prefill_timed_collectives": r["prefill_timed_collectives"],
                       "decode_timed_collectives": r["decode_timed_collectives"], "job_seconds": r["job_seconds"]}
                      for r in ranks],
            "timing": "every sum and gather of a rank's run timed with the device drained around it"}


def tp_family_checks(name, ref, ranks, sums, gathers=2):
    """The launches a prefill on each rank and on one device (each rank's
    kernels on its slices), and each call's collectives: ``sums`` a
    forward, ``gathers`` gathers."""
    want = tp_family_config(name)[4]
    check_launches(ref["launches"], want, f"{name} single device")
    for r in ranks:
        check_launches(r["launches"], want, f"{name} rank")
        for c in (r["prefill_collectives"], r["decode_collectives_per_step"]):
            check(c["tp_all_reduce"] == sums and c["tp_all_gather"] == gathers and c["all_to_all"] == 0,
                  f"{name} collectives {c}: want {sums} sums and {gathers} gathers a call")


def phase_tp_recurrentgemma9b_m2(ref, ranks):
    """recurrentgemma-9b (arXiv:2402.19427; 9.57B, bf16) served at full width
    over ("data", "model") of (1, 2): 2 x 4096 prompts, 8 decode steps fed
    one device's greedy tokens. A rank holds half of every RG-LRU's 4096
    channels (its scan on 2048: K8 26 a prefill at (2, 4096, 2048)), 8 of
    the 16 query heads of each local-attention layer over the one KV head
    (K7 12 a prefill), half of each MLP; the rest whole. 76 sums a call
    (26 RG-LRU, 12 attention and 38 MLP outputs: the partials in f32,
    rounded to bf16 once) and 2 gathers. The logits within K_BF16 of the
    largest of one device's, run first in the main process."""
    t0 = time.perf_counter()
    tp_family_checks("tp_recurrentgemma9b_m2", ref, ranks, sums=76)
    agreement = tp_family_agreement("tp_recurrentgemma9b_m2", ref, ranks, K_BF16)
    cfg = tp_family_config("tp_recurrentgemma9b_m2")[0]
    emit({"phase": "tp_recurrentgemma9b_m2", "arch": cfg.name, "dtype": "bfloat16", "mesh": {"data": 1, "model": 2},
          "backend": "gloo", "batch": 2, "prompt_len": 4096, "gen": 8, "vs_single_device": agreement,
          **tp_family_report(ref, ranks), "phase_seconds": time.perf_counter() - t0})


def phase_tp_deepseekv3_l1_m2(ref, ranks):
    """deepseek-v3-671b (arXiv:2412.19437) cut to 1 of its 61 layers at full
    widths over ("data", "model") of (1, 2): 1 x 4096, 8 decode steps. A
    rank holds 64 of MLA's 128 heads (``wq_b``, ``wkv_b``, ``wo``'s rows; K7
    once a prefill on the 64 heads, v padded to 192), the whole latent
    projections and cache, and 1024 of each of the 256 experts' 2048 columns
    and of the shared expert's; the router whole, so each rank routes the
    whole x as one device does. 3 sums a call (MLA's output, the MoE's f32
    combine, the shared expert) and 2 gathers. Logits within MOE_REF_RTOL
    (2^-7) of the largest of one device's; every dispatch's dropped
    assignments equal to one device's (none drop at the prefill's capacity,
    and MLA's rounding reaches the router's input, so a few expert ids are
    reported apart). Then the MoE alone on the same tokens at
    ``MOE_OVERFLOW``'s capacity, where experts overflow: expert ids and
    dropped assignments equal to one device's, some dropped, y within
    MOE_REF_RTOL of the largest."""
    import numpy as np

    t0 = time.perf_counter()
    tp_family_checks("tp_deepseekv3_l1_m2", ref, ranks, sums=3)
    agreement = tp_family_agreement("tp_deepseekv3_l1_m2", ref, ranks, MOE_REF_RTOL)
    drops = {"dispatches": len(ref["drops"]), "dropped": int(sum(d.sum() for _, d in ref["drops"]))}
    for r in ranks:
        check(len(r["drops"]) == len(ref["drops"]), f"tp_deepseekv3_l1_m2: {len(r['drops'])} dispatches")
        routed = sum(int((e != we).sum()) for (e, _), (we, _) in zip(r["drops"], ref["drops"]))
        differ = sum(int((d != wd).sum()) for (_, d), (_, wd) in zip(r["drops"], ref["drops"]))
        drops.setdefault("assignments_routed_apart", []).append(routed)
        drops.setdefault("dropped_apart", []).append(differ)
        check(differ == 0, f"tp_deepseekv3_l1_m2: {differ} assignments dropped apart from one device "
                           f"({routed} routed apart)")
    # the serving run drops nothing, so equal drops are held where experts
    # overflow: the MoE alone on the same tokens, routed and dropped as on
    # one device
    want = ref["overflow"]
    (want_ids, want_drop), = want["drops"]
    scale = float(np.abs(want["y"]).max())
    overflow = {"tokens": MOE_OVERFLOW[0], "capacity_factor": MOE_OVERFLOW[1], "capacity": want["capacity"],
                "assignments": int(want_drop.size), "dropped": int(want_drop.sum()), "max_abs_y": scale,
                "y_max_abs_err": [], "tolerance": f"{MOE_REF_RTOL} x max |y|"}
    check(overflow["dropped"] > 0, f"tp_deepseekv3_l1_m2 overflow: no assignment dropped at {overflow}")
    for r in ranks:
        (ids, drop), = r["overflow"]["drops"]
        err = float(np.abs(r["overflow"]["y"] - want["y"]).max())
        overflow["y_max_abs_err"].append(err)
        check(np.array_equal(ids, want_ids) and np.array_equal(drop, want_drop),
              f"tp_deepseekv3_l1_m2 overflow: {int((ids != want_ids).sum())} routed and "
              f"{int((drop != want_drop).sum())} dropped apart from one device")
        check(np.isfinite(r["overflow"]["y"]).all() and err <= MOE_REF_RTOL * scale,
              f"tp_deepseekv3_l1_m2 overflow: y {err} of {scale}")
    drops["overflow"] = overflow
    emit({"phase": "tp_deepseekv3_l1_m2", "arch": "deepseek-v3-671b", "layers": 1, "dtype": "bfloat16",
          "mesh": {"data": 1, "model": 2}, "backend": "gloo", "batch": 1, "prompt_len": 4096, "gen": 8,
          "vs_single_device": agreement, "moe_drops": drops, **tp_family_report(ref, ranks),
          "phase_seconds": time.perf_counter() - t0})


def tp_xlstm_train_checks(single, train, f32_single=None):
    """One dtype of ``tp_xlstm350m_m2``'s train cell on the two ranks
    (``train``) against one device's (``single``): K1 123 a rank, the
    collectives of every call, every call's loss and grad norm. f32 (no
    ``f32_single``): at ``SHARDED_LOSS_RTOL``, the params after the cloud
    sync reassembled at JAX's mesh tolerances. bf16: within bf16's own gap,
    the largest relative distance over the calls of one device's bf16 cell
    from its f32 cell (``f32_single``), loss and grad norm each; the
    params' gap reported. Returns the report."""
    import numpy as np

    f32 = f32_single is None
    what = f"tp_xlstm350m_m2 {'float32' if f32 else 'bfloat16'}"
    check(single["launches"]["grouped_mean"] == 123, f"{what} single device K1 {single['launches']}")
    accum = single["meta"]["grad_accum"]
    for r in train:
        check(r["meta"]["model"] == 2 and not r["meta"]["sharded"] and r["state_rows"] == 4,
              f"{what} train meta {r['meta']}, rows {r['state_rows']}")
        check(r["launches"]["grouped_mean"] == 123, f"{what} K1 {r['launches']}")
        for c in r["collectives_per_call"]:
            want = {"tp_all_reduce": accum * (4 + 7 + 2), "tp_all_reduce_max": accum, "tp_all_gather": accum,
                    "tp_grad_norm": 1, "all_reduce": 0, "all_to_all": 0}
            check(all(c[k] == v for k, v in want.items()), f"{what} collectives a call {c}, want {want}")
    names = ("loss", "grad_norm")
    if f32:
        tol = {name: [SHARDED_LOSS_RTOL, SHARDED_LOSS_ATOL] for name in names}
    else:
        pairs = list(zip(single["per_step"], f32_single["per_step"]))
        tol = {name: [max(abs(b[q] - f[q]) / abs(f[q]) for b, f in pairs), 0.0]
               for q, name in enumerate(names)}
    calls = {"single_device": single["per_step"], "ranks": [r["per_step"] for r in train]}
    if not f32:
        calls["single_device_float32"] = f32_single["per_step"]
    errs = dict.fromkeys(names, 0.0)
    for j, want in enumerate(single["per_step"]):
        for r in train:
            for q, name in enumerate(names):
                (rtol, atol), g, w = tol[name], r["per_step"][j][q], want[q]
                check(abs(g - w) <= atol + rtol * abs(w),
                      f"{what} call {j} {name} {g} vs {w} (tolerance {tol[name]}; every call (loss, "
                      f"grad norm): {calls})")
                errs[name] = max(errs[name], abs(g - w))
    got = model_assembled(train, what)
    vs = {"loss_max_abs_err": errs["loss"], "grad_norm_max_abs_err": errs["grad_norm"], "calls": calls}
    if f32:
        vs["params_max_abs_err"] = params_within_mesh_tolerance(got, single["params"], what)
        vs["tolerance"] = {"params": [SHARDED_RTOL, SHARDED_ATOL], **tol}
    else:
        check(len(got) == len(single["params"]), f"{what}: {len(got)} leaves")
        gaps = [float(np.abs(a.astype(np.float64) - b).max()) for a, b in zip(got, single["params"])]
        vs.update(params_max_abs_err=max(gaps), params_max_err_over_leaf_max=max(
                      g / max(float(np.abs(b).max()), 1e-30) for g, b in zip(gaps, single["params"])),
                  params_held=False,
                  tolerance={"relative": "one device's bf16 cell from its f32 cell, the most over the calls",
                             **tol})
    keep = ("launches", "wall_ms_first_call", "warm_wall_ms_per_call", "peak_memory_bytes")
    return {"single_device": {k: single[k] for k in keep},
            "ranks": [{k: r[k] for k in ("launches", "wall_ms_first_call", "warm_wall_ms_per_call",
                                         "timed_call_wall_ms", "timed_call_collectives", "peak_memory_bytes",
                                         "job_seconds")}
                      | {"collectives_a_call": r["collectives_per_call"][1]} for r in train],
            "vs_single_device_cell": vs}


def phase_tp_xlstm350m_m2(single, train, ref, ranks):
    """xlstm-350m (arXiv:2405.04517) at its published widths (d 1024, 2 of
    its 4 heads a rank) over ("data", "model") of (1, 2).

    The train cell cut to ``TP_XLSTM_CUTS`` (one superblock, 4 clients on 2
    edges, kappa (2, 2), 8-token sequences, accum 2), in f32 and in bf16
    (``single`` and ``train`` by dtype), against the single-device cell
    over the same batches and init (``tp_xlstm_train_checks``); K1 on every
    sync of each rank's slices (41 leaves x (the edge sync + the cloud's 2
    stages): 123 a rank, as on one device); a call's collectives (per loss
    and gradient 4 sums forward, 7 backward (the mLSTM's two copies, the
    sLSTM's one), the loss's 2; a max, a gather; one grad-norm sum), the
    last call's timed. In bf16 under ``torch.func`` the row-parallel
    products upcast their operands to f32 (``layers._matmul_f32``): the
    warm walls of both dtypes show that cost.

    Serving: all 24 layers in f32 (``TP_FAMILY_SERVE``), 2 x 8 prompts: the
    prefill and the first decode step (the 8-token prompt's state) within
    K_F32 of one device's logits, the other 7 steps' gaps and the 2 x 256
    prefill's reported, not held (the sLSTM's chaos at full width); 24 sums
    and 2 gathers a call."""
    import numpy as np

    t0 = time.perf_counter()
    trains = {"float32": tp_xlstm_train_checks(single["float32"], train["float32"]),
              "bfloat16": tp_xlstm_train_checks(single["bfloat16"], train["bfloat16"], single["float32"])}
    tp_family_checks("tp_xlstm350m_m2", ref, ranks, sums=24)
    agreement = tp_family_agreement("tp_xlstm350m_m2", ref, ranks, K_F32, held_steps=TP_XLSTM_HELD_STEPS)
    gap = [float(np.abs(r["gap_prefill"] - ref["gap_prefill"]).max()) for r in ranks]
    emit({"phase": "tp_xlstm350m_m2", "arch": "xlstm-350m", "mesh": {"data": 1, "model": 2}, "backend": "gloo",
          "train": {"shape": list(TP_XLSTM_CUT), "cuts": TP_XLSTM_CUTS,
                    "calls": len(single["float32"]["per_step"]), "meta": single["float32"]["meta"], **trains},
          "serve": {"dtype": "float32", "layers": 24, "batch": 2, "prompt_len": XLSTM_CHECK_PROMPT, "gen": 8,
                    "vs_single_device": agreement, **tp_family_report(ref, ranks),
                    "gap_prefill_2x256": {"max_abs_err": gap, "max_abs_logit": float(np.abs(ref["gap_prefill"]).max()),
                                          "held": False}},
          "phase_seconds": time.perf_counter() - t0})


def first_difference(got, want):
    """(index, got, want) of the first element where two arrays differ, or None."""
    import numpy as np

    idx = np.argwhere(got != want)
    if not len(idx):
        return None
    i = tuple(int(v) for v in idx[0])
    return {"index": list(i), "got": float(got[i]), "want": float(want[i])}


def ep2_checks(ref, ranks, world_s):
    """``serve_deepseekv3_l1_ep2``: deepseek-v3-671b cut to 1 layer at full
    widths (as ``serve_deepseekv3_l1``) through ``build_prefill_cell`` /
    ``build_decode_cell`` under ``serve_rules`` on 2 gloo ranks with a
    "data" axis of 2: ``moe_ep_mode`` "ep_data", 128 of the 256 experts a
    rank, one request of 4096 tokens a rank, 16 generated. Per MoE call one
    dispatch and one combine all-to-all (and the router statistics'
    all-reduce); K7 once per prefill a rank. Prefill logits and every
    decode step held to a single-device card run of the same 2 requests
    with G = 2 token groups and every expert (``ref``, run first, then
    freed): bit for bit expected, else within 2^-7 of the largest |logit|.
    The exchange's ms and bytes, each rank's parameter bytes and peak, the
    warm prefill and decode tokens/s (the host path: on one card the
    exchange goes through gloo's host copies)."""
    import numpy as np

    t0 = time.perf_counter()
    want = ref["logits"]
    pairs = [("prefill", np.concatenate([r["logits"]["prefill"] for r in ranks]), want["prefill"])] + [
        (f"decode_{j}", np.concatenate([r["logits"]["decode"][j] for r in ranks]), want["decode"][j])
        for j in range(len(want["decode"]))]
    report, bit_equal = [], True
    for name, got, w in pairs:
        err, scale = float(np.max(np.abs(got - w))), float(np.max(np.abs(w)))
        first = first_difference(got, w)
        bit_equal = bit_equal and first is None
        check(np.isfinite(got).all() and err <= MOE_REF_RTOL * scale,
              f"serve_deepseekv3_l1_ep2 {name}: {err} (scale {scale}), first difference {first}")
        report.append({"call": name, "max_abs_err": err, "max_abs_logit": scale, "first_difference": first})
    for r in ranks:
        check(r["ep_mode"] == "ep_data", f"serve_deepseekv3_l1_ep2 mode {r['ep_mode']}")
        for run in r["runs"]:
            c = run["prefill_collectives"]
            check(c["all_to_all"] == 2 and c["moe_aux_all_reduce"] == 1 and run["k7"] == 1,
                  f"serve_deepseekv3_l1_ep2 prefill: {c}, K7 {run['k7']}")
            check(all(s["all_to_all"] == 2 for s in run["step_collectives"]),
                  f"serve_deepseekv3_l1_ep2 decode collectives {run['step_collectives']}")
    warm = [r["runs"][1] for r in ranks]
    pre_s, dec_s = max(w["prefill_s"] for w in warm), max(w["decode_s"] for w in warm)
    exch = ranks[0]["exchanges_ms_bytes"]
    emit({"phase": "serve_deepseekv3_l1_ep2", "arch": "deepseek-v3-671b", "layers": 1, "batch": 2,
          "prompt_len": EP_PROMPT, "gen": EP_GEN, "mesh": {"data": 2}, "world_seconds_with_spawn_and_every_job": world_s,
          "vs_single_device_g2": {"bit_equal": bit_equal, "calls": report, "tolerance": f"{MOE_REF_RTOL} x max |logit|"},
          "prefill_exchange": {"dispatch_ms": exch[0][0], "combine_ms": exch[1][0], "bytes_each_way": exch[0][1]},
          "decode_exchange_ms": [e[0] for e in exch[2:]],
          "warm_prefill_tokens_per_s": 2 * EP_PROMPT / pre_s, "warm_decode_tokens_per_s": 2 * (EP_GEN - 1) / dec_s,
          "reference_warm_prefill_tokens_per_s": 2 * EP_PROMPT / ref["runs"][1]["prefill_s"],
          "reference_warm_decode_tokens_per_s": 2 * (EP_GEN - 1) / ref["runs"][1]["decode_s"],
          "path": "host: the ranks share one card and exchange through gloo's host copies",
          "ranks": [{"param_bytes": r["param_bytes"], "peak_memory_bytes": r["peak_memory_bytes"],
                     "prefill_s": [x["prefill_s"] for x in r["runs"]], "decode_s": [x["decode_s"] for x in r["runs"]]}
                    for r in ranks],
          "reference": {"param_bytes": ref["param_bytes"], "peak_memory_bytes": ref["peak_memory_bytes"]},
          "job_seconds": [r["job_seconds"] for r in ranks], "phase_seconds": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# The paper's CNNs (Section IV-A), their divergences, Theorem 1, the roofline
# ---------------------------------------------------------------------------
# (image shape, training images, init, apply) of each dataset's stand-in
PAPER_DATA = {"cifar10": ((32, 32, 3), 50_000, "init_cifar_cnn", "cifar_cnn_apply"),
              "mnist": ((28, 28, 1), 60_000, "init_mnist_cnn", "mnist_cnn_apply")}
# the stand-in's scale: pixels of about 0.14 (centers and noise 0.1).
# At clustered_gaussians' default (3.0, 1.0) the CIFAR CNN's first SGD
# steps at lr 0.1 overflow to inf and nan, as at centres 1.0 and 0.3
PAPER_DATA_SCALE = dict(class_sep=0.1, noise=0.1)
PAPER_KAPPAS = {"cifar10": (5, 10), "mnist": (15, 4)}  # configs/paper.py CIFAR_KAPPAS[3], MNIST_KAPPAS[2]
PAPER_INTERVALS = {"cifar10": 2, "mnist": 1}
# the card against the CPU: 4 clients on 2 edges, kappa (2, 2), one cloud
# interval, 200 images a client (the CPU takes the divergences' full
# batches too); losses within PAPER_LOSS_RTOL, params within tests/
# test_torch_cnn.py's tolerance, the divergences within DIVERGENCE_RTOL
PAPER_CUT = dict(num_edges=2, clients_per_edge=2, kappas=(2, 2), per_client=200)
PAPER_LOSS_RTOL = 1e-4
PAPER_PARAMS_TOL = dict(rtol=1e-4, atol=1e-5)
DIVERGENCE_RTOL = 1e-4
PAPER_HELD_OUT = 10_000  # more images of the same clusters, never trained on: the cloud model's loss
BETA_SAMPLE, BETA_CHUNK = 10_000, 1_000  # the beta estimate's gradients: a fixed sample of the images, in chunks
# Theorem 1's constants that no run measures (Lipschitz rho, the bound's
# epsilon and varphi): fixed and printed beside the bound
THEOREM1_CONSTANTS = dict(rho=1.0, epsilon=1.0, varphi=0.5)
PEAK_N = 8192  # measure_host_peaks' product side on the card: a 1.1 TFLOP product, a 2.1 GB array added


def paper_problem(torch, dataset, device, *, num_edges=5, clients_per_edge=10, kappas=None, per_client=None,
                  held_out=0, seed=0):
    """The paper's setting (``configs/paper.py``: batch 20, SGD without
    momentum, the dataset's lr decayed per epoch) on a synthetic stand-in of
    the dataset's images (``clustered_gaussians``, the same draws on every
    device), partitioned edge-NIID, with the CNN's init from ``seed`` (on
    the host) and the superround; ``held_out`` more images of the same
    clusters stay out of training. The images stay on ``device``; a block
    of batches is a gather there (``paper_blocks``)."""
    import types

    import numpy as np

    from repro_torch import optim
    from repro_torch.configs import paper
    from repro_torch.core import hierfavg as th
    from repro_torch.data import partition, synthetic
    from repro_torch.models import cnn

    pc = {"cifar10": paper.CIFAR10, "mnist": paper.MNIST}[dataset]
    shape, total, init, apply = PAPER_DATA[dataset]
    kappas = kappas or PAPER_KAPPAS[dataset]
    n = num_edges * clients_per_edge
    per_client = per_client or total // pc.num_clients
    data = synthetic.clustered_gaussians(np.random.default_rng(seed), num_samples=per_client * n + held_out,
                                         dim=shape, **PAPER_DATA_SCALE)
    train = per_client * n
    parts = partition.partition("edge_niid", data.y[:train], num_edges, clients_per_edge,
                                np.random.default_rng(seed + 1))
    sizes = np.array([len(p) for p in parts], np.float32)
    topo = th.FedTopology(num_edges=num_edges, clients_per_edge=clients_per_edge)
    cfg = th.HierFAVGConfig(kappa1=kappas[0], kappa2=kappas[1])
    opt = optim.sgd(optim.exponential_decay(pc.lr, pc.lr_decay, per_client // pc.batch_size))  # decay per epoch
    loss_fn = cnn.make_cnn_loss_fn(getattr(cnn, apply))
    weights = torch.from_numpy(sizes).to(device)
    return types.SimpleNamespace(
        dataset=dataset, pc=pc, device=device, parts=parts, sizes=sizes, topo=topo, cfg=cfg, opt=opt,
        loss_fn=loss_fn, apply=getattr(cnn, apply), weights=weights,
        params=getattr(cnn, init)(torch.Generator().manual_seed(seed + 2)),
        x=torch.from_numpy(data.x[:train]).to(device), y=torch.from_numpy(data.y[:train]).to(device),
        x_held=torch.from_numpy(data.x[train:]).to(device), y_held=torch.from_numpy(data.y[train:]).to(device),
        super_round=th.build_super_round(loss_fn, opt, topo, cfg, weights))


def paper_blocks(torch, prob, seed=0):
    """Each cloud interval's batches, (kappa2, kappa1, N, 20, ...): the
    ``FederatedBatcher``'s per-client epoch shuffles over sample indices,
    the images gathered on the device."""
    import numpy as np

    from repro_torch.data.pipeline import FederatedBatcher

    batcher = FederatedBatcher({"idx": np.arange(prob.y.shape[0])}, prob.parts, prob.pc.batch_size, seed=seed)
    k1, k2 = prob.cfg.kappa1, prob.cfg.kappa2
    while True:
        idx = torch.from_numpy(batcher.next_batches(k1 * k2)["idx"]).to(prob.device)
        idx = idx.reshape(k2, k1, *idx.shape[1:])
        yield {"inputs": prob.x[idx], "targets": prob.y[idx]}


def paper_state(torch, prob):
    from repro_torch.core import hierfavg as th

    return th.init_state(torch.Generator(device=prob.device).manual_seed(0),
                         {k: v.to(prob.device) for k, v in prob.params.items()}, prob.opt, prob.topo, prob.cfg)


def synced_model(state):
    """Client 0's rows: after a cloud sync every client holds the cloud model."""
    return {k: v[0].clone() for k, v in state.params.items()}


def paper_held_out(torch, prob, params):
    """The cloud model's mean loss and accuracy on the held-out images, in
    chunks of 1000."""
    from repro_torch.models import cnn

    loss, hits, count = 0.0, 0, prob.y_held.shape[0]
    with torch.no_grad():
        for i in range(0, count, 1000):
            logits, y = prob.apply(params, prob.x_held[i:i + 1000]), prob.y_held[i:i + 1000]
            loss += float(cnn.classification_loss(logits, y)) * y.shape[0]
            hits += int((torch.argmax(logits, -1) == y).sum())
    return {"loss": loss / count, "accuracy": hits / count}


def paper_cut_vs_cpu(torch, mods, dataset):
    """One cloud interval of ``PAPER_CUT`` on the card and on the CPU from
    the same init and batches: K1 once per leaf per level mean on the card,
    the kernels' plain versions on the CPU; losses and grad norms within
    PAPER_LOSS_RTOL, params within PAPER_PARAMS_TOL. Returns the report and
    both runs (problem, start and end cloud models) for the divergence
    check."""
    from repro_torch.tree import leaves

    runs = {}
    for device in ("cuda", "cpu"):
        prob = paper_problem(torch, dataset, device, **PAPER_CUT)
        state = paper_state(torch, prob)
        block = next(paper_blocks(torch, prob))
        for m in mods:
            m.reset_launch_counts()
        state, metrics = prob.super_round(state, block)
        launches = {k: v for m in mods for k, v in m.LAUNCHES.items()}
        runs[device] = (prob, state, {k: v.tolist() for k, v in metrics.items()}, launches)
    (card, cstate, cm, launches), (_, pstate, pm, cpu_launches) = runs["cuda"], runs["cpu"]
    n_leaves = len(list(leaves(cstate.params)))
    check_launches(launches, {"grouped_mean": 3 * n_leaves}, f"paper_{dataset} cut")  # an edge sync + 2 cloud stages
    check(not any(cpu_launches.values()), f"paper_{dataset} cut on the CPU launched {cpu_launches}")
    # a client of one class can drive its loss to exactly 0 (the cross
    # entropy underflows); where the CPU's is 0 the card's is held to 1e-6
    rel = {k: max((abs(a - b) / abs(b) for a, b in zip(cm[k], pm[k]) if b != 0), default=0.0)
           for k in ("loss", "grad_norm")}
    at_zero = max((abs(a) for k in ("loss", "grad_norm") for a, b in zip(cm[k], pm[k]) if b == 0), default=0.0)
    check(max(rel.values()) <= PAPER_LOSS_RTOL and at_zero <= 1e-6,
          f"paper_{dataset} cut: card vs CPU {rel}, {at_zero} where the CPU's is 0")
    excess, worst = -1.0, 0.0
    for a, b in zip(leaves(cstate.params), leaves(pstate.params)):
        diff = (a.cpu() - b).abs()
        worst = max(worst, float(diff.max()))
        excess = max(excess, float((diff - PAPER_PARAMS_TOL["atol"] - PAPER_PARAMS_TOL["rtol"] * b.abs()).max()))
    check(excess <= 0, f"paper_{dataset} cut: params {worst} apart")
    report = {"clients": card.topo.num_clients, "edges": card.topo.num_edges,
              "kappas": [card.cfg.kappa1, card.cfg.kappa2], "images_per_client": PAPER_CUT["per_client"],
              "losses": cm["loss"], "loss_rel_err": rel["loss"], "grad_norm_rel_err": rel["grad_norm"],
              "max_where_cpu_zero": at_zero,
              "params_max_abs_err": worst, "launches": launches,
              "tolerance": {"loss_rtol": PAPER_LOSS_RTOL, "params": PAPER_PARAMS_TOL}}
    return report, (card, runs["cpu"][0], synced_model(cstate))


def conv_calls_per_local_step(torch, prob, state, block):
    """The host's convolution calls in one local step of every client
    (``hierfavg._client_grads``, grad of the vmapped loss), from a trace of
    host ops: under ``vmap`` each layer's convolution over the N clients'
    weights must be one grouped call, forward and backward, not a loop over
    the clients. Checked: ``aten::_convolution`` (the dispatch to cuDNN or
    a depthwise kernel) once per layer, ``aten::convolution_backward`` at
    most three times per layer (vmap's rule takes the input's, the
    weight's and the bias's gradients apart); a loop would multiply both by
    the clients."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import hierfavg

    grads = hierfavg._client_grads(prob.loss_fn, None)
    step = {k: v[0, 0] for k, v in block.items()}
    grads(state.params, step, None)  # warm
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        grads(state.params, step, None)
        torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    counts = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cpu and e.name() in ("aten::_convolution", "aten::cudnn_convolution",
                                                   "aten::convolution_backward"):
            counts[e.name()] = counts.get(e.name(), 0) + 1
    layers = sum(1 for v in prob.params.values() if v.dim() == 4)
    check(counts.get("aten::_convolution") == layers and 0 < counts.get("aten::convolution_backward", 0) <= 3 * layers,
          f"paper_{prob.dataset}: {counts} host convolution calls in a local step of {prob.topo.num_clients} "
          f"clients over {layers} convolution layers")
    return {**counts, "conv_layers": layers, "clients": prob.topo.num_clients,
            "device_records": len(device_events(torch, prof))}


def paper_train(torch, mods, dataset):
    """The paper's CNN at full width over 50 clients on 5 edges: its cloud
    intervals (the first call, then warm), K1 counted per interval, the
    peak, the loss, one more interval under the profiler. Returns the
    report and (problem, cloud models at the start and after each
    interval)."""
    import math

    from repro_torch.models import cnn
    from repro_torch.tree import leaves

    torch.cuda.empty_cache()
    base = reset_peak(torch)
    t0 = time.perf_counter()
    prob = paper_problem(torch, dataset, "cuda", held_out=PAPER_HELD_OUT)
    state = paper_state(torch, prob)
    setup_s = time.perf_counter() - t0
    blocks = paper_blocks(torch, prob)
    n, n_leaves = prob.topo.num_clients, len(list(leaves(state.params)))
    k1, k2 = prob.cfg.kappa1, prob.cfg.kappa2
    # K1 once per leaf per level mean: kappa2 - 1 edge syncs and the cloud
    # sync's two stages an interval
    want = {"grouped_mean": n_leaves * (k2 - 1 + 2)}
    probes, walls, losses, grad_norms = [synced_model(state)], [], [], []
    for _ in range(PAPER_INTERVALS[dataset]):
        torch.cuda.synchronize()
        for m in mods:
            m.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = prob.super_round(state, next(blocks))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check_launches({k: v for m in mods for k, v in m.LAUNCHES.items()}, want, f"paper_{dataset} interval")
        losses += metrics["loss"].tolist()
        grad_norms += metrics["grad_norm"].tolist()
        probes.append(synced_model(state))
    peak = torch.cuda.max_memory_allocated() - base
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], f"paper_{dataset} losses {losses}")
    check(all(bool(torch.isfinite(x).all()) for x in leaves(state.params)), f"paper_{dataset} params not finite")
    for k, v in state.params.items():
        check(tuple(v.shape) == (n,) + tuple(prob.params[k].shape), f"paper_{dataset} {k} shape {tuple(v.shape)}")
    block = next(blocks)
    convs = conv_calls_per_local_step(torch, prob, state, block)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    profile = profile_call(torch, lambda: prob.super_round(state, block))
    profile["seconds_with_the_trace_read"] = time.perf_counter() - t0
    del state, block
    warm = walls[-1] if len(walls) > 1 else None
    # printed, not held: at this depth the cloud model does not learn (PERF.md)
    held = [{"probe": "w0" if i == 0 else f"after cloud interval {i}", **paper_held_out(torch, prob, p)}
            for i, p in enumerate(probes)]
    check(all(math.isfinite(h["loss"]) for h in held), f"paper_{dataset} held-out losses {held}")
    report = {
        "dataset": dataset, "clients": n, "edges": prob.topo.num_edges, "kappas": [k1, k2], "setup_s": setup_s,
        "batch": prob.pc.batch_size, "lr": prob.pc.lr, "lr_decay_per_epoch": prob.pc.lr_decay,
        "images": int(prob.y.shape[0]), "params_per_client": cnn.count_params(prob.params),
        "state_param_bytes": sum(x.numel() * x.element_size() for x in leaves(prob.params)) * n,
        "leaves": n_leaves, "k1_launches_per_interval": want["grouped_mean"],
        "first_call_wall_s_per_interval": walls[0], "warm_wall_s_per_interval": warm,
        "client_steps_per_s_warm": None if warm is None else n * k1 * k2 / warm,
        "client_steps_per_s_first_call": n * k1 * k2 / walls[0],
        "peak_memory_bytes": peak, "losses_per_edge_interval": losses, "grad_norms": grad_norms,
        "loss_first": losses[0], "loss_last": losses[-1],
        "held_out_images": PAPER_HELD_OUT, "held_out": held,
        "host_conv_calls_per_local_step": convs, "profiled_interval": profile,
    }
    return report, (prob, probes)


def phase_paper(torch, mods, dataset):
    """``paper_train`` then ``paper_cut_vs_cpu``; one line."""
    t0 = time.perf_counter()
    report, runs = paper_train(torch, mods, dataset)
    launches = {"grouped_mean": report["k1_launches_per_interval"] * PAPER_INTERVALS[dataset]}
    t1 = time.perf_counter()
    cut, cut_runs = paper_cut_vs_cpu(torch, mods, dataset)
    cut["seconds"] = time.perf_counter() - t1
    emit({"phase": f"paper_{dataset}", **report, "launches": launches, "cut_vs_cpu": cut,
          "phase_seconds": time.perf_counter() - t0})
    return launches, runs, cut_runs


def phase_divergence_cifar10(torch, runs, cut_runs):
    """Definition 1's divergences of the CIFAR-10 CNN over all 50 clients
    (each client's full 1000 images, one gradient a client) at w0 and after
    each cloud interval of ``paper_cifar10``; beta at w0 from the gradients
    of the mean loss over a fixed sample of BETA_SAMPLE images; Theorem 1,
    the deviation bound G_c and the two guidelines at the paper's kappa
    pairs with the measured delta, Delta and beta; the divergences at the
    cut on the card and on the CPU, within DIVERGENCE_RTOL."""
    import math

    import numpy as np

    from repro_torch.configs import paper
    from repro_torch.core import convergence as cv
    from repro_torch.core import divergence
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    prob, probes = runs

    def client_grads(p):
        grad = torch.func.grad(p.loss_fn)
        idx = [torch.from_numpy(ix).to(p.device) for ix in p.parts]
        return lambda w, i: grad(w, {"inputs": p.x[idx[i]], "targets": p.y[idx[i]]}, None)

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    div = divergence.measure_divergence(client_grads(prob), probes, prob.sizes, prob.topo.num_edges)
    torch.cuda.synchronize()
    div_s = time.perf_counter() - t1
    check(np.isfinite(div["delta_client_edge"]).all() and np.isfinite(div["Delta_edge_cloud"]).all()
          and div["delta"] > 0 and div["Delta"] > 0, f"divergence_cifar10: {div}")

    sample = torch.from_numpy(np.random.default_rng(3).choice(prob.y.shape[0], BETA_SAMPLE, replace=False)).cuda()
    grad = torch.func.grad(prob.loss_fn)

    def mean_loss_grad(w):  # equal chunks: the mean of the chunks' mean-loss gradients
        acc = None
        for c in range(0, BETA_SAMPLE, BETA_CHUNK):
            ix = sample[c:c + BETA_CHUNK]
            g = grad(w, {"inputs": prob.x[ix], "targets": prob.y[ix]}, None)
            acc = g if acc is None else tree_map(torch.add, acc, g)
        return tree_map(lambda a: a / (BETA_SAMPLE // BETA_CHUNK), acc)

    t1 = time.perf_counter()
    beta = divergence.estimate_beta_smoothness(mean_loss_grad, probes[0], torch.Generator(device="cuda").manual_seed(0))
    beta_s = time.perf_counter() - t1
    check(np.isfinite(beta) and beta > 0, f"divergence_cifar10: beta {beta}")

    eta, delta, Delta = prob.pc.lr, div["delta"], div["Delta"]
    steps = prob.cfg.kappa1 * prob.cfg.kappa2 * (len(probes) - 1)
    bounds = [{"kappas": [k1, k2], "G_c_max": cv.G_c_max(k1, k2, delta, Delta, eta, beta),
               "G_nc": cv.G_nc(k1, k2, delta, Delta, eta, beta),
               "theorem1_bound": cv.theorem1_bound(steps, k1, k2, delta, Delta, eta, beta, **THEOREM1_CONSTANTS)}
              for k1, k2 in paper.CIFAR_KAPPAS]
    product = prob.cfg.kappa1 * prob.cfg.kappa2
    guide1 = [list(r) for r in cv.guideline_smaller_kappa1(product, delta, Delta, eta, beta)]
    guide2 = [list(r) for r in cv.guideline_edge_iid_kappa2_free(prob.cfg.kappa1, delta, eta, beta, (1, 2, 5, 10))]
    values = [b[k] for b in bounds for k in ("G_c_max", "G_nc", "theorem1_bound")] + [r[-1] for r in guide1 + guide2]
    check(not any(math.isnan(v) for v in values), f"divergence_cifar10: NaN among {bounds}, {guide1}, {guide2}")

    # the same function on the CPU at the cut: w0 and the card's end model
    card, cpu, end = cut_runs
    cut = {}
    for name, p in (("cuda", card), ("cpu", cpu)):
        points = [{k: v.to(p.device) for k, v in w.items()} for w in (card.params, end)]
        cut[name] = divergence.measure_divergence(client_grads(p), points, p.sizes, p.topo.num_edges)
    rel = {k: float(np.max(np.abs(cut["cuda"][k] - cut["cpu"][k]) / np.maximum(np.abs(cut["cpu"][k]), 1e-30)))
           for k in ("delta_client_edge", "Delta_edge_cloud")}
    check(max(rel.values()) <= DIVERGENCE_RTOL, f"divergence_cifar10 cut: card vs CPU {rel}")
    del probes
    emit({"phase": "divergence_cifar10", "clients": prob.topo.num_clients, "edges": prob.topo.num_edges,
          "probes": ["w0"] + [f"after cloud interval {i + 1}" for i in range(PAPER_INTERVALS["cifar10"])],
          "delta": delta, "Delta": Delta, "delta_client_edge": div["delta_client_edge"].tolist(),
          "Delta_edge_cloud": div["Delta_edge_cloud"].tolist(), "divergence_seconds": div_s,
          "beta": beta, "beta_seconds": beta_s,
          "beta_gradients": f"mean loss over a fixed sample of {BETA_SAMPLE} of the {prob.y.shape[0]} images "
                            f"(chunks of {BETA_CHUNK}), 8 probes of radius 1e-2",
          "eta": eta, "theorem1_steps": steps, "theorem1_constants": THEOREM1_CONSTANTS, "bounds": bounds,
          "guideline_smaller_kappa1": guide1, "guideline_edge_iid_kappa2_free": guide2,
          "cut_vs_cpu": {"delta": [cut["cuda"]["delta"], cut["cpu"]["delta"]],
                         "Delta": [cut["cuda"]["Delta"], cut["cpu"]["Delta"]], "max_rel_err": rel,
                         "tolerance": {"rtol": DIVERGENCE_RTOL}},
          "phase_seconds": time.perf_counter() - t0})


def phase_roofline_calibration(torch, mods):
    """The card's peaks measured (``analysis.roofline.measure_host_peaks``
    at PEAK_N) beside the data sheet's; K3 (``path="kernel"``) and its
    plain version (``path="ref"``) calibrated against them at the JAX
    package's default shape and at K3's full-width case with momentum,
    every fraction in (0, 1.05]; lm-100m's model FLOPs for a train step of
    ``lm_edge_niid`` and the share of the measured f32 peak that
    ``train_lm100m``'s warm interval reached (printed, not held)."""
    from repro_torch.analysis import roofline
    from repro_torch.configs.base import ShapeSpec, param_count
    from repro_torch.fed import api, scenarios

    t0 = time.perf_counter()
    peaks = roofline.measure_host_peaks(device="cuda", n=PEAK_N, reps=5)
    sheet = {"flops_f32": roofline.PEAK_FLOPS, "bw": roofline.HBM_BW}
    check(0 < peaks["flops"] <= 1.05 * sheet["flops_f32"] and 0 < peaks["bw"] <= 1.05 * sheet["bw"],
          f"roofline_calibration: peaks {peaks} beyond the data sheet's {sheet}")
    shapes = {"jax_default": {}, "k3_full_width": dict(num_edges=K3_FULL["e"],
                                                      clients_per_edge=K3_FULL["n"] // K3_FULL["e"],
                                                      kappa1=K3_FULL["k1"], batch=K3_FULL["b"],
                                                      feat=K3_FULL["feat"], out=K3_FULL["out"], momentum=0.9)}
    reps = 5
    for m in mods:
        m.reset_launch_counts()
    rows = []
    for label, kw in shapes.items():
        for path in ("kernel", "ref"):
            res = roofline.calibrate_megakernel(path=path, peaks=peaks, device="cuda", reps=reps, **kw)
            d = res.to_dict()
            check(0 < d["flops_fraction"] <= 1.05 and 0 < d["bw_fraction"] <= 1.05,
                  f"roofline_calibration {label} {path}: fractions {d}")
            rows.append({"shape": label, "path": path, **d})
    launches = {k: v for m in mods for k, v in m.LAUNCHES.items()}
    check_launches(launches, {"edge_interval": len(shapes) * (1 + reps)}, "roofline_calibration")
    spec = scenarios.get("lm_edge_niid", overrides=LM100M)
    cfg = api._lm_config(spec)  # lm-100m at the scenario's vocabulary of 512, as train_lm100m trains it
    check(param_count(cfg) == 76_303_104, f"roofline_calibration: lm-100m at {param_count(cfg)} parameters")
    n = spec.topology.num_edges * spec.topology.clients_per_edge
    step = ShapeSpec("lm_edge_niid_step", spec.data.seq_len, n * spec.data.batch_size, "train")
    flops_step = roofline.model_flops(cfg, step)
    wall_ms = REFS.get("lm100m_warm_wall_ms_per_interval")
    steps_per_interval = spec.schedule.kappas[0] * spec.schedule.kappas[1]
    share = None if wall_ms is None else flops_step * steps_per_interval / (wall_ms / 1e3) / peaks["flops"]
    emit({"phase": "roofline_calibration", "measured_peaks": peaks, "matmul_n": PEAK_N,
          "add_bytes": 2 * 8 * PEAK_N ** 2 * 4, "data_sheet": sheet,
          "measured_share_of_data_sheet": {"flops": peaks["flops"] / sheet["flops_f32"], "bw": peaks["bw"] / sheet["bw"]},
          "calibrations": rows, "launches": launches,
          "lm100m": {"params": param_count(cfg), "vocab": cfg.vocab_size,
                     "model_flops_per_local_step": flops_step, "tokens_per_local_step": step.global_batch * step.seq_len,
                     "local_steps_per_interval": steps_per_interval, "warm_wall_ms_per_interval": wall_ms,
                     "share_of_measured_f32_peak": share, "held": False},
          "phase_seconds": time.perf_counter() - t0})
    return launches


# the paper's figure and table scripts (``repro_torch.experiments``) at
# their own sizes, and the examples (``repro_torch.examples``)
PAPER_SCRIPTS = ("table1_cost_model", "fig4_convergence", "table2_latency_energy", "fig2_topologies",
                 "aggregation_scaling", "compression_tradeoff", "round_time_sim", "wallclock_curves")
# one Fig. 4 schedule, cut to one cloud interval, on the card and on the CPU
FIG4_CUT = dict(partitions=("edge_niid",), schedules=((6, 10),), rounds=10)
# train_hier_lm at lm-100m's full width (8 clients on 2 edges, Adam)
HIER_LM_ARGS = ["--preset", "100m", "--rounds", "8"]
TABLE2_ROW = r"^table2([abc])_(?:(\w+?)_)?k1=(\d+)_k2=(\d+),steps=(\d+),T=([\d.]+)s,E=([\d.]+)J$"


def sync_level(kappas, r: int) -> int:
    """The level of the sync that ends round ``r`` (0-based): 1, the edge,
    unless r + 1 is a multiple of kappa2 (then 2, and so on up the tree)."""
    level, every = 1, 1
    for k in kappas[1:]:
        every *= k
        if (r + 1) % every:
            break
        level += 1
    return level


def stand_in_launches(runner) -> dict:
    """What a classifier run must launch: at the end of each round the sync
    that is due, whose level L runs the stages of levels 1..L
    (``aggregation.level_stages``), each K1 once a leaf where its groups
    are equal blocks and K2 once a leaf where they are ragged; K4 and K5
    once a leaf at a sync whose level's codec compresses; nothing else."""
    from repro_torch.core.aggregation import level_stages
    from repro_torch.core.hierarchy import as_hierarchy
    from repro_torch.tree import leaves

    hier = runner.hier_config
    kappas = hier.kappas or (hier.kappa1, hier.kappa2)
    tree = as_hierarchy(runner.topology)
    n_leaves = len(list(leaves(runner.spec.init_params(0, "cpu"))))
    want = dict.fromkeys(("grouped_mean", "segment_mean", "quantize", "dequantize"), 0)
    for r in range(len(runner.history)):
        level = sync_level(kappas, r)
        for st in level_stages(tree, level):
            want["grouped_mean" if st.uniform else "segment_mean"] += n_leaves
        if hier.transport is not None and not hier.transport.codec(level).is_identity:
            want["quantize"] += n_leaves
            want["dequantize"] += n_leaves
    return {k: v for k, v in want.items() if v}


def scripted(torch, mods, fn):
    """``fn()`` with every launch count set to 0 just before and read just
    after, its printed rows captured and the runs it made recorded
    (``experiments.common.recorded_runs``): (its result, the rows, seconds
    to a synchronise, launches, the runners)."""
    import io

    from repro_torch.experiments import common

    torch.cuda.synchronize()
    for m in mods:
        m.reset_launch_counts()
    text = io.StringIO()
    with common.recorded_runs() as runs, contextlib.redirect_stdout(text):
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return result, text.getvalue().splitlines(), seconds, {k: v for m in mods for k, v in m.LAUNCHES.items()}, runs


def runs_report(name, runs, seconds, launches, rows, extra=None):
    """A script's line: its wall, its runs' client steps a second (host
    time: the stand-in's steps are far too small to keep the card busy),
    the launches against ``stand_in_launches`` (checked), its rows."""
    import math

    want = {}
    for r in runs:
        for k, v in stand_in_launches(r).items():
            want[k] = want.get(k, 0) + v
        check(all(math.isfinite(h.loss) for h in r.history), f"{name}: a loss is not finite")
    check_launches(launches, want, name)
    steps = sum(resident_clients(r) * len(r.history) * r.hier_config.kappa1 for r in runs)
    out = {"phase": name, "seconds": seconds, "runs": len(runs), "client_steps": steps,
           "client_steps_per_s": steps / seconds if steps else None, "launches": launches, "launches_want": want}
    out.update(extra or {})
    out["rows"] = rows
    emit(out)
    return launches


def table2_claims(rows):
    """Table II's claims on the printed rows: within each sweep (IIa per
    partition, IIc, IIb) ordered by kappa2, T_alpha falls and E_alpha is
    U-shaped (its smallest value inside the sweep); the kappa pairs that
    reached alpha."""
    import re

    sweeps = {}
    for line in rows:
        m = re.match(TABLE2_ROW, line)
        if m:
            sec, part, k1, k2, steps, t, e = m.groups()
            sweeps.setdefault(f"II{sec}" + (f"_{part}" if part else ""), []).append(
                (int(k2), int(k1), int(steps), float(t), float(e)))
    out = {}
    for name, pts in sweeps.items():
        pts.sort()
        ts, es = [p[3] for p in pts], [p[4] for p in pts]
        low = es.index(min(es))
        out[name] = {"reached": [[p[1], p[0]] for p in pts], "T": ts, "E": es,
                     "T_falls_with_kappa2": all(b <= a for a, b in zip(ts, ts[1:])),
                     "E_u_shaped": 0 < low < len(es) - 1}
    return out


def phase_paper_figures(torch, mods):
    """The eight scripts at their own sizes on the card, one line each
    (``paper_figures/<name>``): rows, wall, launches as counted, the
    paper's claims; round_time_sim's and wallclock_curves' gates; one Fig. 4
    schedule cut to one cloud interval, card against the CPU."""
    import importlib

    from repro_torch.experiments import common

    mod = {n: importlib.import_module(f"repro_torch.experiments.{n}") for n in PAPER_SCRIPTS}
    total = {}

    def count(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    from repro_torch.core import cost_model

    result, rows, secs, launches, runs = scripted(torch, mods, lambda: mod["table1_cost_model"].main(device="cuda"))
    check(result == [(n, w.t_comp, w.t_comm_edge, w.e_comp, w.e_comm_edge) for n, w in (
        (n, cost_model.paper_workload(n)) for n in ("mnist", "cifar10"))], f"table1 rows {result}")
    count(runs_report("paper_figures/table1_cost_model", runs, secs, launches, rows))

    out, rows, secs, launches, runs = scripted(torch, mods, lambda: mod["fig4_convergence"].main(device="cuda"))
    check(len(runs) == 8 and all(r.history[-1].step == 240 for r in runs), "fig4: 8 runs of 240 local steps")
    guideline = {d: out[(d, 6, 10)][1][-1] >= out[(d, 60, 1)][1][-1] - 0.02 for d in ("edge_iid", "edge_niid")}
    count(runs_report("paper_figures/fig4_convergence", runs, secs, launches, rows, {
        "final_accuracy": {f"{d}_k1={a}_k2={b}": acc[-1] for (d, a, b), (_, acc) in out.items()},
        "guideline1_holds": guideline}))

    # the cut against the CPU, from one init
    init = lambda spec: spec.init_params(spec.run.seed + 1, "cpu")  # noqa: E731
    _, _, card_secs, launches, (card,) = scripted(
        torch, mods, lambda: mod["fig4_convergence"].main(device="cuda", init=init, **FIG4_CUT))
    check_launches(launches, stand_in_launches(card), "paper_figures/fig4_cut")
    with common.recorded_runs() as cpu_runs, contextlib.redirect_stdout(None):
        mod["fig4_convergence"].main(device="cpu", init=init, **FIG4_CUT)
    agreement = history_agreement(card, cpu_runs[0], "fig4 cut cuda vs cpu", "cpu")
    count(launches)
    emit({"phase": "paper_figures/fig4_cut", "schedule": FIG4_CUT, "seconds": card_secs, "launches": launches,
          **agreement, "losses": [h.loss for h in card.history],
          "accuracy": [h.accuracy for h in card.history]})

    rows_out, rows, secs, launches, runs = scripted(
        torch, mods, lambda: mod["table2_latency_energy"].main(sim=True, device="cuda"))
    check(len(runs) == 15, f"table2: {len(runs)} runs, want 8 + 3 + 4")
    check(sum(ln.startswith("table2sim_") for ln in rows) == sum(r[0] in ("edge_iid", "edge_niid") for r in rows_out),
          "table2: one --sim row per IIa point reached")
    count(runs_report("paper_figures/table2_latency_energy", runs, secs, launches, rows,
                      {"claims": table2_claims(rows)}))

    fig2, rows, secs, launches, runs = scripted(torch, mods, lambda: mod["fig2_topologies"].main(device="cuda"))
    claims = {"hier_acc_ge_edge": fig2["hier"][0] >= fig2["edge_only"][0] - 0.01,
              "hier_T_le_cloud": fig2["hier"][1] <= fig2["cloud"][1]}
    count(runs_report("paper_figures/fig2_topologies", runs, secs, launches, rows, {
        "best_accuracy": {k: v[0] for k, v in fig2.items()}, "T_alpha_s": {k: v[1] for k, v in fig2.items()},
        "fig2_claims": claims}))

    agg, rows, secs, launches, runs = scripted(torch, mods, lambda: mod["aggregation_scaling"].main([], device="cuda"))
    check(len(agg["rows"]) == 30 and abs(agg["cloud_traffic_reduction"] - 64) < 1e-9, "aggregation_scaling rows")
    count(runs_report("paper_figures/aggregation_scaling", runs, secs, launches, rows))

    _, rows, secs, launches, runs = scripted(torch, mods, lambda: mod["compression_tradeoff"].main(device="cuda"))
    check(len(runs) == 9 and launches["quantize"] > 0, "compression_tradeoff: 9 runs, K4 on the int8 ones")
    count(runs_report("paper_figures/compression_tradeoff", runs, secs, launches, rows))

    sim, rows, secs, launches, runs = scripted(torch, mods, lambda: mod["round_time_sim"].main(device="cuda"))
    gates = mod["round_time_sim"].check_gates(sim)
    check(not gates, f"round_time_sim gates: {gates}")
    count(runs_report("paper_figures/round_time_sim", runs, secs, launches, rows, {"gates": "passed"}))

    section, rows, secs, launches, runs = scripted(
        torch, mods, lambda: mod["wallclock_curves"].main([], device="cuda"))
    gates = mod["wallclock_curves"].check_gates(section)
    check(not gates, f"wallclock_curves gates: {gates}")
    check(all(type(r._engine).__name__ == "DeadlineEngine" for r in runs), "wallclock_curves: the deadline engine")
    count(runs_report("paper_figures/wallclock_curves", runs, secs, launches, rows, {
        "gates": "passed", "gated_intervals": [r._engine.gated_intervals for r in runs],
        "time_to_target_s": {k: v["time_to_target_s"] for k, v in section["variants"].items()}}))
    return total


def phase_examples(torch, mods, fa):
    """The four examples on the card: quickstart, compare_topologies'
    default sweep (K2 on the ragged trees), serve_lm (K7 once a layer a
    prefill; K7 at its shape against the plain version; the prefill
    against the CPU's) and train_hier_lm at lm-100m's full width."""
    import math
    import shutil

    import numpy as np
    from torch.utils._pytree import tree_map

    from repro_torch.examples import compare_topologies, quickstart, serve_lm, train_hier_lm
    from repro_torch.models import transformer

    total = {}

    def count(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    runner, rows, secs, launches, runs = scripted(torch, mods, lambda: quickstart.main(["--device", "cuda"]))
    check(runs == [runner] and launches["grouped_mean"] == 144, f"examples/quickstart K1 {launches}")
    count(runs_report("examples/quickstart", runs, secs, launches, rows,
                      {"final_accuracy": runner.history[-1].accuracy}))

    found, rows, secs, launches, runs = scripted(torch, mods, lambda: compare_topologies.main(["--device", "cuda"]))
    check(len(runs) == 6 and launches["segment_mean"] > 0, f"examples/compare_topologies K2 {launches}")
    count(runs_report("examples/compare_topologies", runs, secs, launches, rows, {
        "best_accuracy": {k: max(h.accuracy for h in r.history if h.accuracy is not None) for k, r in found.items()},
        "segment_mean_by_tree": {k: stand_in_launches(r).get("segment_mean", 0) for k, r in found.items()}}))

    out, rows, secs, launches, _ = scripted(torch, mods, lambda: serve_lm.main(["--device", "cuda"]))
    cfg = serve_lm.serve_config()
    check_launches(launches, {"flash_attention": cfg.num_layers}, "examples/serve_lm")
    B, P = out["prompts"].shape
    check(tuple(out["tokens"].shape) == (B, 24) and bool(torch.isfinite(out["prefill_logits"]).all()),
          "examples/serve_lm: tokens or logits")
    with torch.inference_mode():
        params = transformer.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    with contextlib.redirect_stdout(None):
        cpu = serve_lm.main(["--device", "cpu"], params=cpu_params)
    err, scale = max_err(out["prefill_logits"], cpu["prefill_logits"])
    check(err <= K_F32 * scale, f"examples/serve_lm: card vs CPU logits err {err} (scale {scale})")
    check(torch.equal(out["tokens"][:, 0].cpu(), cpu["tokens"][:, 0]), "examples/serve_lm: first greedy token")
    # K7 at the prefill's shape against its plain version
    rng = np.random.default_rng(7)
    hd = cfg.resolved_head_dim
    q, k, v = (torch.from_numpy(rng.normal(size=(B, P, n, hd)).astype(np.float32)).cuda()
               for n in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))
    got, again = fa.attention(q, k, v, causal=True), fa.attention(q, k, v, causal=True)
    k7_err = float((got - fa.attention_plain(q, k, v, causal=True)).abs().max())
    check(bit_equal(got, again) and k7_err <= K7_ATOL, f"examples/serve_lm: K7 at {tuple(q.shape)} err {k7_err}")
    count(launches)
    emit({"phase": "examples/serve_lm", "seconds": secs, "launches": launches,
          "launches_per_prefill": {"flash_attention": cfg.num_layers}, "prefill_s": out["prefill_s"],
          "decode_s": out["decode_s"], "decode_tokens_per_s": B * 23 / out["decode_s"],
          "card_vs_cpu": {"max_abs_err": err, "max_abs_logit": scale, "tolerance": f"{K_F32} x max |logit|"},
          "k7_at_prefill_shape": {"q": list(q.shape), "k": list(k.shape), "max_abs_err": k7_err, "atol": K7_ATOL,
                                  "bit_equal_relaunch": True},
          "sample_ids": out["tokens"][:2, :12].tolist(), "rows": rows})
    del params, cpu_params, q, k, v, got, again

    ckpt = CKPT_DIR / "hier_lm"
    base = reset_peak(torch)
    try:
        (runner, state), rows, secs, launches, runs = scripted(
            torch, mods, lambda: train_hier_lm.main(HIER_LM_ARGS + ["--ckpt-dir", str(ckpt), "--device", "cuda"]))
        peak = torch.cuda.max_memory_allocated() - base
        check(runner.spec.model.arch == "lm-100m" and runs == [runner], "examples/train_hier_lm: lm-100m")
        check_launches(launches, lm_launches(runner, state, 0), "examples/train_hier_lm")
        losses = [h.loss for h in runner.history]
        check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], f"train_hier_lm losses {losses}")
        saved = sorted(p.name for p in ckpt.iterdir())
        check(bool(saved), "examples/train_hier_lm: no checkpoint written")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    count(launches)
    steps = resident_clients(runner) * len(runner.history) * runner.hier_config.kappa1
    emit({"phase": "examples/train_hier_lm", "args": HIER_LM_ARGS, "seconds": secs, "client_steps": steps,
          "client_steps_per_s": steps / secs, "launches": launches, "losses": losses, "checkpoints": saved,
          "peak_memory_bytes": peak, "rows": rows})
    del runner, state
    return total


# the dry run's phase: lm-100m's single-device prefill (4 x 1024, f32: K7)
# and train cell (the 128 x 64 cut, its second call: the local step and the
# edge sync's K1) counted by ``analysis.opcount`` on the card and again on
# meta tensors (the dry run's): FLOPs, bytes, kernel charges and collective
# records equal; the counted peak of live storages within DRYRUN_PEAK_RTOL of
# the card's ``max_memory_allocated`` over the call
DRYRUN_PREFILL = ("prefill", 1024, 4, "prefill")
DRYRUN_PEAK_RTOL = 0.15
# the yi-9b dry run and the report in subprocesses: over this wall the phase
# fails (24.2-25.6 s beside the 2-rank world on H100 hosts; on one of them
# the same run took 41.3-42.9 s alone while the report imported torch and a
# spawned process counted the train cell, 75.4 s once on a slower host)
DRYRUN_WALL_LIMIT_S = 60.0


def counted_record(summary) -> dict:
    """What two counts of one call must share: FLOPs, HBM bytes, the
    kernels' charges and the collectives (opcode, payload bytes, group
    size, mesh axes, f32-for-bf16), with the memory and ops beside."""
    return {"flops": summary.flops, "hbm_bytes": summary.hbm_bytes,
            "kernels": {k: list(v) for k, v in sorted(summary.kernels.items())},
            "collectives": sorted(list(c.key()) for c in summary.collectives),
            "memory": summary.memory, "ops": summary.ops}


def same_counts(a: dict, b: dict) -> bool:
    return all(a[k] == b[k] for k in ("flops", "hbm_bytes", "kernels", "collectives"))


def counted_call(torch, fn, args, device):
    """(the call's output, its ``counted_record``, the peak the card's
    allocator added over the call) of ``fn(*args)`` on the card."""
    from repro_torch.analysis import opcount

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, summary = opcount.count(fn, *args, device=device)
    torch.cuda.synchronize()
    return out, counted_record(summary), torch.cuda.max_memory_allocated() - before


def roofline_against_time(cfg, shape, rec, ms):
    """The counted terms (``analysis.roofline``) beside a measured time:
    the bound over the time (the share of the roofline reached)."""
    import types

    from repro_torch.analysis import roofline as rl

    counts = types.SimpleNamespace(flops=rec["flops"], hbm_bytes=rec["hbm_bytes"],
                                   collective_bytes_per_device=lambda: 0.0, collective_breakdown=lambda: {})
    t = rl.from_summary(f"{cfg.name}/{shape.name}", counts, 1, model_flops_global=rl.model_flops(cfg, shape))
    return {"compute_ms": t.compute_s * 1e3, "memory_ms": t.memory_s * 1e3, "dominant": t.dominant,
            "bound_ms": t.bound_s * 1e3, "measured_ms": ms, "roofline_fraction_of_time": t.bound_s * 1e3 / ms,
            "roofline_fraction": t.roofline_fraction, "useful_flops_ratio": t.useful_flops_ratio}


def dryrun_prefill(torch, mods):
    """(a) lm-100m's single-device prefill, counted on the card and on meta
    tensors; timed warm by CUDA events."""
    from repro_torch.analysis import opcount
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun, serve, steps
    from repro_torch.models import transformer

    cfg, shape = get_config("lm-100m"), ShapeSpec(*DRYRUN_PREFILL)
    cell = steps.build_prefill_cell(cfg, shape, None)
    with torch.no_grad():
        params = transformer.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
        x = torch.from_numpy(serve.make_prompts(cfg, shape.global_batch, shape.seq_len, seed=1)).cuda()
        cell.fn(params, x)  # warm
        for m in mods:
            m.reset_launch_counts()
        _, real, card_peak = counted_call(torch, cell.fn, (params, x), "cuda")
        launches = {k: v for m in mods for k, v in m.LAUNCHES.items()}
        _, fake = opcount.count(cell.fn, *dryrun.rank_args(cell, None, cfg, dryrun.FAKE_DEVICE),
                                device=dryrun.FAKE_DEVICE)
        fake = counted_record(fake)
        ms = time_ms(lambda: cell.fn(params, x), flush=flush_buffer(torch), reps=5, warmup=1)
    del params, x
    torch.cuda.empty_cache()
    return cfg, shape, real, fake, card_peak, launches, ms


def dryrun_train_cell(torch, mods):
    """(a) lm-100m's single-device train cell at the 128 x 64 cut: its
    second call (the local step and the edge sync) counted on the card and
    on meta tensors (step count 1); its third (a local step) timed and
    counted on meta tensors."""
    from repro_torch.analysis import opcount
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun, steps

    cfg, shape = train_cell_config(), ShapeSpec(*TRAIN_CUT)
    torch.cuda.empty_cache()
    cell = steps.build_train_cell(cfg, shape, None, lr=1e-3, device="cuda")
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()} for b in cell_batches(cfg, cell, 3)]
    params = steps.transformer.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    state = steps.init_train_state(cfg, None, params, torch.Generator(device="cuda").manual_seed(0))
    state, _ = steps.shard_args(cell, (state, None), None, "cuda")
    del params
    torch.cuda.empty_cache()
    state, _ = cell.fn(state, batches[0])
    for m in mods:
        m.reset_launch_counts()
    (state, _), real, card_peak = counted_call(torch, cell.fn, (state, batches[1]), "cuda")
    launches = {k: v for m in mods for k, v in m.LAUNCHES.items()}

    def fake_call(step):
        args = dryrun.rank_args(cell, None, cfg, dryrun.FAKE_DEVICE)
        opcount.hold_value(args[0].step, step)
        return counted_record(opcount.count(cell.fn, *args, device=dryrun.FAKE_DEVICE)[1])

    fake, fake_local = fake_call(1), fake_call(2)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    state, _ = cell.fn(state, batches[2])
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    del state, batches
    torch.cuda.empty_cache()
    return cfg, shape, real, fake, fake_local, card_peak, launches, ms


def dryrun_tp_prefill(torch):
    """(b) a fake (1, 2) world presented as gloo, rank 0's count of the
    prefill cell that ``tp_lm100m_m2``'s gloo ranks counted on the card."""
    import torch.distributed as dist

    from repro_torch.analysis import opcount
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch import mesh as lmesh

    check(not dist.is_initialized(), "dryrun: a process group is still up before the fake world")
    cfg = get_config("lm-100m")
    with dryrun.fake_world(2):
        mesh = lmesh.make_host_mesh((1, 2), ("data", "model"), device=dryrun.FAKE_DEVICE, present_as="gloo")
        cell = steps.build_prefill_cell(cfg, ShapeSpec("prefill", TP_PROMPT, TP_BATCH, "prefill"), mesh)
        args = dryrun.rank_args(cell, mesh, cfg, dryrun.FAKE_DEVICE)
        _, summary = opcount.count(cell.fn, *args, mesh=mesh, device=dryrun.FAKE_DEVICE)
    return counted_record(summary)


def dryrun_subprocess():
    """(c) ``launch.dryrun`` for yi-9b on the single-pod mesh (every shape,
    the train cell's phases; a process a cell), then the report, each in a
    subprocess that sees no card (``CUDA_VISIBLE_DEVICES`` empty), started
    now and run by a thread beside the card phases (it needs no card, and
    the 2-rank world leaves the host's cores idle); ``finish()`` waits for
    them and returns (the wall from the start to the report's end, the dry
    run's seconds, the artifacts, the report's rows, the dry run's result
    lines)."""
    import os
    import shutil
    import threading

    out = ROOT / "build" / "dryrun_torch"
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    done = {}

    def run():
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "yi-9b", "--mesh",
                                 "single", "--out", str(out), "--jobs", "3"], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        CHILDREN.append(proc)
        try:
            done["stdout"], done["stderr"] = proc.communicate(timeout=2 * DRYRUN_WALL_LIMIT_S)
        finally:
            proc.kill()
            CHILDREN.remove(proc)
        done["rc"], done["dry_s"] = proc.returncode, time.perf_counter() - t0
        if proc.returncode == 0:
            done["report"] = subprocess.run([sys.executable, "-m", "repro_torch.experiments.roofline_report",
                                             "--out", str(out)], env=env, capture_output=True, text=True,
                                            timeout=120)
        done["wall"] = time.perf_counter() - t0

    thread = threading.Thread(target=run, name="dryrun-yi-9b", daemon=True)
    thread.start()

    def finish():
        thread.join(timeout=2 * DRYRUN_WALL_LIMIT_S + 150)
        check("wall" in done, f"dryrun: the yi-9b dry run did not end: {done}")
        stdout, stderr = done["stdout"], done["stderr"]
        check(done["rc"] == 0, f"dryrun: the yi-9b dry run exited {done['rc']}: {stdout[-2000:]} {stderr[-2000:]}")
        rep = done["report"]
        check(rep.returncode == 0, f"dryrun: the report exited {rep.returncode}: {rep.stderr[-2000:]}")
        arts = {p.stem: json.loads(p.read_text()) for p in sorted(out.glob("*.json"))}
        rows = [ln for ln in rep.stdout.splitlines() if ln.startswith(("roofline,", "multipod,", "refused,"))]
        lines = [ln for ln in stdout.splitlines() if ln.startswith(("  OK", "dry run"))]
        return done["wall"], done["dry_s"], arts, rows, lines

    return finish


def phase_dryrun(torch, mods, yi9b):
    """The dry run's counter against the card. (a) lm-100m's prefill and
    train cell counted on real CUDA tensors and on meta tensors: equal
    FLOPs, bytes, kernel charges and collectives; the counted peak within
    DRYRUN_PEAK_RTOL of the card's; the counted roofline against a CUDA-event
    time. (b) ``tp_lm100m_m2``'s prefill as the 2-rank gloo world counted it
    against a fake (1, 2) world presented as gloo. (c) the yi-9b dry run and
    the report (``yi9b``: ``dryrun_subprocess``'s, started beside the 2-rank
    world), touching no card; over DRYRUN_WALL_LIMIT_S it fails.
    Returns the launches of (a)'s card calls."""
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    cfg, shape, real, fake, peak, launches, ms = dryrun_prefill(torch, mods)
    check(same_counts(real, fake), f"dryrun prefill: card {real} and meta {fake} counts differ")
    check(launches.get("flash_attention", 0) == cfg.num_layers and fake["kernels"]["flash_attention"][0] == 12,
          f"dryrun prefill: K7 launches {launches}, charges {fake['kernels']}")
    temp = fake["memory"]["temp_size_in_bytes"]
    check(abs(temp - peak) <= DRYRUN_PEAK_RTOL * peak, f"dryrun prefill: counted peak {temp}, the card's {peak}")
    prefill = {"card": real, "meta": fake, "card_peak_bytes": peak, "peak_rel_err": temp / peak - 1,
               "roofline": roofline_against_time(cfg, shape, fake, ms)}
    tcfg, tshape, treal, tfake, tlocal, tpeak, tlaunches, tms = dryrun_train_cell(torch, mods)
    check(same_counts(treal, tfake), f"dryrun train cell: card {treal} and meta {tfake} counts differ")
    check(tlaunches.get("grouped_mean", 0) == tfake["kernels"].get("grouped_mean", [0])[0] == 12,
          f"dryrun train cell: K1 launches {tlaunches}, charges {tfake['kernels']} (12 leaves, one edge sync)")
    ttemp = tfake["memory"]["temp_size_in_bytes"]
    check(abs(ttemp - tpeak) <= DRYRUN_PEAK_RTOL * tpeak, f"dryrun train cell: counted peak {ttemp}, card's {tpeak}")
    train = {"card": treal, "meta": tfake, "card_peak_bytes": tpeak, "peak_rel_err": ttemp / tpeak - 1,
             "local_step_meta": tlocal, "roofline": roofline_against_time(tcfg, tshape, tlocal, tms)}
    for m in mods:
        m.reset_launch_counts()
    ranks = REFS.get("tp_prefill_counted")
    check(ranks is not None and len(ranks) == 2 and same_counts(ranks[0], ranks[1]),
          f"dryrun tp prefill: the gloo ranks' counts {ranks}")
    fake_tp = dryrun_tp_prefill(torch)
    check(same_counts(ranks[0], fake_tp), f"dryrun tp prefill: gloo rank 0 {ranks[0]} and fake (1, 2) {fake_tp}")
    wall, dry_s, arts, rows, lines = yi9b()
    train_art = arts.get("yi-9b__train_4k__single_pod_16x16", {})
    edge = train_art.get("phases", {}).get("edge_ops", {}).get("coll_counts", {})
    check(len(arts) == 3 and edge == {"all-reduce@data": 1} and len([r for r in rows if r.startswith("roofline,")])
          == 3, f"dryrun yi-9b: artifacts {sorted(arts)}, edge collectives {edge}, rows {rows}")
    check(wall < DRYRUN_WALL_LIMIT_S, f"dryrun yi-9b: {wall:.1f} s, over {DRYRUN_WALL_LIMIT_S} s")
    emit({"phase": "dryrun", "card": smi, "prefill_lm100m_4x1024_f32": prefill,
          "train_cell_lm100m_128x64": train,
          "tp_prefill_lm100m_m2": {"gloo_ranks": ranks, "fake_1x2_as_gloo": fake_tp},
          "yi9b_single_pod": {"wall_s": wall, "limit_s": DRYRUN_WALL_LIMIT_S, "dry_run_s": dry_s, "lines": lines,
                              "report_rows": rows, "train_edge_collectives": edge},
          "seconds": time.perf_counter() - t0})
    return {k: launches.get(k, 0) + tlaunches.get(k, 0) for k in set(launches) | set(tlaunches)}


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
    if sys.argv[1:] == ["--xlstm-train-memory"]:
        _build.build_all(("hier_aggregate",))
        xlstm_train_memory(torch, mods)
        return 0
    start_cpu_refs()  # the CPU references need no kernel: they start beside nvcc
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
            total[k] += launches.get(k, 0)

    # quickstart: cuda (kernels), then cpu (plain versions), same init
    runner, _, secs, launches, params = run_scenario(torch, mods, "quickstart", (), "cuda")
    intervals = runner.cfg.num_rounds // runner.hier_config.kappa2_effective
    check(launches["grouped_mean"] == intervals * 12, f"quickstart K1 launches {launches}")
    agreement = cpu_agreement(runner, "quickstart", "quickstart")
    count(launches)
    emit({"phase": "quickstart", **path_report(runner, secs, launches, {
        **agreement, "final_accuracy": runner.history[-1].accuracy,
        "profile": device_profile(torch, mods, "quickstart", (), params)})})

    # ragged edges: level 1 goes through K2
    runner, state, secs, launches, _ = run_scenario(torch, mods, "ragged_edges", RAGGED, "cuda")
    REFS["ragged"] = stash(runner, state)
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
    REFS["mlp307k"] = stash(runner, state)
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
        agreement = cpu_agreement(runner, name, name)
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
    REFS["mlp307k_int8_ef"] = stash(runner, state)
    peak = torch.cuda.max_memory_allocated() - base
    agreement = cpu_agreement(runner, "mlp307k_int8_ef", "int8_ef_both")
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
    # the CPU runs the client-blocked lowering's plain versions slowly: its
    # first cloud interval (2 of 8 rounds) is held
    agreement = cpu_agreement(runner, "mlp307k_megakernel", "hierfavg_edge_iid")
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

    # the paper's figure and table scripts at their own sizes: K1 on every
    # sync, K4 and K5 on every compressed one
    count(phase_paper_figures(torch, mods))

    # the paper's CNNs at its setting (50 clients on 5 edges, batch 20,
    # SGD): K1 on every sync; the CIFAR-10 CNN's divergences and Theorem 1
    launches, cifar_runs, cifar_cut = phase_paper(torch, mods, "cifar10")
    count(launches)
    phase_divergence_cifar10(torch, cifar_runs, cifar_cut)
    del cifar_runs, cifar_cut
    count(phase_paper(torch, mods, "mnist")[0])

    # federated LM training: K1 per leaf per level mean, K4/K5 per leaf per
    # compressed sync, K7/K8 never (the layer code runs under torch.func)
    sharded_params = mlp_params  # the init, on the host
    del runner, state, mk_runner, mlp_runner, mlp_params, params
    count(phase_train_lm10m(torch, mods, "train_lm10m", LM_TRAIN))
    count(phase_train_lm10m(torch, mods, "train_lm10m_int8_ef", LM_INT8_EF))
    count(phase_train_lm100m(torch, mods))
    count(phase_train_lm100m_robust(torch, mods))
    count(phase_train_lm100m_accum2(torch, mods))
    # the examples: K1 (quickstart, train_hier_lm at lm-100m), K2 (the
    # ragged trees of compare_topologies), K7 (serve_lm's prefill)
    count(phase_examples(torch, mods, fa))
    count(phase_roofline_calibration(torch, mods))

    # the client-sharded superround over torch.distributed ranks on this
    # card: a world of 1 under NCCL in this process, then a gloo world of 4
    # ranks sharing it (the 2-rank scenarios run in phase_world2's world),
    # each held to the single-device card run
    count(phase_sharded_w1_nccl(torch, mods, sharded_params))
    phase_sharded_w4(torch)
    count(phase_train_xlstm350m(torch, mods))

    # LM serving: K7 in every attention layer and K8 in every RG-LRU layer of
    # the prefill
    count(phase_serve_lm100m(torch, mods))
    count(phase_serve_recurrentgemma9b(torch, mods))

    # MLA, MoE and xLSTM: xlstm-350m uncut (no kernel on its path), and
    # deepseek-v3's MLA + MoE layer at full width (K7 in its prefill)
    count(phase_serve_xlstm350m(torch, mods))
    count(phase_serve_deepseekv3_l1(torch, mods, fa))

    # one gloo world of 2 ranks sharing the card: the 2-rank sharded
    # scenarios, the train cells over ("data",) and ("data", "model"),
    # lm-100m served tensor-parallel, deepseek-v3's layer expert-parallel,
    # and the RG-LRU, MLA / MoE and xLSTM families tensor-parallel
    yi9b = dryrun_subprocess()  # the dry run's (c), beside the 2-rank world
    count(phase_world2(torch, mods, fa))

    # the dry run's op counter against the card: lm-100m's prefill (K7) and
    # train cell (K1) on real and on meta tensors; the fake (1, 2) world
    # against the gloo ranks' count; the yi-9b dry run in a subprocess
    count(phase_dryrun(torch, mods, yi9b))

    check(all(total[name] > 0 for name in KERNELS), f"a kernel was never launched on its path: {total}")
    emit({"phase": "wall", "seconds": time.perf_counter() - T0, "cpu_reference_waits_s": CPU_WAITS,
          "cpu_reference_done_at_s": CPU_DONE, "host_cpus": host_cpus()})
    emit({"phase": "profiler", "traces_whole": TRACE_STATS["whole"], "traces_taken_again": TRACE_STATS["taken_again"],
          "leading_spins_lost_max": TRACE_STATS["leading_spins_lost_max"]})
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
    try:
        rc = main()
    finally:
        stop_all()
    sys.exit(rc)
