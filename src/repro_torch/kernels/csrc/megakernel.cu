// K3 edge_interval: one fused edge interval of flat-row linear clients on
// the H100 (sm_90a), with a plain C entry point for ctypes.
//
// Replaces the Pallas TPU kernel edge_interval_pallas / _edge_interval_kernel
// (src/repro/kernels/megakernel.py:96, body :72, call :144), and computes the
// same function as its plain PyTorch version edge_interval_plain
// (kernels/megakernel.py). Each client row holds a linear map W (feat, out),
// row-major (W[f, o] at f * out + o). For every client of an edge: kappa1
// steps of
//     r    = x_t W - y_t                         (b, out)
//     loss = mean(r^2)
//     g    = (2 / (b out)) x_t^T r               (feat, out)
//     mu   = g + m mu;  W -= lr mu               (momentum m != 0)
//     W   -= lr g                                (m == 0; mu untouched)
// then the edge's weighted mean sum_c w_c W_c / sum_c w_c (f32, no zero
// guard, as megakernel.py:89-90) written back to all of the edge's rows in
// the params dtype (f32 or bf16; bf16 rows are read into f32 once and
// written once).
//
// Design. The TPU form keeps one edge's whole (C, P) block in VMEM per grid
// step; a Hopper block has 227 KB of shared memory, so that does not carry
// over. What makes the card's version simple: the columns of W are
// independent. r[:, o] needs only column o of W, and g[:, o] updates only
// column o, so tiling over `out` puts no reduction across tiles into a step.
// A lane owns one output column of one client; a warp covers 32 consecutive
// columns; a block holds the clients of one edge for one 32-column tile, so
// the grid is (ceil(out / 32), edges), and a call is one launch. With up to
// 8 warps a block runs its clients in rounds of 8, in client order. Per
// client, a warp
//   1. asks for its (feat, 32) boxes of W and mu by TMA into shared memory
//      (one thread, completing on the warp's mbarrier), where rows and bases
//      are 16-byte multiples and feat <= 64; else each lane loads its column
//      row by row (slower at the full-width case, most in bf16: chip_smoke.py
//      times both, PERF.md has the numbers);
//   2. stages its steps' x_t (b, feat) and its tile of y_t (b, 32) in a ring
//      of up to 8 steps in shared memory by cp.async (16-byte copies where
//      rows and bases allow, else 4-byte ones), in flight with the boxes;
//      with kappa1 <= 8 and room for the whole interval every step is
//      staged before the first, else the next step is issued as a slot
//      frees, so shared memory does not grow with kappa1 (and the deepest
//      ring that fits is taken for large b);
//   3. with feat <= 64 keeps its column of W (and of mu) in registers,
//      zero-padded to 64 rows so the unrolled loops over f carry no branch
//      (a branch per iteration made each its own basic block and cost 3.8x);
//      x rows are zero-padded to 64 in the ring and read as float4
//      broadcasts; the forward dot runs as 4 independent partial sums
//      combined in a fixed order. Above feat 64 the column lives in an f32
//      scratch copy (padded to whole tiles) in device memory, which stays in
//      the 50 MB L2 at these sizes;
//   4. runs the steps with no device-memory access (register path): the
//      residual times 2 / (b out) (times -lr with momentum 0, so a row's
//      step is one FMA) stays in registers (in place of y_t in the ring when
//      b > 2); each lane writes its squared residuals to a (32 steps, 33)
//      buffer, reduced over the lanes in a fixed tree and stored once per 32
//      steps (a shuffle tree per step was slower on the H100, PERF.md);
//   5. stores mu from registers, and (register path) writes its final
//      column to shared memory over its ring.
// After each round the block adds each element's w_c W_c to the running
// weighted sum in client order (kept in shared memory from round to round
// when there are several); after the last it writes the edge's rows with
// 16-byte stores where out is a multiple of 4 (the scratch path reads the
// final columns from its scratch copy). Step losses are summed across
// tiles by the last block of each edge: after the block's last steps,
// thread 0 fences and takes a per-edge ticket (acquire-release atomic; that
// block zeroes the counter for the next launch) while the other warps form
// the mean, and the block holding the last ticket sums the (client, step,
// tile) partials in tile order at its end, so two runs agree bit for bit
// whatever order blocks finish in. No
// tensor-core products, so no TF32; IEEE division; no fast math.
//
// Bound: bytes. Each input read once and each output written once: params
// and out (2 N P s), mu in and out when m != 0 (2 N P s), x and y
// (N kappa1 b (feat + out) 4), w and the losses. About 67 MFLOP at the
// full-width case (N 32, feat 64, out 1024, kappa1 8, b 1) against 34.7 MB
// of f32 traffic with momentum: memory-bound by design. The grid there is
// 128 blocks of 8 warps on 132 SMs, one wave, so the phases run in series
// across the card: loads, then steps with the memory idle, then stores
// (PERF.md gives their times from clock marks on the H100).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kTile = 32;      // output columns per block: one per lane
constexpr int kMaxWarps = 8;   // warps per block; a round holds one client each
constexpr int kRegFeat = 64;   // feat up to this keeps a column in registers
constexpr int kMaxRing = 8;    // steps a warp stages ahead
constexpr int kVec = 4;        // columns per thread in the mean and its stores
constexpr int kMaxSmem = 232448;  // dynamic shared memory one Hopper block can use
constexpr int kAlign = 128;    // TMA's shared-memory alignment

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float get(const float4& v, int k) { return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w; }
__device__ __forceinline__ float4 fma4(float w, float4 v, float4 a) {
  return make_float4(fmaf(w, v.x, a.x), fmaf(w, v.y, a.y), fmaf(w, v.z, a.z), fmaf(w, v.w, a.w));
}
__device__ __forceinline__ float4 div4(float4 a, float d) { return make_float4(a.x / d, a.y / d, a.z / d, a.w / d); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Wait until at most `pending` (0 .. kMaxRing - 1) of this thread's newest
// copy groups are still in flight.
__device__ __forceinline__ void cp_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// One TMA box (32 columns x feat rows) of a 2-d map (out, N feat).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}
__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// One client's column of W or mu, in registers (FREG > 0, indexed only
// inside fully unrolled loops) or in the padded f32 scratch (FREG == 0).
template <int FREG>
struct Column {
  float v[FREG];
  __device__ __forceinline__ void bind(float*, size_t) {}
  __device__ __forceinline__ float& operator[](int f) { return v[f]; }
};
template <>
struct Column<0> {
  float* p;
  size_t stride;
  __device__ __forceinline__ void bind(float* base, size_t s) { p = base; stride = s; }
  __device__ __forceinline__ float& operator[](int f) { return p[f * stride]; }
};

__host__ __device__ __forceinline__ long long up(long long v, long long a) { return (v + a - 1) / a * a; }
// Row stride of x in a ring slot: 64 on the register path (rows zero-padded),
// else feat rounded up to 4 floats so every slot stays 16-byte aligned.
__host__ __device__ __forceinline__ int x_stride(int feat) { return feat <= kRegFeat ? kRegFeat : (feat + 3) & ~3; }
// Floats of one ring slot: x_t (b, x_stride) then y_t's tile (b, 32).
__host__ __device__ __forceinline__ long long slot_floats(int b, int feat) {
  return (long long)b * (x_stride(feat) + kTile);
}
// Each lane's loss partial of 32 steps, rows padded to 33 so that a lane
// reading its row meets no bank conflict.
constexpr int kLossRow = kTile + 1;
constexpr int kLossFloats = kTile * kLossRow;

// Shared memory, in bytes from a 128-byte aligned base: per warp a region
// holding its ring and its loss partials, which on the register path later
// holds the warp's final (feat, 32) column tile for the mean; then (register
// path, more than one round) the mean's running sum (feat, 32) f32; then
// (TMA) per warp the staged boxes of W and mu (feat, 32) in the params
// dtype and an mbarrier.
struct Layout {
  long long region, carry, stage, bars, total;
};
__host__ __device__ __forceinline__ Layout layout(int warps, int ring, int b, int feat, int esize, bool carry,
                                                  bool tma, bool mom) {
  Layout l;
  const long long cols = feat <= kRegFeat ? (long long)feat * kTile : 0;
  const long long r = ring * slot_floats(b, feat) + kLossFloats;
  l.region = up(4 * (r > cols ? r : cols), kAlign);
  l.carry = (long long)warps * l.region;
  const long long box = up((long long)feat * kTile * esize, kAlign);
  l.stage = l.carry + (carry ? up(4ll * feat * kTile, kAlign) : 0);
  l.bars = l.stage + (tma ? warps * box * (mom ? 2 : 1) : 0);
  l.total = l.bars + (tma ? 8ll * warps : 0) + kAlign;  // + room to align the base
  return l;
}

// The launch's shape: warps per block, ring depth, whether W and mu come in
// by TMA, and the layout. The ring is the deepest (up to kappa1 and
// kMaxRing steps) that fits without TMA; TMA is taken where the caller
// allows it and its staging fits beside that ring. If not even a one-step
// ring fits, the layout's total exceeds kMaxSmem and the caller refuses.
struct Plan {
  int warps, ring;
  bool carry, tma;
  Layout l;
};
Plan plan(int n, int num_edges, int k1, int b, int feat, int esize, bool mom, bool tma_ok) {
  const int cpe = n / num_edges;
  Plan p;
  p.warps = cpe < kMaxWarps ? cpe : kMaxWarps;
  p.carry = feat <= kRegFeat && cpe > p.warps;
  const int top = k1 < kMaxRing ? k1 : kMaxRing;
  for (p.ring = top; p.ring > 1; --p.ring) {
    if (layout(p.warps, p.ring, b, feat, esize, p.carry, false, mom).total <= kMaxSmem) break;
  }
  p.tma = tma_ok && feat <= kRegFeat &&
          layout(p.warps, p.ring, b, feat, esize, p.carry, true, mom).total <= kMaxSmem;
  p.l = layout(p.warps, p.ring, b, feat, esize, p.carry, p.tma, mom);
  return p;
}

// Issue (no wait) the copies of client c's step t into a ring slot: x_t's
// rows at stride xs, zeros in the pad rows f in [feat, FREG) (register
// path), then the tile's `ncols` columns of y_t's rows at stride 32.
template <int FREG>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ x, const float* __restrict__ y, size_t c,
                                      int t, int k1, int nb, int feat, int xs, int outc, int tile, int ncols,
                                      bool xvec, bool yvec, int lane) {
  const size_t row = (c * k1 + t) * nb;  // first of the step's b rows
  const float* xt = x + row * feat;
  if (xvec) {  // feat % 4 == 0 and x 16-byte aligned
    for (int i = lane * 4; i < nb * feat; i += kTile * 4) {
      const int bb = i / feat;
      cp_async16(dst + bb * xs + (i - bb * feat), xt + i);
    }
  } else {
    for (int i = lane; i < nb * feat; i += kTile) {
      const int bb = i / feat;
      cp_async4(dst + bb * xs + (i - bb * feat), xt + i);
    }
  }
  if (FREG > 0 && feat < FREG) {
    const int pad = FREG - feat;
    for (int i = lane; i < nb * pad; i += kTile) {
      const int bb = i / pad;
      dst[bb * xs + feat + (i - bb * pad)] = 0.f;
    }
  }
  float* yd = dst + nb * xs;
  const float* yt = y + row * outc + (size_t)tile * kTile;
  if (yvec) {  // out % 4 == 0 and y 16-byte aligned
    for (int i = lane; i < nb * (kTile / 4); i += kTile) {
      const int bb = i / (kTile / 4), q = 4 * (i % (kTile / 4));
      if (q < ncols) cp_async16(yd + bb * kTile + q, yt + (size_t)bb * outc + q);
    }
  } else {
    for (int i = lane; i < nb * kTile; i += kTile) {
      const int bb = i / kTile, k = i % kTile;
      if (k < ncols) cp_async4(yd + bb * kTile + k, yt + (size_t)bb * outc + k);
    }
  }
}

// Write the mean `m` of float4 group g (row f = g / 8, columns 4 (g % 8) ..
// + 3 of the tile) to every row of the edge: one 16-byte (8 for bf16) store
// per row where out % 4 == 0 and out is aligned, else one per column.
template <typename T>
__device__ __forceinline__ void store_mean(T* __restrict__ out, float4 m, int g, size_t e0, int cpe, size_t P,
                                           int outc, int tile, bool ovec) {
  const int f = g / (kTile / kVec), o = tile * kTile + kVec * (g % (kTile / kVec));
  if (o >= outc) return;
  T* dst = out + e0 * P + (size_t)f * outc + o;
  for (int cl = 0; cl < cpe; ++cl, dst += P) {
    if (ovec) {
      store4(dst, m);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        if (o + k < outc) store(dst + k, get(m, k));
    }
  }
}

// The block's part in the losses: after a block barrier that follows every
// partial store, thread 0 publishes them and takes the edge's ticket; true
// for the last block of the edge, which zeroes the counter for the next
// launch on this stream.
__device__ __forceinline__ int take_ticket(unsigned* tickets, int edge, int ntiles) {
  __threadfence();  // the block's partials, ordered before it by the barrier
  const int last = atom_add_acq_rel(tickets + edge, 1u) == (unsigned)(ntiles - 1);
  if (last) tickets[edge] = 0u;
  return last;
}

// FREG > 0: the columns sit in registers and every loop over f runs FREG
// times with no branch (rows f >= feat hold 0 and see x = 0, so they stay
// 0 and are never stored). B > 0: the local batch is B, known at compile
// time, so the loops over it unroll and the residuals stay in registers;
// B == 0 reads it from `b` and keeps the residuals in the ring, over y_t.
template <typename T, int FREG, int B, bool MOM>
__global__ void __launch_bounds__(kTile * kMaxWarps, 1)
edge_interval_kernel(const __grid_constant__ CUtensorMap map_p, const __grid_constant__ CUtensorMap map_m,
                     const T* __restrict__ params, const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ w, const T* __restrict__ mu_in, T* __restrict__ out,
                     T* __restrict__ mu_out, float* __restrict__ losses, float* work, float* work_mu,
                     float* __restrict__ partial, unsigned* __restrict__ tickets, int cpe, int feat, int outc, int k1,
                     int b, int ring, int tma, float lr, float momentum, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const int nb = B > 0 ? B : b;
  const int tile = blockIdx.x, edge = blockIdx.y, ntiles = gridDim.x;
  const int lane = threadIdx.x & (kTile - 1), warp = threadIdx.x / kTile;
  const int warps = blockDim.x / kTile, nthreads = blockDim.x;
  const int o = tile * kTile + lane, ncols = min(kTile, outc - tile * kTile);
  const bool valid = o < outc;
  const size_t P = (size_t)feat * outc, opad = (size_t)ntiles * kTile, e0 = (size_t)edge * cpe;
  const int flim = FREG > 0 ? FREG : feat;  // loop bound over f
  const int xs = FREG > 0 ? FREG : x_stride(feat);
  const long long slot = slot_floats(nb, feat);
  const int rounds = (cpe + warps - 1) / warps;
  const Layout lay = layout(warps, ring, nb, feat, sizeof(T), FREG > 0 && rounds > 1, tma, MOM);
  uint8_t* base = smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  auto region = [&](int k) { return reinterpret_cast<float*>(base + k * lay.region); };
  float* mine = region(warp);
  float4* carry = reinterpret_cast<float4*>(base + lay.carry);
  const long long box = up((long long)feat * kTile * sizeof(T), kAlign);
  const T* sw = reinterpret_cast<const T*>(base + lay.stage + warp * box * (MOM ? 2 : 1));
  const T* sm = reinterpret_cast<const T*>(reinterpret_cast<const uint8_t*>(sw) + box);
  const uint32_t bar = smem_u32(base + lay.bars + 8 * warp);
  const bool xvec = feat % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool yvec = outc % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const bool ovec = outc % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int groups = feat * (kTile / kVec);  // float4 groups of the tile's mean
  if (FREG > 0 && tma && lane == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  float den = 0.f;
  int last = 0;

  for (int rd = 0; rd < rounds; ++rd) {
    const int cl = rd * warps + warp;
    if (cl < cpe) {  // warp-uniform
      const size_t c = e0 + cl;
      const size_t col = c * P + o;             // W_c[0, o] in params / out / mu
      const size_t wcol = c * feat * opad + o;  // W_c[0, o] in the padded scratch
      if (FREG > 0 && tma && lane == 0) {  // this client's (feat, 32) boxes of W and mu
        mbar_expect(bar, (MOM ? 2 : 1) * feat * kTile * (int)sizeof(T));
        tma_load(smem_u32(sw), &map_p, bar, tile * kTile, (int)(c * feat));
        if (MOM) tma_load(smem_u32(sm), &map_m, bar, tile * kTile, (int)(c * feat));
      }
      const int r0 = min(ring, k1);
      for (int t = 0; t < r0; ++t) {
        stage<FREG>(mine + t * slot, x, y, c, t, k1, nb, feat, xs, outc, tile, ncols, xvec, yvec, lane);
        cp_commit();
      }
      const bool whole = r0 == k1;  // every step is staged: one wait before the first
      Column<FREG> wv, mv;
      wv.bind(work + wcol, opad);
      if (MOM && FREG == 0) mv.bind(work_mu + wcol, opad);
      if (rd == 0)
        for (int k = 0; k < cpe; ++k) den += w[e0 + k];
      if (FREG > 0 && tma) {  // out-of-bounds columns of the box arrive as zeros
        mbar_wait(bar, rd & 1);
#pragma unroll
        for (int f = 0; f < flim; ++f) {
          wv[f] = f < feat ? to_f32(sw[f * kTile + lane]) : 0.f;
          if (MOM) mv[f] = f < feat ? to_f32(sm[f * kTile + lane]) : 0.f;
        }
      } else {
#pragma unroll
        for (int f = 0; f < flim; ++f) {
          const bool live = valid && (FREG == 0 || f < feat);
          wv[f] = live ? to_f32(params[col + (size_t)f * outc]) : 0.f;
          if (MOM) mv[f] = live ? to_f32(mu_in[col + (size_t)f * outc]) : 0.f;
        }
      }
      float* lbuf = mine + ring * slot;  // (32 steps, 33) loss partials per lane
      // lanes j < count: the tile's loss partial of step t0 + j, summed over
      // the lanes in a fixed tree, to `partial`
      auto flush = [&](int t0, int count) {
        __syncwarp();
        if (lane < count) {
          float v[kTile];
#pragma unroll
          for (int i = 0; i < kTile; ++i) v[i] = lbuf[lane * kLossRow + i];
#pragma unroll
          for (int i = 0; i < 16; ++i) v[i] += v[i + 16];
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] += v[i + 8];
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] += v[i + 4];
          v[0] += v[2];
          v[1] += v[3];
          v[0] += v[1];
          partial[((c * k1 + t0) + lane) * ntiles + tile] = v[0];
        }
        __syncwarp();  // the rows are read before the next steps write them
      };
      for (int t = 0, s = 0; t < k1; ++t) {
        if (!whole || t == 0) {
          cp_wait(whole ? 0 : min(k1 - 1 - t, ring - 1));
          __syncwarp();  // every lane's copies of step t have landed
        }
        float* xt = mine + s * slot;
        float* yt = xt + nb * xs;
        float rs[B > 0 ? B : 1];  // residual x 2 / (b out), per row of the batch
        float lsum = 0.f;
#pragma unroll
        for (int bb = 0; bb < nb; ++bb) {
          const float* xb = xt + bb * xs;
          float acc;
          if constexpr (FREG > 0) {
            float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
            for (int q = 0; q < FREG / 4; ++q) {
              const float4 xv = reinterpret_cast<const float4*>(xb)[q];
              a0 = fmaf(xv.x, wv[4 * q], a0);
              a1 = fmaf(xv.y, wv[4 * q + 1], a1);
              a2 = fmaf(xv.z, wv[4 * q + 2], a2);
              a3 = fmaf(xv.w, wv[4 * q + 3], a3);
            }
            acc = (a0 + a1) + (a2 + a3);
          } else {
            acc = 0.f;
            for (int f = 0; f < feat; ++f) acc = fmaf(xb[f], wv[f], acc);
          }
          const float rv = valid ? acc - yt[bb * kTile + lane] : 0.f;
          lsum = fmaf(rv, rv, lsum);
          // with momentum 0 the step is W += x (-lr r scale), one FMA per row
          const float coef = MOM || FREG == 0 ? rv * scale : -lr * (rv * scale);
          if (B > 0) rs[B > 0 ? bb : 0] = coef;
          else yt[bb * kTile + lane] = coef;  // only this lane reads it
        }
        auto update = [&](int f, float g) {
          if (MOM) {
            const float m = fmaf(momentum, mv[f], g);
            mv[f] = m;
            wv[f] = fmaf(-lr, m, wv[f]);
          } else {
            wv[f] = fmaf(-lr, g, wv[f]);
          }
        };
        if constexpr (FREG > 0 && !MOM) {
#pragma unroll
          for (int q = 0; q < FREG / 4; ++q) {
#pragma unroll
            for (int bb = 0; bb < nb; ++bb) {
              const float4 xv = reinterpret_cast<const float4*>(xt + bb * xs)[q];
              const float cb = B > 0 ? rs[B > 0 ? bb : 0] : yt[bb * kTile + lane];
              wv[4 * q] = fmaf(xv.x, cb, wv[4 * q]);
              wv[4 * q + 1] = fmaf(xv.y, cb, wv[4 * q + 1]);
              wv[4 * q + 2] = fmaf(xv.z, cb, wv[4 * q + 2]);
              wv[4 * q + 3] = fmaf(xv.w, cb, wv[4 * q + 3]);
            }
          }
        } else if constexpr (FREG > 0) {
#pragma unroll
          for (int q = 0; q < FREG / 4; ++q) {
            float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int bb = 0; bb < nb; ++bb)
              g = fma4(B > 0 ? rs[B > 0 ? bb : 0] : yt[bb * kTile + lane],
                       reinterpret_cast<const float4*>(xt + bb * xs)[q], g);
            update(4 * q, g.x);
            update(4 * q + 1, g.y);
            update(4 * q + 2, g.z);
            update(4 * q + 3, g.w);
          }
        } else {
          for (int f = 0; f < feat; ++f) {
            float g = 0.f;
            for (int bb = 0; bb < nb; ++bb) g = fmaf(xt[bb * xs + f], yt[bb * kTile + lane], g);
            update(f, g);
          }
        }
        lbuf[(t & (kTile - 1)) * kLossRow + lane] = lsum;
        if ((t & (kTile - 1)) == kTile - 1) flush(t - (kTile - 1), kTile);
        if (t + ring < k1) {  // refill this slot with step t + ring
          __syncwarp();
          stage<FREG>(xt, x, y, c, t + ring, k1, nb, feat, xs, outc, tile, ncols, xvec, yvec, lane);
          cp_commit();
        }
        s = s + 1 == ring ? 0 : s + 1;
      }
      if (k1 & (kTile - 1)) flush(k1 & ~(kTile - 1), k1 & (kTile - 1));
      __syncwarp();  // the ring is read; its space now takes the final column
#pragma unroll
      for (int f = 0; f < flim; ++f) {
        if (FREG > 0 && f < feat) mine[f * kTile + lane] = wv[f];
        if (MOM && valid && (FREG == 0 || f < feat)) store(mu_out + col + (size_t)f * outc, mv[f]);
      }
    }
    if (FREG > 0) {  // this round's clients into the mean, in client order
      __syncthreads();
      if (rd + 1 == rounds && threadIdx.x == 0) last = take_ticket(tickets, edge, ntiles);
      const int in_round = min(warps, cpe - rd * warps);
      const float* wr = w + e0 + rd * warps;
      const int skip = warps > 1 && rd + 1 == rounds ? kTile : 0;  // the ticket's warp sits the mean out
      for (int g = (int)threadIdx.x - skip; g >= 0 && g < groups; g += nthreads - skip) {
        float4 a = rd == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : carry[g];
        for (int k = 0; k < in_round; ++k) a = fma4(wr[k], reinterpret_cast<const float4*>(region(k))[g], a);
        if (rd + 1 == rounds) store_mean(out, div4(a, den), g, e0, cpe, P, outc, tile, ovec);
        else carry[g] = a;  // only this thread reads it back
      }
      if (rd + 1 < rounds) __syncthreads();  // the regions are free for the next round's rings
    }
  }
  if (FREG == 0) {  // the mean from the scratch columns, in client order
    __syncthreads();
    if (threadIdx.x == 0) last = take_ticket(tickets, edge, ntiles);
    const int skip = warps > 1 ? kTile : 0;  // the ticket's warp sits the mean out
    for (int g = (int)threadIdx.x - skip; g >= 0 && g < groups; g += nthreads - skip) {
      const int f = g / (kTile / kVec), q = kVec * (g % (kTile / kVec));
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int cl = 0; cl < cpe; ++cl)
        a = fma4(w[e0 + cl], *reinterpret_cast<const float4*>(work + ((e0 + cl) * feat + f) * opad + tile * kTile + q),
                 a);
      store_mean(out, div4(a, den), g, e0, cpe, P, outc, tile, ovec);
    }
  }

  // the last block of the edge sums the step losses across tiles, in order
  if (!__syncthreads_or(last)) return;
  const float count = (float)(b * outc);
  for (int i = threadIdx.x; i < cpe * k1; i += nthreads) {
    const size_t rowi = e0 * k1 + i;
    float s = 0.f;
    for (int k = 0; k < ntiles; ++k) s += __ldcg(partial + rowi * ntiles + k);
    losses[rowi] = s / count;
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda at link time)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A map of (n feat, out) rows of `esize`-byte elements: boxes of 32 columns
// x feat rows, no swizzle, zeros out of bounds. False where it cannot be made.
bool tensor_map(CUtensorMap* map, const void* ptr, int n, int feat, int outc, int esize) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)outc, (cuuint64_t)n * feat};
  const cuuint64_t strides[1] = {(cuuint64_t)outc * esize};
  const cuuint32_t boxd[2] = {(cuuint32_t)kTile, (cuuint32_t)feat};
  const cuuint32_t step[2] = {1, 1};
  const CUtensorMapDataType type = esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, boxd, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA needs 16-byte rows and bases (boxes of 32 columns x feat rows) and the
// register path.
bool tma_allowed(const void* params, const void* mu_in, int feat, int outc, int esize, bool mom) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(params) | (mom ? reinterpret_cast<uintptr_t>(mu_in) : 0);
  return feat <= kRegFeat && ((long long)outc * esize) % 16 == 0 && addr % 16 == 0;
}

struct Args {
  CUtensorMap map_p, map_m;
  const void* params;
  const float *x, *y, *w;
  const void* mu_in;
  void *out, *mu_out;
  float *losses, *work, *work_mu, *partial;
  unsigned* tickets;
  int cpe, feat, outc, k1, b;
  float lr, momentum, scale;
};

template <typename T, int FREG, int B, bool MOM>
cudaError_t launch(dim3 grid, const Plan& p, cudaStream_t s, const Args& a) {
  auto kernel = edge_interval_kernel<T, FREG, B, MOM>;
  const size_t smem = (size_t)p.l.total;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, p.warps * kTile, smem, s>>>(
      a.map_p, a.map_m, static_cast<const T*>(a.params), a.x, a.y, a.w, static_cast<const T*>(a.mu_in),
      static_cast<T*>(a.out), static_cast<T*>(a.mu_out), a.losses, a.work, a.work_mu, a.partial, a.tickets, a.cpe,
      a.feat, a.outc, a.k1, a.b, p.ring, p.tma ? 1 : 0, a.lr, a.momentum, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(dim3 grid, const Plan& p, cudaStream_t s, const Args& a) {
  const bool reg = a.feat <= kRegFeat, mom = a.momentum != 0.f;
#define K3_LAUNCH(FREG, B, MOM) launch<T, FREG, B, MOM>(grid, p, s, a)
  if (reg && a.b == 1) return mom ? K3_LAUNCH(kRegFeat, 1, true) : K3_LAUNCH(kRegFeat, 1, false);
  if (reg && a.b == 2) return mom ? K3_LAUNCH(kRegFeat, 2, true) : K3_LAUNCH(kRegFeat, 2, false);
  if (reg) return mom ? K3_LAUNCH(kRegFeat, 0, true) : K3_LAUNCH(kRegFeat, 0, false);
  return mom ? K3_LAUNCH(0, 0, true) : K3_LAUNCH(0, 0, false);
#undef K3_LAUNCH
}

}  // namespace

extern "C" {

// 1 where mk_edge_interval would bring W and mu in by TMA (16-byte rows and
// bases, feat <= 64, and the staging fits), else 0 (one load per lane and
// row).
int mk_edge_interval_uses_tma(const void* params, const void* mu_in, int n, int num_edges, int feat, int outc,
                              int k1, int b, float momentum, int dtype) {
  const int esize = dtype == 1 ? 2 : 4;
  const bool mom = momentum != 0.f;
  return plan(n, num_edges, k1, b, feat, esize, mom, tma_allowed(params, mu_in, feat, outc, esize, mom)).tma;
}

// Dynamic shared memory per block, in bytes, that mk_edge_interval needs
// for `n` clients on `num_edges` edges, kappa1 `k1`, local batch `b` and
// width `feat` (without the TMA staging, which it adds only where that
// fits); above 232448 (what one block can use) it refuses.
long long mk_edge_interval_smem(int n, int num_edges, int k1, int b, int feat) {
  return plan(n, num_edges, k1, b, feat, 4, true, false).l.total;
}

// params, mu_in, out, mu_out: (n, feat * outc) in `dtype` (0 f32, 1 bf16);
// x (n, k1, b, feat) and y (n, k1, b, outc) f32; w (n,) f32; losses (n, k1)
// f32. Scratch: work and work_mu (n, feat, ceil(outc / 32) * 32) f32 when
// feat > 64 (work_mu only when momentum != 0), else null; partial (n, k1,
// ceil(outc / 32)) f32; tickets (num_edges,) u32, zero before the launch
// and zero again after it. mu_in / mu_out are not touched when
// momentum == 0. One launch; returns its cudaError_t.
int mk_edge_interval(const void* params, const float* x, const float* y, const float* w, const void* mu_in,
                     void* out, void* mu_out, float* losses, float* work, float* work_mu, float* partial,
                     unsigned* tickets, int n, int num_edges, int feat, int outc, int k1, int b, float lr,
                     float momentum, float scale, int dtype, void* stream) {
  const int esize = dtype == 1 ? 2 : 4;
  const bool mom = momentum != 0.f;
  Args a;
  memset(&a.map_p, 0, sizeof(a.map_p));
  memset(&a.map_m, 0, sizeof(a.map_m));
  const Plan p = plan(n, num_edges, k1, b, feat, esize, mom, tma_allowed(params, mu_in, feat, outc, esize, mom));
  if (p.l.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (p.tma && !(tensor_map(&a.map_p, params, n, feat, outc, esize) &&
                 (!mom || tensor_map(&a.map_m, mu_in, n, feat, outc, esize))))
    return (int)cudaErrorInvalidValue;
  a.params = params; a.x = x; a.y = y; a.w = w; a.mu_in = mu_in; a.out = out; a.mu_out = mu_out;
  a.losses = losses; a.work = work; a.work_mu = work_mu; a.partial = partial; a.tickets = tickets;
  a.cpe = n / num_edges; a.feat = feat; a.outc = outc; a.k1 = k1; a.b = b;
  a.lr = lr; a.momentum = momentum; a.scale = scale;
  const dim3 grid((outc + kTile - 1) / kTile, num_edges);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? dispatch<__nv_bfloat16>(grid, p, s, a) : dispatch<float>(grid, p, s, a));
}

}  // extern "C"
