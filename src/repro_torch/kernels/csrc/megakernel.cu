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
// columns (coalesced loads along o) and runs its clients one after another;
// a block holds the clients of one edge for one 32-column tile, so the grid
// is (ceil(out / 32), edges). Each warp stages its client's x_t (b, feat)
// in shared memory once per step, where every lane reads it at the same
// address (a broadcast); each lane keeps its b residuals there too. With
// feat <= 64 the column of W (and of mu) sits in registers, zero-padded to
// 64 rows so that the unrolled loops over f carry no branch (a branch per
// iteration makes each its own basic block, and nothing overlaps), and
// b = 1 or 2 is a compile-time constant; above feat 64 the column lives in an
// f32 scratch copy (padded to whole tiles) that stays in the 50 MB L2 at
// these sizes. The final f32 columns go to that scratch, and
// after a block barrier the block forms each element's weighted mean over
// the edge's clients in client order. Step losses are reduced per (client,
// step, tile) by warp shuffles and summed across tiles in a fixed order by a
// second small kernel, so two runs agree bit for bit (no atomics). No
// tensor-core products, so no TF32; IEEE division; no fast math.
//
// Bound: bytes. Each input read once and each output written once: params
// and out (2 N P s), mu in and out when m != 0 (2 N P s), x and y
// (N kappa1 b (feat + out) 4), w and the losses. About 67 MFLOP at the
// full-width case (N 32, feat 64, out 1024, kappa1 8, b 1) against 34.7 MB
// of f32 traffic with momentum: memory-bound by design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 32;     // output columns per block: one per lane
constexpr int kMaxWarps = 8;  // warps per block; each runs its clients in turn
constexpr int kRegFeat = 64;  // feat up to this keeps a column in registers

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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

// FREG > 0: the columns sit in registers and every loop over f runs FREG
// times with no branch (rows f >= feat hold 0 and see x = 0, so they stay
// 0 and are never stored). B > 0: the local batch is B, known at compile
// time, so the loops over it unroll too; B == 0 reads it from `b`.
template <typename T, int FREG, int B, bool MOM>
__global__ void __launch_bounds__(kTile * kMaxWarps)
edge_interval_kernel(const T* __restrict__ params, const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ w, const T* __restrict__ mu_in, T* __restrict__ out,
                     T* __restrict__ mu_out, float* work, float* work_mu, float* __restrict__ partial,
                     int cpe, int feat, int outc, int k1, int b, float lr, float momentum, float scale) {
  // shared: (warps, b, 32) residuals of each lane, then (warps, b, xstride)
  // the staged x_t of each warp's client, rows zero-padded to FREG
  extern __shared__ float smem[];
  const int nb = B > 0 ? B : b;
  const int tile = blockIdx.x, edge = blockIdx.y, ntiles = gridDim.x;
  const int lane = threadIdx.x & (kTile - 1), warp = threadIdx.x / kTile, warps = blockDim.x / kTile;
  const int o = tile * kTile + lane;
  const bool valid = o < outc;
  const size_t P = (size_t)feat * outc, opad = (size_t)ntiles * kTile;
  const int flim = FREG > 0 ? FREG : feat;  // loop bound over f, and the row stride of xs
  float* r = smem + (size_t)warp * nb * kTile + lane;
  float* xs = smem + (size_t)warps * nb * kTile + (size_t)warp * nb * flim;

  for (int cl = warp; cl < cpe; cl += warps) {  // warp-uniform
    const size_t c = (size_t)edge * cpe + cl;
    const size_t col = c * P + o;             // W_c[0, o] in params / out / mu
    const size_t wcol = c * feat * opad + o;  // W_c[0, o] in the padded scratch
    Column<FREG> wv, mv;
    wv.bind(work + wcol, opad);
    if (MOM && FREG == 0) mv.bind(work_mu + wcol, opad);
#pragma unroll
    for (int f = 0; f < flim; ++f) {
      const bool live = valid && (FREG == 0 || f < feat);
      wv[f] = live ? to_f32(params[col + (size_t)f * outc]) : 0.f;
      if (MOM) mv[f] = live ? to_f32(mu_in[col + (size_t)f * outc]) : 0.f;
    }
    for (int t = 0; t < k1; ++t) {
      const float* xt = x + (c * k1 + t) * nb * feat;
      const float* yt = y + (c * k1 + t) * nb * outc;
      __syncwarp();  // the previous step's reads of xs are done
      for (int i = lane; i < nb * flim; i += kTile) {
        const int bb = i / flim, f = i - bb * flim;
        xs[i] = (FREG == 0 || f < feat) ? xt[(size_t)bb * feat + f] : 0.f;
      }
      __syncwarp();
      float lsum = 0.f;
#pragma unroll
      for (int bb = 0; bb < nb; ++bb) {
        const float* xb = xs + (size_t)bb * flim;
        float acc = 0.f;
#pragma unroll
        for (int f = 0; f < flim; ++f) acc += xb[f] * wv[f];
        const float rv = acc - (valid ? yt[(size_t)bb * outc + o] : 0.f);
        r[bb * kTile] = rv;
        lsum += rv * rv;
      }
#pragma unroll
      for (int f = 0; f < flim; ++f) {
        float g = 0.f;
#pragma unroll
        for (int bb = 0; bb < nb; ++bb) g += xs[(size_t)bb * flim + f] * r[bb * kTile];
        g *= scale;
        if (MOM) {
          const float m = g + momentum * mv[f];
          mv[f] = m;
          wv[f] -= lr * m;
        } else {
          wv[f] -= lr * g;
        }
      }
      for (int off = kTile / 2; off > 0; off >>= 1) lsum += __shfl_down_sync(0xffffffffu, lsum, off);
      if (lane == 0) partial[(c * k1 + t) * ntiles + tile] = lsum;
    }
#pragma unroll
    for (int f = 0; f < flim; ++f) {
      if (FREG > 0 && f < feat) work[wcol + f * opad] = wv[f];
      if (MOM && valid && (FREG == 0 || f < feat)) store(mu_out + col + (size_t)f * outc, mv[f]);
    }
  }
  __syncthreads();  // every client's final column of this tile is in `work`

  const size_t e0 = (size_t)edge * cpe;
  float den = 0.f;
  for (int cl = 0; cl < cpe; ++cl) den += w[e0 + cl];
  for (int i = threadIdx.x; i < feat * kTile; i += blockDim.x) {
    const int f = i / kTile, oo = tile * kTile + i % kTile;
    if (oo >= outc) continue;
    float acc = 0.f;
#pragma unroll 8
    for (int cl = 0; cl < cpe; ++cl) acc += w[e0 + cl] * work[((e0 + cl) * feat + f) * opad + oo];
    const float mean = acc / den;
#pragma unroll 8
    for (int cl = 0; cl < cpe; ++cl) store(out + (e0 + cl) * P + (size_t)f * outc + oo, mean);
  }
}

// losses[i] = (sum over tiles, in tile order, of partial[i, :]) / (b out).
__global__ void edge_interval_loss_kernel(const float* __restrict__ partial, float* __restrict__ losses, int rows,
                                          int ntiles, float count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  float s = 0.f;
  for (int k = 0; k < ntiles; ++k) s += partial[(size_t)i * ntiles + k];
  losses[i] = s / count;
}

template <typename T, int FREG, int B, bool MOM>
cudaError_t launch(dim3 grid, int threads, size_t smem, cudaStream_t s, const void* params, const float* x,
                   const float* y, const float* w, const void* mu_in, void* out, void* mu_out, float* work,
                   float* work_mu, float* partial, int cpe, int feat, int outc, int k1, int b, float lr,
                   float momentum, float scale) {
  auto kernel = edge_interval_kernel<T, FREG, B, MOM>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, s>>>(static_cast<const T*>(params), x, y, w, static_cast<const T*>(mu_in),
                                     static_cast<T*>(out), static_cast<T*>(mu_out), work, work_mu, partial, cpe,
                                     feat, outc, k1, b, lr, momentum, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool reg, bool mom, dim3 grid, int threads, size_t smem, cudaStream_t s, const void* params,
                     const float* x, const float* y, const float* w, const void* mu_in, void* out, void* mu_out,
                     float* work, float* work_mu, float* partial, int cpe, int feat, int outc, int k1, int b,
                     float lr, float momentum, float scale) {
#define K3_LAUNCH(FREG, B, MOM)                                                                                  \
  launch<T, FREG, B, MOM>(grid, threads, smem, s, params, x, y, w, mu_in, out, mu_out, work, work_mu, partial,    \
                          cpe, feat, outc, k1, b, lr, momentum, scale)
  if (reg && b == 1) return mom ? K3_LAUNCH(kRegFeat, 1, true) : K3_LAUNCH(kRegFeat, 1, false);
  if (reg && b == 2) return mom ? K3_LAUNCH(kRegFeat, 2, true) : K3_LAUNCH(kRegFeat, 2, false);
  if (reg) return mom ? K3_LAUNCH(kRegFeat, 0, true) : K3_LAUNCH(kRegFeat, 0, false);
  return mom ? K3_LAUNCH(0, 0, true) : K3_LAUNCH(0, 0, false);
#undef K3_LAUNCH
}

}  // namespace

extern "C" {

// Shared memory per block, in bytes, for `n` clients on `num_edges` edges,
// local batch `b` and width `feat` (the wrapper checks it against the
// card's limit).
long long mk_edge_interval_smem(int n, int num_edges, int b, int feat) {
  const int cpe = n / num_edges;
  const long long warps = cpe < kMaxWarps ? cpe : kMaxWarps;
  const long long xstride = feat <= kRegFeat ? kRegFeat : feat;
  return warps * b * (kTile + xstride) * (long long)sizeof(float);
}

// params, mu_in, out, mu_out: (n, feat * outc) in `dtype` (0 f32, 1 bf16);
// x (n, k1, b, feat) and y (n, k1, b, outc) f32; w (n,) f32; losses (n, k1)
// f32. Scratch: work (n, feat, ceil(outc / 32) * 32) f32; work_mu the same
// when momentum != 0 and feat > 64, else null; partial (n, k1,
// ceil(outc / 32)) f32. mu_in / mu_out are not touched when momentum == 0.
// Returns the cudaError_t of the launches.
int mk_edge_interval(const void* params, const float* x, const float* y, const float* w, const void* mu_in,
                     void* out, void* mu_out, float* losses, float* work, float* work_mu, float* partial, int n,
                     int num_edges, int feat, int outc, int k1, int b, float lr, float momentum, float scale,
                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cpe = n / num_edges;
  const int ntiles = (outc + kTile - 1) / kTile;
  const int warps = cpe < kMaxWarps ? cpe : kMaxWarps;
  const size_t smem = (size_t)mk_edge_interval_smem(n, num_edges, b, feat);
  const dim3 grid(ntiles, num_edges);
  const bool reg = feat <= kRegFeat, mom = momentum != 0.f;
  cudaError_t err =
      dtype == 1 ? dispatch<__nv_bfloat16>(reg, mom, grid, warps * kTile, smem, s, params, x, y, w, mu_in, out,
                                           mu_out, work, work_mu, partial, cpe, feat, outc, k1, b, lr, momentum,
                                           scale)
                 : dispatch<float>(reg, mom, grid, warps * kTile, smem, s, params, x, y, w, mu_in, out, mu_out,
                                   work, work_mu, partial, cpe, feat, outc, k1, b, lr, momentum, scale);
  if (err != cudaSuccess) return (int)err;
  const int rows = n * k1;
  edge_interval_loss_kernel<<<(rows + 255) / 256, 256, 0, s>>>(partial, losses, rows, ntiles, (float)(b * outc));
  return (int)cudaGetLastError();
}

}  // extern "C"
