// K7 flash attention (forward): softmax attention with causal and/or
// sliding-window masks and an online softmax in f32, as a hand-written
// Hopper kernel.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/flash_attention.py:
//   K7  flash_attention_pallas -> _flash_kernel
// and computes the function of its oracle, attention_ref
// (src/repro/kernels/ref.py): for query position i and key position j,
//     score = (q_i * scale) . k_j          scale = hd^-0.5, f32
// masked where j >= Sk, where j > i if causal, and where i - j >= window if
// window > 0; the running max m, running sum l and accumulator stay in f32;
// out_i = acc / l, and 0 for a row with no visible key (l == 0); the result
// is stored in q's type (f32, or bf16 rounded to nearest even).
//
// Layout. q is (B, Sq, H, hd) and k, v are (B, Sk, Hkv, hd), the model's
// own layout; query head h reads KV head h / (H / Hkv) (GQA / MQA), so the
// repeated K/V are never materialised. The (BH, S, d) contract of
// ops.flash_attention is the case H = Hkv = 1.
//
// What bounds it. On this card the least time is the larger of the bytes
// (q, k, v read once, out written once, at 3.35 TB/s) and the operations
// (4 hd per visible (query, key) pair: the score and the PV product) at the
// tensor cores' rate; at the model's shapes the operations win. This first
// version runs on the CUDA cores in f32 (no TF32, no mma/wgmma, no TMA), so
// it is bounded by the f32 FMA rate and by shared-memory loads; tensor
// cores are a later change.
//
// Design. One CUDA block of 256 threads per (batch, query head, tile of
// 64 query rows). The block walks the key tiles of 64 keys that meet its
// causal/window band (the tiles wholly outside are skipped, as the TPU
// kernel skips them). Per tile, K and V are staged in shared memory in f32
// (rows padded to hd' + 1 floats, hd' = hd rounded up to a power of two >=
// 16, so column reads are conflict-free); thread t owns rows 4 (t / 16) ..
// +3 of the tile, score columns t % 16 + 16 j (j < 4) and head dims
// t % 16 + 16 j (j < hd' / 16). The 16 threads that share a row reduce its
// max and sum by warp shuffles; the probabilities go through shared memory
// to the PV product, whose accumulator (4 x hd'/16 values) stays in
// registers. At hd 256 the tiles take 213,760 bytes of dynamic shared
// memory. Loads beyond Sq, Sk or hd are predicated to 0, never skipped by a
// branch, so the loops unroll.
//
// Interface: a plain C entry point, loaded with ctypes. It launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 256;
constexpr int kPS = kBK + 1;  // row stride of the probability tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(kBQ) * (HDP + 1) + size_t(kBK) * (HDP + 1) + size_t(kBK) * HDP + size_t(kBQ) * kPS);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, int sq, int sk, int h, int hkv, int hd, float scale,
                       int causal, int window) {
  constexpr int QK = HDP + 1;     // row stride of the Q and K tiles
  constexpr int DPT = HDP / 16;   // head dims per thread in the accumulator
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * QK;
  float* vs = ks + kBK * QK;
  float* ps = vs + kBK * HDP;

  const int t = threadIdx.x;
  const int rg = t >> 4;  // rows 4 rg .. 4 rg + 3
  const int cg = t & 15;  // columns / dims cg + 16 j
  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hkv);
  const int64_t q_row = static_cast<int64_t>(h) * hd;
  const int64_t kv_row = static_cast<int64_t>(hkv) * hd;
  const T* qb = q + (static_cast<int64_t>(b) * sq * h + head) * hd;
  const T* kb = k + (static_cast<int64_t>(b) * sk * hkv + kvh) * hd;
  const T* vb = v + (static_cast<int64_t>(b) * sk * hkv + kvh) * hd;
  T* ob = o + (static_cast<int64_t>(b) * sq * h + head) * hd;

  for (int e = t; e < kBQ * HDP; e += kThreads) {
    const int r = e / HDP, d = e % HDP;
    const bool in = q0 + r < sq && d < hd;
    qs[r * QK + d] = in ? to_f32(qb[(q0 + r) * q_row + d]) * scale : 0.f;
  }

  // the key range that meets this tile's band, in whole tiles
  const int q_last = min(sq, q0 + kBQ) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_begin / kBK;
  const int kt_end = (k_end + kBK - 1) / kBK;

  float acc[4][DPT];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int c0 = kt * kBK;
    __syncthreads();  // the last tile's PV product is done with vs and ps (and qs is written)
    for (int e = t; e < kBK * HDP; e += kThreads) {
      const int c = e / HDP, d = e % HDP;
      const bool in = c0 + c < sk && d < hd;
      const int64_t off = (c0 + c) * kv_row + d;
      ks[c * QK + d] = in ? to_f32(kb[off]) : 0.f;
      vs[c * HDP + d] = in ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HDP; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(rg * 4 + i) * QK + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(cg + 16 * j) * QK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = c0 + cg + 16 * j;
        const bool visible = kpos < sk && (!causal || kpos <= qpos) && (window <= 0 || qpos - kpos < window);
        s[i][j] = visible ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // no visible key yet: nothing to add, nothing to rescale
      const bool none = m_new == -INFINITY;
      const float alpha = none ? 1.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (none || s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - m_new);
        ps[(rg * 4 + i) * kPS + cg + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(rg * 4 + i) * kPS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vv = vs[c * HDP + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + rg * 4 + i;
    if (qpos >= sq) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = cg + 16 * j;
      if (d < hd) store(ob + qpos * q_row + d, l[i] > 0.f ? acc[i][j] / l[i] : 0.f);
    }
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk, int h, int hkv, int hd,
           float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  flash_attention_kernel<T, HDP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
      sq, sk, h, hkv, hd, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk, int h, int hkv, int hd,
             float scale, int causal, int window, cudaStream_t stream) {
  if (hd <= 16) return launch<T, 16>(q, k, v, o, b, sq, sk, h, hkv, hd, scale, causal, window, stream);
  if (hd <= 32) return launch<T, 32>(q, k, v, o, b, sq, sk, h, hkv, hd, scale, causal, window, stream);
  if (hd <= 64) return launch<T, 64>(q, k, v, o, b, sq, sk, h, hkv, hd, scale, causal, window, stream);
  if (hd <= 128) return launch<T, 128>(q, k, v, o, b, sq, sk, h, hkv, hd, scale, causal, window, stream);
  if (hd <= 256) return launch<T, 256>(q, k, v, o, b, sq, sk, h, hkv, hd, scale, causal, window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd), o (B, Sq, H, hd), all
// contiguous and of one type: dtype 0 = f32, 1 = bf16. hd <= 256, H a
// multiple of Hkv, B <= 65535, H <= 65535.
int fa_forward(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk, int h, int hkv, int hd,
               float scale, int causal, int window, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || h <= 0 || hkv <= 0 || h % hkv || hd <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, o, b, sq, sk, h, hkv, hd, scale, causal, window, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, o, b, sq, sk, h, hkv, hd, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
