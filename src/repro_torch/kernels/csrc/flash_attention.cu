// K7 flash attention (forward): softmax attention with causal and/or
// sliding-window masks and an online softmax in f32, as a hand-written
// Hopper kernel in two templates, one per dtype (dispatched in fa_forward).
//
// Replaces the Pallas TPU kernel in src/repro/kernels/flash_attention.py:
//   K7  flash_attention_pallas -> _flash_kernel
// and computes the function of its oracle, attention_ref
// (src/repro/kernels/ref.py): for query position i and key position j,
//     score = q_i . k_j * scale            scale = hd^-0.5, f32
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
// (4 hd per visible (query, key) pair: the score and the PV product). At
// the main path's shapes the operations win: in bf16 at the tensor cores'
// 989 TFLOP/s (recurrentgemma-9b's prefill, 2 x 4096, MQA 16 on 1, hd 256,
// window 2048: 2.06e11 operations, 0.21 ms), in f32 at the CUDA cores' 67
// TFLOP/s (f32 parity admits no TF32).
//
// bf16: the tensor-core template (tc::flash_attention_wgmma), built to
// approach the bf16 bound. One block of three warpgroups (384 threads) per
// (128 query rows, query head, batch): two consumer warpgroups own 64 of
// the rows each; one warp of the producer warpgroup feeds them.
// - Products: S = Q K^T and O += P V are wgmma instructions (m64n64k16,
//   bf16 operands, f32 accumulators in registers). QK^T reads Q and K from
//   shared memory, both K-major; PV takes P from registers and V from
//   shared memory as the MN-major (transposed) operand. P's A fragments are
//   S's accumulator fragments packed pair by pair into bf16x2: the two
//   layouts coincide, so P never touches shared memory.
// - Copies: TMA. The producer loads Q once and streams K and V through a
//   ring of stages (2 at hd' 256, 3 below) in shared memory: mbarriers
//   full_k / full_v (the tile landed) and empty (all 8 consumer warps are
//   done with the stage) per stage, so the copies of the next tiles run
//   under the products of this one. Boxes of 64 columns x 64 (or 128)
//   rows with the 128-byte swizzle that the wgmma descriptors name; rows
//   past Sk or Sq and columns past hd arrive as zeros (hd' = 64, 128 or
//   256: the head dim padded). Where hd is no multiple of 8 or a pointer
//   is not 16-byte aligned (TMA takes neither), the producer warp loads
//   elements into the same layout instead.
// - Overlap: the consumer warpgroups take turns to issue QK^T (named
//   barriers 1 and 2), so one warpgroup's softmax runs while the other's
//   products hold the tensor cores. setmaxnreg moves registers to the
//   consumers (232 a thread) from the producer (40): the O accumulator is
//   128 of them at hd' 256. Shared memory: Q 128 x hd', K and V 64 x hd'
//   per stage: 197,688 bytes at hd' 256, one block per SM.
// - Masks: key tiles outside the block's causal/window band are never
//   loaded, and a warpgroup skips the products of tiles outside its own
//   rows' band. The elementwise mask runs only on tiles that cross the
//   diagonal, the window's edge or Sk. A row with no visible key yet takes
//   its exponents against 0, so every p and every rescale is exp2(-inf) =
//   0: no masked entry counts, and l = 0 gives 0.
// - Softmax in f32: hd^-0.5 multiplies the f32 scores (folded with log2 e
//   into the FMA before exp2), not bf16 Q. P is rounded to bf16 once, for
//   the PV product, and l sums the rounded P, as the model's layer code
//   does (models/layers.chunked_causal_attention). Against the f32 oracle
//   the normalised weights then differ by at most 2^-7 / (1 - 2^-8) of
//   themselves, and an output element by as much of sum_j w_j |v_j| (the
//   attention over |v|), plus the final rounding to bf16.
// - No atomics and no split over keys: a relaunch is bit-equal.
//
// f32: the CUDA-core template (flash_attention_kernel). One CUDA block of
// 256 threads per (batch, query head, tile of 64 query rows). The block
// walks the key tiles of 64 keys that meet its causal/window band (the
// tiles wholly outside are skipped, as the TPU kernel skips them). Q is
// staged once in f32, times the scale. Per tile, K and V are staged in
// shared memory in f32 (rows padded to hd' + 1 floats, hd' = hd rounded up
// to a power of two >= 16, so column reads are conflict-free); thread t
// owns rows 4 (t / 16) .. +3 of the tile, score columns t % 16 + 16 j
// (j < 4) and head dims t % 16 + 16 j (j < hd' / 16). The 16 threads that
// share a row reduce its max and sum by warp shuffles; the probabilities go
// through shared memory to the PV product, whose accumulator (4 x hd'/16
// values) stays in registers. At hd 256 the tiles take 213,760 bytes of
// dynamic shared memory. Loads beyond Sq, Sk or hd are predicated to 0,
// never skipped by a branch, so the loops unroll.
//
// Interface: a plain C entry point, loaded with ctypes. It launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

// ---- f32: the CUDA-core template ---------------------------------------------

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 256;
constexpr int kPS = kBK + 1;  // row stride of the probability tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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


// ---- bf16: the tensor-core template ------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kConsumers = 2;                    // warpgroups that compute
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 128;  // and a producer warpgroup (one warp of it loads)
// registers a thread, set by setmaxnreg: 2 x 128 x 232 + 128 x 40 = 64,512 of the SM's 65,536
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kRows = 64 * kConsumers;           // query rows per block
constexpr int kKeys = 64;                        // keys per tile
constexpr float kLog2e = 1.4426950408889634f;

// Dynamic shared memory: Q, then kStages K tiles, then kStages V tiles,
// then the barriers (full_q; full_k, full_v and empty per stage).
template <int HDP>
struct Smem {
  static constexpr int kStages = HDP > 128 ? 2 : 3;
  static constexpr int kQ = kRows * HDP * 2;     // bytes of the Q tile
  static constexpr int kTile = kKeys * HDP * 2;  // bytes of one K or V tile
  static constexpr int kBars = kQ + 2 * kStages * kTile;
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;  // + room to align the base to 1024
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers in shared memory
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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

// Named barriers between the two consumer warpgroups (id 0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumerThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumerThreads) : "memory");
}

// One TMA box (64 columns x rows of the map's box) of a 4-d map (hd, heads,
// seq, batch) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int col, int head,
                                         int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row), "r"(b), "r"(bar)
      : "memory");
}

// The tile's ROWS rows x HDP columns by TMA: one box per 64-column block.
template <int ROWS, int HDP>
__device__ __forceinline__ void tma_tile(uint32_t tile, const CUtensorMap* map, uint32_t bar, int head, int row0,
                                         int b) {
#pragma unroll
  for (int c = 0; c < HDP / 64; ++c) tma_load(tile + c * ROWS * 128, map, bar, 64 * c, head, row0, b);
}

// Byte offset of the 16-byte chunk c (columns 8c .. 8c + 7) of row r in a
// tile of `rows` rows: 64-column blocks of rows x 128 bytes, each row's
// eight chunks permuted by the 128-byte swizzle (as TMA writes them).
__device__ __forceinline__ uint32_t chunk_offset(int r, int c, int rows) {
  return static_cast<uint32_t>((c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// The same tile by the producer warp's element loads, for a head dim that is
// no multiple of 8 or a pointer that is not 16-byte aligned (TMA takes
// neither): zeros past `valid` rows and past hd columns.
template <int ROWS, int HDP>
__device__ __forceinline__ void load_elements(uint8_t* tile, const bf16* g, int64_t ld, int valid, int hd,
                                              int lane) {
  constexpr int kChunks = HDP / 8;
  const unsigned short* g16 = reinterpret_cast<const unsigned short*>(g);
#pragma unroll 1
  for (int e = lane; e < ROWS * kChunks; e += 32) {
    const int r = e / kChunks, c = e % kChunks;
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c * 8 + 2 * j;
      const uint32_t lo = r < valid && col < hd ? g16[r * ld + col] : 0u;
      const uint32_t hi = r < valid && col + 1 < hd ? g16[r * ld + col + 1] : 0u;
      w[j] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(tile + chunk_offset(r, c, ROWS)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// the producer warp's element stores made visible to wgmma, then `bar` arrives
__device__ __forceinline__ void publish(uint32_t bar, int lane) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keep the compiler from moving reads or writes of wgmma's registers across
// the fence, commit and wait above.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// A shared-memory matrix descriptor: start address, leading byte offset
// `lbo` (MN-major: from one 64-column block to the next; K-major with this
// swizzle: unused, 16 by convention), stride byte offset 1024 (from one
// group of 8 rows of 128 bytes to the next), 128-byte swizzle.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 64, f32) = a (64 x 16) b (16 x 64) [+ d if accumulate]: a and b
// bf16 in shared memory, both K-major (b is 64 rows of 16).
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate)
      : "memory");
}

// d (64 x 64, f32) += a (64 x 16) b (16 x 64): a bf16 in registers (the
// warpgroup's A fragments), b bf16 in shared memory, MN-major (16 rows of
// 64 contiguous columns).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) { return *reinterpret_cast<uint32_t*>(&x); }

// out[col], out[col + 1] of one row, the columns < hd
__device__ __forceinline__ void store_pair(bf16* row, int col, int hd, float x, float y) {
  if ((hd & 1) == 0) {
    if (col < hd) *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(x, y);
  } else {
    if (col < hd) row[col] = __float2bfloat16_rn(x);
    if (col + 1 < hd) row[col + 1] = __float2bfloat16_rn(y);
  }
}

// S = Q K^T for this warpgroup's 64 rows and one key tile (issued, not
// waited for): 16 columns of the head dim per wgmma, block kk / 4, 32 bytes
// into its rows.
template <int HDP>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t q_tile, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t within = (kk & 3) * 32;
    mma_ss(s, descriptor(q_tile + (kk >> 2) * (kRows * 128) + within, 16),
           descriptor(k_tile + (kk >> 2) * (kKeys * 128) + within, 16), kk > 0);
  }
}

// O += P V (issued, not waited for): 16 keys per wgmma, one per 64-column
// block of the head dim.
template <int NB>
__device__ __forceinline__ void issue_pv(float (&acc)[NB][32], const uint32_t (&p)[4][4], uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
    for (int c = 0; c < NB; ++c)
      mma_rs(acc[c], p[kk], descriptor(v_tile + c * (kKeys * 128) + kk * 16 * 128, kKeys * 128));
}

// The online softmax of one tile's scores s, in f32, for the thread's rows
// ra and rb: mask (only where `edge`), the running max m (raw scores), the
// rescale of O and of this thread's share of l, and P rounded to bf16 once
// as the PV product's A fragments (keys 16 kk .. 16 kk + 15 in p[kk]); l
// sums the rounded values.
template <int NB>
__device__ __forceinline__ void softmax(float (&s)[32], uint32_t (&p)[4][4], float (&acc)[NB][32], float& m_a,
                                        float& m_b, float& l_a, float& l_b, bool edge, int c0, int ra, int rb,
                                        int cpair, int sk, int causal, int window, float scale_log2e) {
  // s[4 j + e]: row (e < 2 ? ra : rb), key c0 + 8 j + cpair + (e & 1)
  if (edge) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = c0 + 8 * j + cpair + (e & 1);
        const int qpos = e < 2 ? ra : rb;
        const bool visible = kpos < sk && (!causal || kpos <= qpos) && (window <= 0 || qpos - kpos < window);
        if (!visible) s[4 * j + e] = -INFINITY;
      }
  }
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {  // the four threads of a row
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
  // exponents are (score - max) * scale * log2 e; a row with no visible key
  // yet takes them against 0, so its p and alpha are all 0
  const float base_a = mn_a == -INFINITY ? 0.f : mn_a * scale_log2e;
  const float base_b = mn_b == -INFINITY ? 0.f : mn_b * scale_log2e;
  const float alpha_a = exp2f(m_a * scale_log2e - base_a);
  const float alpha_b = exp2f(m_b * scale_log2e - base_b);
  m_a = mn_a;
  m_b = mn_b;
  float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const __nv_bfloat162 top = __floats2bfloat162_rn(exp2f(fmaf(s[4 * j], scale_log2e, -base_a)),
                                                     exp2f(fmaf(s[4 * j + 1], scale_log2e, -base_a)));
    const __nv_bfloat162 bot = __floats2bfloat162_rn(exp2f(fmaf(s[4 * j + 2], scale_log2e, -base_b)),
                                                     exp2f(fmaf(s[4 * j + 3], scale_log2e, -base_b)));
    const float2 tf = __bfloat1622float2(top), bf = __bfloat1622float2(bot);
    rs_a += tf.x + tf.y;
    rs_b += bf.x + bf.y;
    p[j >> 1][(j & 1) * 2] = bits(top);
    p[j >> 1][(j & 1) * 2 + 1] = bits(bot);
  }
  l_a = l_a * alpha_a + rs_a;
  l_b = l_b * alpha_b + rs_b;
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[c][4 * j] *= alpha_a;
      acc[c][4 * j + 1] *= alpha_a;
      acc[c][4 * j + 2] *= alpha_b;
      acc[c][4 * j + 3] *= alpha_b;
    }
}

template <int NB>
__device__ __forceinline__ void fence_all(float (&acc)[NB][32]) {
#pragma unroll
  for (int c = 0; c < NB; ++c) fence_regs(acc[c]);
}
__device__ __forceinline__ void fence_all(uint32_t (&p)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_regs(p[kk]);
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const bf16* __restrict__ q,
                      const bf16* __restrict__ k, const bf16* __restrict__ v, bf16* __restrict__ o, int sq, int sk,
                      int h, int hkv, int hd, float scale_log2e, int causal, int window, int tma) {
  using S = Smem<HDP>;
  constexpr int kStages = S::kStages;
  constexpr int kBlocks = HDP / 64;  // 64-column blocks of the head dim
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + S::kQ;                // K stage s at ks + s * kTile
  uint8_t* vs = ks + kStages * S::kTile;   // V stage s at vs + s * kTile
  const uint32_t qs_a = smem_u32(qs), ks_a = smem_u32(ks), vs_a = smem_u32(vs);
  const uint32_t full_q = qs_a + S::kBars;  // full_k(s), full_v(s), empty(s) follow
  auto full_k = [&](int s) { return full_q + 8 * (1 + s); };
  auto full_v = [&](int s) { return full_q + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return full_q + 8 * (1 + 2 * kStages + s); };

  // warp-uniform as the compiler sees them (broadcast from lane 0)
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // the longest key ranges start first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hkv);
  const int64_t q_row = static_cast<int64_t>(h) * hd;
  const int64_t kv_row = static_cast<int64_t>(hkv) * hd;

  // the key range that meets the block's band, in whole tiles
  const int q_last = min(sq, q0 + kRows) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_begin / kKeys;
  const int n_tiles = max(0, (k_end + kKeys - 1) / kKeys - kt_begin);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 4 * kConsumers);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {  // the producer warpgroup: its first warp loads Q once, then K and V
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp > 4 * kConsumers) return;
    if (tma) {
      if (lane == 0) {
        mbar_expect(full_q, S::kQ);
        tma_tile<kRows, HDP>(qs_a, &tm_q, full_q, head, q0, b);
        for (int it = 0; it < n_tiles; ++it) {
          const int s = it % kStages, key0 = (kt_begin + it) * kKeys;
          if (it >= kStages) mbar_wait(empty(s), (it / kStages - 1) & 1);
          mbar_expect(full_k(s), S::kTile);
          tma_tile<kKeys, HDP>(ks_a + s * S::kTile, &tm_k, full_k(s), kvh, key0, b);
          mbar_expect(full_v(s), S::kTile);
          tma_tile<kKeys, HDP>(vs_a + s * S::kTile, &tm_v, full_v(s), kvh, key0, b);
        }
      }
    } else {
      const bf16* qb = q + (static_cast<int64_t>(b) * sq * h + head) * hd;
      const bf16* kb = k + (static_cast<int64_t>(b) * sk * hkv + kvh) * hd;
      const bf16* vb = v + (static_cast<int64_t>(b) * sk * hkv + kvh) * hd;
      load_elements<kRows, HDP>(qs, qb + q0 * q_row, q_row, sq - q0, hd, lane);
      publish(full_q, lane);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages, key0 = (kt_begin + it) * kKeys;
        if (it >= kStages) mbar_wait(empty(s), (it / kStages - 1) & 1);
        load_elements<kKeys, HDP>(ks + s * S::kTile, kb + key0 * kv_row, kv_row, sk - key0, hd, lane);
        publish(full_k(s), lane);
        load_elements<kKeys, HDP>(vs + s * S::kTile, vb + key0 * kv_row, kv_row, sk - key0, hd, lane);
        publish(full_v(s), lane);
      }
    }
    return;
  }

  // a consumer warpgroup: rows r0 .. r0 + 63 and the keys they see
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2;
  const int r0 = q0 + 64 * wg;
  const bool live = r0 < sq;
  const int w_end = causal ? min(sk, min(sq, r0 + 64)) : sk;
  const int w_begin = window > 0 ? max(0, r0 - window + 1) : 0;
  // the thread's two rows of the accumulator fragments, and its column pair
  const int ra = r0 + (warp & 3) * 16 + (lane >> 2), rb = ra + 8;
  const int cpair = 2 * (lane & 3);
  const uint32_t q_tile = qs_a + wg * (64 * 128);  // this warpgroup's rows of each column block

  float acc[kBlocks][32];
#pragma unroll
  for (int c = 0; c < kBlocks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY;  // running max of the raw scores, rows ra and rb
  float l_a = 0.f, l_b = 0.f;              // this thread's share of the running sums

  // Ping-pong: a warpgroup issues its QK^T only after the other issued its
  // own for the last tile (named barriers 1 and 2), so one warpgroup's
  // softmax runs while the other's products hold the tensor cores.
  // Warpgroup 0 goes first.
  if (wg == 1 && n_tiles > 0) bar_arrive(1);
  mbar_wait(full_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages, phase = (it / kStages) & 1;
    const int c0 = (kt_begin + it) * kKeys;
    // uniform across the warpgroup: this tile meets its rows' band; it
    // needs the elementwise mask (crosses the diagonal, the window's edge
    // or Sk)
    const bool run = live && c0 < w_end && c0 + kKeys > w_begin;
    const bool edge = c0 + kKeys > sk || (causal && c0 + kKeys - 1 > r0) || (window > 0 && r0 + 63 - c0 >= window);
    float sc[32];
    uint32_t p[4][4];
    const bool pass = wg == 0 || it + 1 < n_tiles;  // the other warpgroup issues next
    mbar_wait(full_k(s), phase);
    bar_sync(1 + wg);
    if (run) {
      wgmma_fence();
      issue_qk<HDP>(sc, q_tile, ks_a + s * S::kTile);
      wgmma_commit();
      if (pass) bar_arrive(2 - wg);
      wgmma_wait();
      fence_regs(sc);
      softmax(sc, p, acc, m_a, m_b, l_a, l_b, edge, c0, ra, rb, cpair, sk, causal, window, scale_log2e);
      mbar_wait(full_v(s), phase);
      fence_all(acc);
      fence_all(p);
      wgmma_fence();
      issue_pv(acc, p, vs_a + s * S::kTile);
      wgmma_commit();
      wgmma_wait();
      fence_all(acc);
    } else if (pass) {
      bar_arrive(2 - wg);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));  // this warp is done with the stage
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  bf16* ob = o + (static_cast<int64_t>(b) * sq * h + head) * hd;
#pragma unroll
  for (int c = 0; c < kBlocks; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c * 64 + 8 * j + cpair;
      if (ra < sq)
        store_pair(ob + ra * q_row, col, hd, l_a > 0.f ? acc[c][4 * j] / l_a : 0.f,
                   l_a > 0.f ? acc[c][4 * j + 1] / l_a : 0.f);
      if (rb < sq)
        store_pair(ob + rb * q_row, col, hd, l_b > 0.f ? acc[c][4 * j + 2] / l_b : 0.f,
                   l_b > 0.f ? acc[c][4 * j + 3] / l_b : 0.f);
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

// A map of a contiguous (batch, seq, heads, hd) bf16 tensor: boxes of 64
// columns x box_rows rows of one head, 128-byte swizzle, zeros out of bounds.
int tensor_map(CUtensorMap* map, const void* base, int hd, int heads, int seq, int batch, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {2ull * hd, 2ull * hd * heads, 2ull * hd * heads * seq};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk, int h, int hkv, int hd,
           float scale, int causal, int window, cudaStream_t stream) {
  constexpr int bytes = Smem<HDP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_wgmma<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const int tma = hd % 8 == 0 && addr % 16 == 0;  // TMA wants 16-byte strides and bases
  CUtensorMap mq, mk, mv;
  memset(&mq, 0, sizeof(mq));
  memset(&mk, 0, sizeof(mk));
  memset(&mv, 0, sizeof(mv));
  if (tma) {
    int e = tensor_map(&mq, q, hd, h, sq, b, kRows);
    if (e == 0) e = tensor_map(&mk, k, hd, hkv, sk, b, kKeys);
    if (e == 0) e = tensor_map(&mv, v, hd, hkv, sk, b, kKeys);
    if (e != 0) return e;
  }
  dim3 grid((sq + kRows - 1) / kRows, h, b);
  flash_attention_wgmma<HDP><<<grid, kThreads, bytes, stream>>>(
      mq, mk, mv, static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), sq, sk, h, hkv, hd, scale * kLog2e, causal, window, tma);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk, int h, int hkv, int hd,
             float scale, int causal, int window, cudaStream_t stream) {
  if (hd <= 64) return launch<64>(q, k, v, o, b, sq, sk, h, hkv, hd, scale, causal, window, stream);
  if (hd <= 128) return launch<128>(q, k, v, o, b, sq, sk, h, hkv, hd, scale, causal, window, stream);
  if (hd <= 256) return launch<256>(q, k, v, o, b, sq, sk, h, hkv, hd, scale, causal, window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc


}  // namespace

extern "C" {

// q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd), o (B, Sq, H, hd), all
// contiguous and of one type: dtype 0 = f32 (the CUDA-core template), 1 =
// bf16 (the tensor-core template). hd <= 256, H a multiple of Hkv,
// B <= 65535, H <= 65535.
int fa_forward(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk, int h, int hkv, int hd,
               float scale, int causal, int window, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || h <= 0 || hkv <= 0 || h % hkv || hd <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, o, b, sq, sk, h, hkv, hd, scale, causal, window, s);
  if (dtype == 1) return tc::dispatch(q, k, v, o, b, sq, sk, h, hkv, hd, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
