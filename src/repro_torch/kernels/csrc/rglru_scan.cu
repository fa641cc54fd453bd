// K8 RG-LRU scan: the linear recurrence h_t = a_t * h_{t-1} + b_t over the
// sequence, as a hand-written Hopper kernel.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/rglru_scan.py:
//   K8  rglru_scan_pallas -> _rglru_kernel
// and computes the function of its oracle, rglru_scan_ref
// (src/repro/kernels/ref.py): from h0 (B, D), every state h (B, S, D) and
// the last one hT (B, D), in f32, from a and b (B, S, D) in f32 or bf16
// (widened to f32 on use). Every multiply and add is __fmul_rn / __fadd_rn:
// one IEEE rounding each, never a fused multiply-add.
//
// What bounds it. One pass over memory with a few flops per element: a and
// b read once, h written once (f32). At recurrentgemma-9b's prefill, (2,
// 4096, 4096) f32, that is 402.7 MB, 120.2 us at the H100's 3.35 TB/s.
//
// Design: a chunked scan in one pass. The sequence is cut into chunks of
// kChunk = 128 steps (256 ran slower on the H100 at the large shapes). A
// tile is one chunk of one batch
// row and C channels, C = 128 bytes of the input type (32 f32, 64 bf16), one
// thread per channel. Each block:
//   1. takes its tile from an atomic ticket, chunk-major, so every tile it
//      will wait on went to a block that is already running;
//   2. copies the tile's a and b (kChunk rows of 128 bytes each) into shared
//      memory, once, by TMA (a 3-d tensor map over (D, S, B), zeros out of
//      bounds) completing on an mbarrier; where D's rows are not 16-byte
//      multiples or a pointer is unaligned, by element loads instead (at
//      the shape above, with the bases one element off alignment, these
//      take 1.24x TMA's time in f32 and 1.36x in bf16 on an H100 80GB HBM3
//      at 700 W: chip_smoke.py's ms_element_loads);
//   3. walks the chunk in shared memory for its aggregate, the map
//      c -> A c + B: A = a_0, B = b_0, then A = A a_t, B = a_t B + b_t;
//   4. publishes (A, B) to the workspace and raises its tile's flag with
//      release semantics (not for the last chunk, which nobody waits on);
//   5. waits, with acquire semantics, on the flags of every earlier chunk
//      of its (row, channel tile) (one thread per flag, in parallel), then
//      composes its carry from h0 in a fixed order, c = A_j c + B_j for
//      j = 0 .. k-1. A block waits only for aggregates, which every block
//      computes from its own tile, so no chain of hand-offs runs through
//      the chunks; the fixed order makes the bits independent of timing
//      (a decoupled look-back would compose in an order set by timing);
//   6. walks the chunk again from c and writes h (each warp store covers
//      128 contiguous bytes); the last chunk also writes hT = h[:, -1].
// The bits depend on kChunk alone; rglru_scan_plain(..., chunk=kChunk) in
// kernels/rglru_scan.py computes the same order, and the first chunk's walk
// is the sequential loop itself.
// Step 5 reads k aggregates in chunk k, so a row's compose reads
// 8 d n(n-1)/2 bytes for n = S / kChunk chunks: a share of a, b and h that
// grows with S. The aggregates stay in L2 (2 x 32768 x 4096: 16.8 MB);
// with bf16 a and b the compose's reads are 11 % of all the bytes the
// kernel reads and writes at S = 4096 and 50 % at S = 32768, which
// chip_smoke.py's long-prefill case times.
// Tried on the H100 and dropped: persistent blocks holding two stages (the
// next tile's copy in flight during the scan) ran slower, since a
// prefetched ticket holds back its chunk's aggregate for a whole tile; 64-
// or 256-byte rows, a longer unroll and L2 promotion of 256 bytes did not
// move the time.
//
// Interface: plain C entry points, loaded with ctypes. rg_scan launches on
// the given stream, does not synchronise, and returns cudaGetLastError().
// The caller allocates the workspace (rg_scan_header_bytes of ticket and
// flags, zeroed before each launch, then rg_scan_aggregate_bytes of (A, B)
// pairs); the kernel allocates nothing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kRowBytes = 128;  // one tile row: 32 f32 or 64 bf16 channels
constexpr int kChunk = 128;     // steps per chunk: rglru_scan.CHUNK

template <typename E>
struct Tile {
  static constexpr int kC = kRowBytes / static_cast<int>(sizeof(E));  // channels = threads
};

// the tile's a and b, the mbarrier, and room to align the base to 128 bytes
constexpr int kSmemBytes = 2 * kChunk * kRowBytes + 16 + 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename E> __device__ __forceinline__ E zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16_rn(0.f); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
// One TMA box (C channels x kChunk steps of one row) of a 3-d map (D, S, B).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int ch, int t, int row) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(ch), "r"(t), "r"(row), "r"(bar)
      : "memory");
}
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// work: [0] the ticket, [1 + (row * chunks + k) * ctiles + ct] tile flags;
// agg[(row * chunks + k) * d + ch] = (A, B) of chunk k at channel ch.
template <typename E>
__global__ void __launch_bounds__(Tile<E>::kC)
rglru_chunked_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                     const E* __restrict__ a, const E* __restrict__ b, const float* __restrict__ h0,
                     float* __restrict__ h, float* __restrict__ h_last, unsigned* __restrict__ work,
                     float2* __restrict__ agg, int rows, int s, int d, int chunks, int ctiles, int tma) {
  constexpr int C = Tile<E>::kC, T = kChunk;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int tile_s;
  uint8_t* base = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  E* sa = reinterpret_cast<E*>(base);
  E* sb = reinterpret_cast<E*>(base + T * kRowBytes);
  const uint32_t bar = smem_u32(base + 2 * T * kRowBytes);
  const int tid = threadIdx.x;

  if (tid == 0) {
    tile_s = static_cast<int>(atomicAdd(work, 1u));
    if (tma) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __syncthreads();
  const int tile = tile_s;
  const int per_chunk = rows * ctiles;
  const int k = tile / per_chunk;
  const int row = (tile - k * per_chunk) / ctiles;
  const int ct = tile - k * per_chunk - row * ctiles;
  const int ch = ct * C + tid;
  const int t0 = k * T;
  const int len = min(T, s - t0);
  const bool live = ch < d;

  if (tma) {
    if (tid == 0) {
      mbar_expect(bar, 2 * T * kRowBytes);
      tma_load(smem_u32(sa), &map_a, bar, ct * C, t0, row);
      tma_load(smem_u32(sb), &map_b, bar, ct * C, t0, row);
    }
    mbar_wait(bar, 0);
  } else {  // each thread fills, and later reads, its own column only
    const int64_t g = (static_cast<int64_t>(row) * s + t0) * d + ch;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const bool in = live && t < len;
      sa[t * C + tid] = in ? a[g + static_cast<int64_t>(t) * d] : zero<E>();
      sb[t * C + tid] = in ? b[g + static_cast<int64_t>(t) * d] : zero<E>();
    }
  }

  // 3. the chunk's aggregate
  float agg_a = to_f32(sa[tid]), agg_b = to_f32(sb[tid]);
#pragma unroll 16
  for (int t = 1; t < T; ++t) {
    if (t < len) {
      const float at = to_f32(sa[t * C + tid]);
      agg_a = __fmul_rn(agg_a, at);
      agg_b = __fadd_rn(__fmul_rn(at, agg_b), to_f32(sb[t * C + tid]));
    }
  }

  // 4. publish it
  unsigned* flags = work + 1;
  const int64_t rc = static_cast<int64_t>(row) * chunks;
  if (k + 1 < chunks) {
    if (live) agg[(rc + k) * d + ch] = make_float2(agg_a, agg_b);
    __threadfence();
    __syncthreads();
    if (tid == 0) st_release(flags + (rc + k) * ctiles + ct, 1u);
  }

  // 5. the carry, composed from h0 in chunk order
  float c = live ? h0[static_cast<int64_t>(row) * d + ch] : 0.f;
  if (k > 0) {
    for (int j = tid; j < k; j += C) {
      const unsigned* f = flags + (rc + j) * ctiles + ct;
      while (ld_acquire(f) == 0u) __nanosleep(64);
    }
    __threadfence();
    __syncthreads();
    if (live) {
      const float2* g = agg + rc * d + ch;
#pragma unroll 8
      for (int j = 0; j < k; ++j) {
        const float2 v = __ldcg(g + static_cast<int64_t>(j) * d);
        c = __fadd_rn(__fmul_rn(v.x, c), v.y);
      }
    }
  }

  // 6. walk again from the carry and write h
  float* hr = h + (static_cast<int64_t>(row) * s + t0) * d + ch;
#pragma unroll 16
  for (int t = 0; t < T; ++t) {
    if (t < len) {
      c = __fadd_rn(__fmul_rn(to_f32(sa[t * C + tid]), c), to_f32(sb[t * C + tid]));
      if (live) hr[static_cast<int64_t>(t) * d] = c;
    }
  }
  if (k + 1 == chunks && live) h_last[static_cast<int64_t>(row) * d + ch] = c;
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

// A map of a contiguous (rows, s, d) tensor: boxes of C channels x kChunk
// steps of one row, no swizzle, zeros out of bounds.
template <typename E>
int tensor_map(CUtensorMap* map, const void* ptr, int rows, int s, int d) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t isz = sizeof(E);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {isz * d, isz * d * s};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(Tile<E>::kC), static_cast<cuuint32_t>(kChunk), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUtensorMapDataType type = sizeof(E) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int64_t header_bytes(int64_t rows, int64_t chunks, int64_t ctiles) {
  return (4 * (1 + rows * chunks * ctiles) + 15) / 16 * 16;
}

template <typename E>
int launch(const void* a, const void* b, const void* h0, void* h, void* h_last, void* work, int rows, int s, int d,
           cudaStream_t stream) {
  constexpr int C = Tile<E>::kC;
  const int chunks = (s + kChunk - 1) / kChunk, ctiles = (d + C - 1) / C;
  const int64_t tiles = static_cast<int64_t>(rows) * chunks * ctiles;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(rglru_chunked_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  const int tma = (static_cast<int64_t>(d) * sizeof(E)) % 16 == 0 && addr % 16 == 0;  // TMA's strides and bases
  CUtensorMap ma, mb;
  memset(&ma, 0, sizeof(ma));
  memset(&mb, 0, sizeof(mb));
  if (tma) {
    int e = tensor_map<E>(&ma, a, rows, s, d);
    if (e == 0) e = tensor_map<E>(&mb, b, rows, s, d);
    if (e != 0) return e;
  }
  unsigned* w = static_cast<unsigned*>(work);
  float2* agg = reinterpret_cast<float2*>(static_cast<uint8_t*>(work) + header_bytes(rows, chunks, ctiles));
  rglru_chunked_kernel<E><<<static_cast<unsigned>(tiles), C, kSmemBytes, stream>>>(
      ma, mb, static_cast<const E*>(a), static_cast<const E*>(b), static_cast<const float*>(h0),
      static_cast<float*>(h), static_cast<float*>(h_last), w, agg, rows, s, d, chunks, ctiles, tma);
  return static_cast<int>(cudaGetLastError());
}

int channels(int dtype) { return dtype == 0 ? Tile<float>::kC : Tile<__nv_bfloat16>::kC; }

}  // namespace

extern "C" {

// Bytes of the workspace's head (ticket and flags), which the caller zeroes
// before every launch; -1 for arguments rg_scan refuses.
long long rg_scan_header_bytes(int rows, int s, int d, int dtype) {
  if (rows <= 0 || s <= 0 || d <= 0 || (dtype != 0 && dtype != 1)) return -1;
  const int64_t chunks = (s + kChunk - 1) / kChunk, ctiles = (d + channels(dtype) - 1) / channels(dtype);
  return header_bytes(rows, chunks, ctiles);
}

// Bytes of the (A, B) pairs that follow the head.
long long rg_scan_aggregate_bytes(int rows, int s, int d) {
  if (rows <= 0 || s <= 0 || d <= 0) return -1;
  return 8ll * rows * ((s + kChunk - 1) / kChunk) * d;
}

// a, b (B, S, D) of one type (dtype 0 = f32, 1 = bf16); h0 (B, D) f32;
// h (B, S, D) and h_last (B, D) f32; all contiguous. work: the workspace
// above, its head zeroed.
int rg_scan(const void* a, const void* b, const void* h0, void* h, void* h_last, void* work, int rows, int s, int d,
            int dtype, void* stream) {
  if (rows <= 0 || s <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h0, h, h_last, work, rows, s, d, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, h0, h, h_last, work, rows, s, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
