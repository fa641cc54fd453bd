// K4 quantize / K5 dequantize: the blockwise-absmax int8 codec of the
// compressed transport (fed/transport.py) as hand-written Hopper kernels.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/quantize.py:
//   K4  quantize_pallas / quantize_stacked_pallas -> _quant_kernel
//   K5  dequantize_pallas                         -> _dequant_kernel
//
// What it computes. The input is viewed as rows (N, D): one row per client
// for the stacked transport layout, or a single row holding a whole
// flattened tensor. Each row is cut into nb = ceil(D / qblock) blocks of
// qblock values; a row's last block is padded with zeros, so no block
// crosses a row (a client boundary). Per block:
//     scale = absmax / 127                   (f32; an all-zero block: 0)
//     q     = clip(rint(x / safe), -127, 127) safe = scale if scale > 0 else 1
// with q written as int8 into (N, Dp = nb * qblock) and scale into (N, nb).
// rint rounds half to even, as jnp.round does, and both divisions are IEEE
// (__fdiv_rn: never a multiply by a reciprocal), so the codes and scales
// are bit-equal to the plain version's. bf16 input is widened to f32 first.
// K5 is the inverse: out[r, c] = q[r, c] * scale[r, c / qblock] for c < D,
// stored in the output's type (f32, or bf16 rounded to nearest even).
//
// What bounds it. Both are single passes over memory with a few flops per
// element: K4 reads 4 (f32) or 2 (bf16) bytes and writes 1 byte per value
// plus 4 bytes per block; K5 the reverse. At the full-width MLP's w1 leaf
// (32 x 262,144 f32) that is 33.6 MB + 8.4 MB + 0.13 MB, 12.6 us at the
// H100's 3.35 TB/s.
//
// Design. K4: one warp per quantization block, eight blocks per 256-thread
// CUDA block. The warp's lanes stride over the block's values (coalesced
// reads), reduce |x| by shuffles, and lane 0 writes the scale; a second
// stride over the same values (now in L1/L2) writes the codes. Pad lanes
// are read as 0 in the kernel, so no padded copy of the input exists. K5:
// one thread per output element of a row (blockIdx.y picks the row), so a
// warp reads 32 neighbouring int8 codes and writes 32 neighbouring values.
//
// Interface: plain C entry points, loaded with ctypes. Each launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s,
                int64_t num_blocks, int d, int nb, int qblock) {
  const int lane = threadIdx.x & 31;
  const int64_t blk = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (blk >= num_blocks) return;  // whole warps leave together
  const int64_t row = blk / nb;
  const int64_t col0 = (blk - row * nb) * static_cast<int64_t>(qblock);
  const T* xr = x + row * d;
  float amax = 0.0f;
  for (int j = lane; j < qblock; j += 32) {
    const int64_t col = col0 + j;
    const float v = col < d ? to_f32(xr[col]) : 0.0f;
    amax = fmaxf(amax, fabsf(v));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = __fdiv_rn(amax, 127.0f);
  const float safe = scale > 0.0f ? scale : 1.0f;
  if (lane == 0) s[blk] = scale;
  int8_t* qr = q + row * static_cast<int64_t>(nb) * qblock;
  for (int j = lane; j < qblock; j += 32) {
    const int64_t col = col0 + j;
    const float v = col < d ? to_f32(xr[col]) : 0.0f;
    const float c = fminf(fmaxf(rintf(__fdiv_rn(v, safe)), -127.0f), 127.0f);
    qr[col] = static_cast<int8_t>(c);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ s, T* __restrict__ out,
                  int dp, int d, int qblock) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= d) return;
  const int64_t row = blockIdx.y;
  const int nb = dp / qblock;
  const float v = __fmul_rn(static_cast<float>(q[row * dp + col]), s[row * nb + col / qblock]);
  store(out + row * d + col, v);
}

}  // namespace

// x (rows, d) -> q (rows, dp) int8, s (rows, dp / qblock) f32, dp = d padded
// to a qblock multiple. dtype of x: 0 = float32, 1 = bfloat16.
extern "C" int quant_quantize(const void* x, void* q, void* s, int rows, int d, int dp,
                              int qblock, int dtype, void* stream) {
  if (rows <= 0 || d <= 0 || qblock <= 0 || dp % qblock != 0 || dp < d || dp - d >= qblock)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = dp / qblock;
  const int64_t num_blocks = static_cast<int64_t>(rows) * nb;
  const int64_t grid = (num_blocks + kWarps - 1) / kWarps;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    quantize_kernel<float><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q), static_cast<float*>(s),
        num_blocks, d, nb, qblock);
  } else if (dtype == 1) {
    quantize_kernel<__nv_bfloat16><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q), static_cast<float*>(s),
        num_blocks, d, nb, qblock);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q (rows, dp) int8, s (rows, dp / qblock) f32 -> out (rows, d), d <= dp.
// dtype of out: 0 = float32, 1 = bfloat16.
extern "C" int quant_dequantize(const void* q, const void* s, void* out, int rows, int dp, int d,
                                int qblock, int dtype, void* stream) {
  if (rows <= 0 || rows > 65535 || d <= 0 || qblock <= 0 || dp % qblock != 0 || d > dp)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((d + kThreads - 1) / kThreads, rows);
  if (dtype == 0) {
    dequantize_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(s), static_cast<float*>(out),
        dp, d, qblock);
  } else if (dtype == 1) {
    dequantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(s),
        static_cast<__nv_bfloat16*>(out), dp, d, qblock);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
