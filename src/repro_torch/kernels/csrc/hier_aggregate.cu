// K1 grouped_mean / K2 segment_mean: the paper's edge/cloud aggregation
// operator (HierFAVG Algorithm 1, lines 25-31) as hand-written Hopper kernels,
// and K6 segment_dequant_mean, the same operator over int8 transport payloads.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/hier_aggregate.py:
//   K1  grouped_mean_pallas -> _agg_kernel      (equal contiguous groups)
//   K2  segment_mean_pallas -> _segment_kernel  (groups from sorted segment ids)
//   K6  segment_dequant_mean_pallas -> _dequant_segment_kernel
//       (K2 over rows decoded on the fly from int8 codes and block scales)
//
// What it computes. x is the stacked (N, D) client parameters of one leaf
// (f32 or bf16 storage), w the (N,) f32 weights with the survival mask
// already folded in. For each group g of rows [start_g, end_g):
//     out[i, d] = sum_j w_j * x[j, d] / sum_j w_j     for every row i of g,
// accumulated in f32 and stored in x's type; a group whose weights sum to
// zero writes its input rows back unchanged, bit for bit.
//
// What bounds it. N is 20-64 and D up to 262,144 on the main path, so the
// operator is a segmented column reduction that reads x once and writes out
// once: 2*N*D*itemsize bytes, with about 3 flops per element. On an H100 SXM
// (3.35 TB/s) that is a memory bound, e.g. 2*32*262144*4 B = 67 MB, about
// 20 us, for the w1 leaf of the full-width MLP (64 -> 4096 -> 10, N = 32).
//
// Design. The TPU form builds a (G, N) one-hot and reduces with matmuls
// (hier_aggregate.py:97-106); here there is no one-hot and no matmul, so no
// TF32 can enter. Each thread owns one column d of one group: it walks the
// group's rows, accumulating sum(w*x) and sum(w) in f32 registers, then
// writes the mean (or the untouched inputs) to the same rows. A warp's 32
// threads read 32 neighbouring columns of a row, so every load and store is
// coalesced; blockIdx.y picks the group. Each element is read once from
// device memory and written once. K1 computes its row range from the
// uniform group size; K2 reads it from an offsets[G+1] table that the
// wrapper builds once per tree level from the sorted ids. Products and sums
// are kept unfused (__fmul_rn/__fadd_rn), so each product rounds as in the
// plain PyTorch version; only the order of the f32 additions may differ.
//
// K6 reads the int8 codes q (N, D) and the f32 block scales (N, D / qblock)
// of the compressed transport's row layout (kernels/quantize.py) instead of
// x, decodes x = q * scale in registers, and writes f32: D bytes a row in,
// 4*D out, so at 32 x 262,144 it moves 8.4 MB + 0.13 MB in and 33.6 MB out,
// 12.6 us at 3.35 TB/s. Its thread layout and offsets table are K2's; a
// group whose weights sum to zero writes its decoded rows, q * scale, which
// is what K5 would write for them, bit for bit.
//
// Interface: plain C entry points, loaded with ctypes. Each launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__device__ __forceinline__ void group_mean_column(const T* __restrict__ x,
                                                  const float* __restrict__ w,
                                                  T* __restrict__ out, int64_t d,
                                                  int64_t col, int start, int end) {
  float num = 0.0f;
  float den = 0.0f;
#pragma unroll 4
  for (int i = start; i < end; ++i) {
    const float wi = w[i];
    num = __fadd_rn(num, __fmul_rn(to_f32(x[i * d + col]), wi));
    den = __fadd_rn(den, wi);
  }
  if (den > 0.0f) {
    const float mean = __fdiv_rn(num, den);
    for (int i = start; i < end; ++i) from_f32(out + i * d + col, mean);
  } else {
    // no survivors: the group keeps its rows exactly
    for (int i = start; i < end; ++i) out[i * d + col] = x[i * d + col];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
grouped_mean_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    T* __restrict__ out, int d, int group_size) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= d) return;
  const int g = blockIdx.y;
  group_mean_column(x, w, out, d, col, g * group_size, (g + 1) * group_size);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_mean_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const int* __restrict__ offsets, T* __restrict__ out, int d) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= d) return;
  const int g = blockIdx.y;
  group_mean_column(x, w, out, d, col, offsets[g], offsets[g + 1]);
}

__global__ void __launch_bounds__(kThreads)
segment_dequant_mean_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                            const float* __restrict__ w, const int* __restrict__ offsets,
                            float* __restrict__ out, int d, int qblock) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= d) return;
  const int g = blockIdx.y;
  const int start = offsets[g], end = offsets[g + 1];
  const int64_t nb = d / qblock;
  const int64_t sb = col / qblock;
  float num = 0.0f;
  float den = 0.0f;
#pragma unroll 4
  for (int i = start; i < end; ++i) {
    const float wi = w[i];
    const float x = __fmul_rn(static_cast<float>(q[i * static_cast<int64_t>(d) + col]), scales[i * nb + sb]);
    num = __fadd_rn(num, __fmul_rn(x, wi));
    den = __fadd_rn(den, wi);
  }
  if (den > 0.0f) {
    const float mean = __fdiv_rn(num, den);
    for (int i = start; i < end; ++i) out[i * static_cast<int64_t>(d) + col] = mean;
  } else {
    // no survivors: the group keeps its decoded rows
    for (int i = start; i < end; ++i) {
      const int64_t at = i * static_cast<int64_t>(d) + col;
      out[at] = __fmul_rn(static_cast<float>(q[at]), scales[i * nb + sb]);
    }
  }
}

dim3 grid_for(int d, int groups) { return dim3((d + kThreads - 1) / kThreads, groups); }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int hier_grouped_mean(const void* x, const void* w, void* out, int n, int d,
                                 int num_groups, int dtype, void* stream) {
  if (num_groups <= 0 || n % num_groups != 0 || d <= 0 || num_groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group_size = n / num_groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(d, num_groups);
  if (dtype == 0) {
    grouped_mean_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), d, group_size);
  } else if (dtype == 1) {
    grouped_mean_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<__nv_bfloat16*>(out), d, group_size);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hier_segment_mean(const void* x, const void* w, const void* offsets, void* out,
                                 int n, int d, int num_segments, int dtype, void* stream) {
  if (num_segments <= 0 || d <= 0 || n <= 0 || num_segments > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(d, num_segments);
  const int* off = static_cast<const int*>(offsets);
  if (dtype == 0) {
    segment_mean_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), off,
        static_cast<float*>(out), d);
  } else if (dtype == 1) {
    segment_mean_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w), off,
        static_cast<__nv_bfloat16*>(out), d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q (n, d) int8, scales (n, d / qblock) f32 -> out (n, d) f32.
extern "C" int hier_segment_dequant_mean(const void* q, const void* scales, const void* w,
                                         const void* offsets, void* out, int n, int d, int qblock,
                                         int num_segments, void* stream) {
  if (num_segments <= 0 || d <= 0 || n <= 0 || num_segments > 65535 || qblock <= 0 ||
      d % qblock != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  segment_dequant_mean_kernel<<<grid_for(d, num_segments), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<const float*>(w), static_cast<const int*>(offsets), static_cast<float*>(out), d,
      qblock);
  return static_cast<int>(cudaGetLastError());
}
