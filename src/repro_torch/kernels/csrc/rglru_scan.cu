// K8 RG-LRU scan: the linear recurrence h_t = a_t * h_{t-1} + b_t over the
// sequence, as a hand-written Hopper kernel.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/rglru_scan.py:
//   K8  rglru_scan_pallas -> _rglru_kernel
// and computes the function of its oracle, rglru_scan_ref
// (src/repro/kernels/ref.py): from h0 (B, D), every state h (B, S, D) and
// the last one hT (B, D), in f32, from a and b (B, S, D) in f32 or bf16
// (widened to f32 on load). Each step is __fadd_rn(__fmul_rn(a, h), b): two
// IEEE roundings, never a fused multiply-add, so the result does not depend
// on the compiler's contraction and equals a plain loop of a PyTorch
// multiply and add bit for bit.
//
// What bounds it. One pass over memory with two flops per element: a and b
// read once, h written once (f32). At recurrentgemma-9b's prefill, (2,
// 4096, 4096) f32, that is 402.7 MB, 120.2 us at the H100's 3.35 TB/s.
//
// Design. Sequential in time, parallel over channels, as the TPU kernel:
// one thread per (batch row, channel) carries h in a register and walks the
// sequence; neighbouring threads take neighbouring channels, so every load
// and store of a step is coalesced. a_t and b_t do not depend on the carry,
// so each thread loads the next 16 steps while it computes the current 16
// (a register double buffer) to keep loads in flight. Steps beyond S are
// predicated, never broken out of, so the loops unroll. With B x D threads
// (8,192 at recurrentgemma's width) the card is far from full; a chunked
// parallel scan over S is a later change.
//
// Interface: a plain C entry point, loaded with ctypes. It launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ h0,
                  float* __restrict__ h, float* __restrict__ h_last, int s, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int row = blockIdx.y;
  if (c >= d) return;
  const int64_t base = static_cast<int64_t>(row) * s * d + c;
  float carry = h0[static_cast<int64_t>(row) * d + c];

  float ca[kUnroll], cb[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const bool in = u < s;
    ca[u] = in ? to_f32(a[base + static_cast<int64_t>(u) * d]) : 0.f;
    cb[u] = in ? to_f32(b[base + static_cast<int64_t>(u) * d]) : 0.f;
  }
  for (int t0 = 0; t0 < s; t0 += kUnroll) {
    float na[kUnroll], nb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + kUnroll + u;
      const bool in = t < s;
      na[u] = in ? to_f32(a[base + static_cast<int64_t>(t) * d]) : 0.f;
      nb[u] = in ? to_f32(b[base + static_cast<int64_t>(t) * d]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < s) {
        carry = __fadd_rn(__fmul_rn(ca[u], carry), cb[u]);
        h[base + static_cast<int64_t>(t) * d] = carry;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
  h_last[static_cast<int64_t>(row) * d + c] = carry;
}

template <typename T>
int launch(const void* a, const void* b, const void* h0, void* h, void* h_last, int rows, int s, int d,
           cudaStream_t stream) {
  dim3 grid((d + kThreads - 1) / kThreads, rows);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                                      static_cast<const float*>(h0), static_cast<float*>(h),
                                                      static_cast<float*>(h_last), s, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a, b (B, S, D) of one type (dtype 0 = f32, 1 = bf16); h0 (B, D) f32;
// h (B, S, D) and h_last (B, D) f32; all contiguous. B <= 65535.
int rg_scan(const void* a, const void* b, const void* h0, void* h, void* h_last, int rows, int s, int d, int dtype,
            void* stream) {
  if (rows <= 0 || s <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h0, h, h_last, rows, s, d, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, h0, h, h_last, rows, s, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
