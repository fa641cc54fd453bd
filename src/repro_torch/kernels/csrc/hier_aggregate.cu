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
// What bounds it. The operator reads x once and writes out once:
// 2*N*D*itemsize bytes with about 3 flops per element, a memory bound at
// every shape of the main path (3.35 TB/s on an H100 SXM). The shapes span
// two extremes: short groups over wide leaves (lm-100m's 8 x 18,874,368,
// mlp307k's 32 x 262,144) and tall groups over narrow leaves (a cohort's
// root stage, 4096 rows x 768, 480, 48 or 10 columns, G = 1).
//
// Design. The TPU kernel keeps all N rows of a column tile in VMEM and
// reduces them there. Hopper has no such store, and one block per (group,
// column tile) leaves a tall narrow group on a handful of SMs with each
// thread walking thousands of dependent rows. So the wrapper
// (kernels/hier_aggregate.py, ``_schedule``) picks one of two schedules
// from the shape alone and passes it here; this file executes it.
//   * A block is up to 256 threads laid over (group, row, column slot)
//     triples: ``lanes`` slots of one column tile, ``rows`` row threads per
//     group, ``groups_per_block`` short groups side by side. A slot is 16
//     bytes (4 f32 or 8 bf16 columns) where D is a multiple of that, else
//     one column; a slot is loaded with one 16-byte load when x and out are
//     16-byte aligned, else element by element (same values, same sums).
//     Each thread sums its rows in order in f32 registers, loading eight
//     rows before it adds any; the row threads of a slot then combine in
//     shared memory in a fixed pairwise tree.
//   * One pass (groups of at most 64 rows, or enough groups and tiles to
//     fill the card): ``group_mean_kernel`` reduces a group's rows, takes
//     the mean and writes it to the same rows. One read, one write.
//   * Split (a tall group and too few blocks): the group's rows are cut into
//     chunks of ``chunk_rows``, one work item per (group, chunk). Pass one
//     (``group_mean_kernel`` with a scratch buffer) writes each item's
//     partial sums per column and its weight sum to the scratch. Pass two
//     (``group_mean_finish_kernel``) runs over the same (item, column tile)
//     blocks: each sums its group's partials in item order (the same
//     strided-then-tree order), so every block of a group holds the same
//     bits, and stores the mean to its own chunk's rows. The stores are as
//     spread as the loads. A grid-wide barrier in one cooperative launch
//     would save a launch but caps the grid at what is resident and pins
//     the kernel to a persistent loop; the second pass keeps both kernels
//     plain, and Hopper's programmatic dependent launch hides most of the
//     second launch: pass two is queued while pass one runs and waits
//     (griddepcontrol.wait) only before it reads the partials. The partials
//     are N/chunk_rows rows of D floats (135 KB at the root's 4096 x 768),
//     so pass two re-reads them from L2.
// The summation order depends only on (N, D, G, dtype and, for K2, the
// segment offsets): never on alignment or timing. No float atomics. Products
// and sums stay unfused (__fmul_rn/__fadd_rn) and the mean is __fdiv_rn, so
// each product rounds as in the plain PyTorch version; only the order of the
// f32 additions differs (a tree, which is also more accurate).
//
// K1 computes its row ranges from the uniform group size. K2 reads them from
// a table the wrapper builds once per tree level (or uploads with a
// cohort): the (G+1) offsets, and, when a segment is longer than the chunk,
// the (G+1) first work item of each segment and the segment of each item.
// Groups and work items run on grid.x (up to 2^31 - 1 blocks), so any group
// count the int32 sizes admit is taken.
//
// K6 reads the int8 codes q (N, D) and the f32 block scales (N, D / qblock)
// of the compressed transport's row layout (kernels/quantize.py) instead of
// x, decodes x = q * scale in registers, and writes f32: D bytes a row in,
// 4*D out, so at 32 x 262,144 it moves 8.4 MB + 0.13 MB in and 33.6 MB out,
// 12.6 us at 3.35 TB/s. One thread owns one column of one segment and walks
// its rows; the 256-column tiles run on grid.x and the segments on grid.y,
// each block walking every gridDim.y-th segment where there are more than
// grid.y's 65,535 (a flat grid.x over both made K6 slower at 32 and 50 x
// 262,144 on an H100: a per-thread division by the tile count, beside a
// loop of only 8-16 rows). A group whose weights sum to zero writes its
// decoded rows, q * scale, which is what K5 would write for them, bit for
// bit.
//
// Interface: plain C entry points, loaded with ctypes. Each launches on the
// given stream, does not synchronise, and returns cudaGetLastError();
// hier_error_name / hier_error_string name a returned code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // hier_aggregate.THREADS mirrors it
constexpr int64_t kMaxBlocks = 2147483647;  // grid.x
constexpr int kMaxGridY = 65535;            // grid.y: K6 walks the segments beyond it
// Rows a thread loads before it adds any: a loop left to nvcc's unrolling
// runs a short or ragged trip count one load per round trip (pass one at
// n1m's root ran at a third of the card's rate so); this keeps kBatch in
// flight. 4 and 16 were no faster on an H100, and 16 spills bf16.
constexpr int kBatch = 8;

// Programmatic dependent launch (sm_90): the split's second kernel is
// launched while the first runs and waits here until the first's writes
// are visible; the first lets it launch as soon as every block has started.
__device__ __forceinline__ void wait_for_prior_grid() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void allow_dependent_launch() { asm volatile("griddepcontrol.launch_dependents;"); }

// -- slots: V consecutive columns of one row, as f32 ---------------------------

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// the columns of a 16-byte slot: 4 f32, or 8 bf16 (little-endian: the lower
// column in the low half of each word)
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  const unsigned int words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(words[k] << 16);
    v[2 * k + 1] = __uint_as_float(words[k] & 0xffff0000u);
  }
}

// One slot of one row as loaded, held until it is added: element by element
// (converted to f32 as loaded), or one 16-byte load kept packed, so a batch
// of bf16 rows costs 4 registers a row, not 8 (8 took the bf16 one pass to
// 127 registers, two blocks an SM, and lm-100m's leaf a quarter slower).
template <typename T, int V, bool kVec16>
struct Slot {
  float v[V];
  __device__ __forceinline__ void load(const T* __restrict__ p) {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = to_f32(p[k]);
  }
  __device__ __forceinline__ void get(float (&out)[V]) const {
#pragma unroll
    for (int k = 0; k < V; ++k) out[k] = v[k];
  }
};

template <typename T, int V>
struct Slot<T, V, true> {
  static_assert(V * sizeof(T) == 16, "a 16-byte slot");
  uint4 u;
  __device__ __forceinline__ void load(const T* __restrict__ p) { u = __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ __forceinline__ void get(float (&out)[V]) const { unpack(u, out); }
};

template <int V, bool kVec16>
__device__ __forceinline__ void store_slot(float* __restrict__ p, const float (&v)[V]) {
  if constexpr (kVec16) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = v[k];
  }
}

__device__ __forceinline__ unsigned int bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <int V, bool kVec16>
__device__ __forceinline__ void store_slot(__nv_bfloat16* __restrict__ p, const float (&v)[V]) {
  if constexpr (kVec16) {
    uint4 u;
    u.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
    u.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
    u.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
    u.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = __float2bfloat16_rn(v[k]);
  }
}

// a dead group's slot, bit for bit
template <typename T, int V, bool kVec16>
__device__ __forceinline__ void copy_slot(const T* __restrict__ src, T* __restrict__ dst) {
  if constexpr (kVec16) {
    *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) dst[k] = src[k];
  }
}

// the scratch partials are f32 and always 16-byte aligned
template <int V>
__device__ __forceinline__ void load_partial(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p + k));
      v[k] = f.x; v[k + 1] = f.y; v[k + 2] = f.z; v[k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = __ldg(p + k);
  }
}

template <int V>
__device__ __forceinline__ void store_partial(float* __restrict__ p, const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 4)
      *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = v[k];
  }
}

// -- the schedule ------------------------------------------------------------------

struct Plan {
  int64_t d;             // columns
  int slots;             // d / V
  int groups;
  int group_size;        // K1: rows per group; 0 for K2 (rows from offsets)
  int lanes, rows, groups_per_block, tiles;
  int chunk_rows;        // split: rows per work item
  int chunks;            // K1 split: work items per group
  int64_t items;         // split: work items in all
  const int* offsets;    // K2: (G+1) row offsets
  const int* item_first; // K2 split: (G+1) first work item of each segment
  const int* item_seg;   // K2 split: the segment of each work item
};

__device__ __forceinline__ void group_rows(const Plan& p, int g, int& start, int& end) {
  if (p.offsets != nullptr) {
    start = p.offsets[g];
    end = p.offsets[g + 1];
  } else {
    start = g * p.group_size;
    end = start + p.group_size;
  }
}

// the group of a work item, its group's items [first, first + count), and
// the item's rows [lo, hi)
__device__ __forceinline__ void item_span(const Plan& p, int64_t item, int& first, int& count, int& lo,
                                          int& hi) {
  int g;
  if (p.item_seg != nullptr) {
    g = p.item_seg[item];
    first = p.item_first[g];
    count = p.item_first[g + 1] - first;
  } else {
    g = static_cast<int>(item / p.chunks);
    first = g * p.chunks;
    count = p.chunks;
  }
  int start, end;
  group_rows(p, g, start, end);
  lo = start + (static_cast<int>(item) - first) * p.chunk_rows;
  hi = min(lo + p.chunk_rows, end);
}

// Sums the thread's registers over the block's row threads in a fixed
// pairwise tree (shared memory laid out column-major, so a warp's lanes hit
// distinct banks) and leaves every thread of the slot with the result.
template <int V>
__device__ __forceinline__ void combine_rows(float (&num)[V], float& den, int rt, int rows, int lanes) {
  __shared__ float sm_num[V][kThreads];
  __shared__ float sm_den[kThreads];
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < V; ++k) sm_num[k][t] = num[k];
  sm_den[t] = den;
  int half = 1;
  while (half < rows) half <<= 1;
  for (int s = half >> 1; s > 0; s >>= 1) {
    __syncthreads();
    if (rt < s && rt + s < rows) {
      const int o = t + s * lanes;
#pragma unroll
      for (int k = 0; k < V; ++k) sm_num[k][t] = __fadd_rn(sm_num[k][t], sm_num[k][o]);
      sm_den[t] = __fadd_rn(sm_den[t], sm_den[o]);
    }
  }
  __syncthreads();
  const int t0 = t - rt * lanes;
#pragma unroll
  for (int k = 0; k < V; ++k) num[k] = sm_num[k][t0];
  den = sm_den[t0];
}

template <typename T, int V, bool kVec16>
__device__ __forceinline__ void write_rows(const T* __restrict__ x, T* __restrict__ out, int64_t d, int64_t col,
                                           int lo, int hi, int step, const float (&num)[V], float den) {
  if (den > 0.0f) {
    float mean[V];
#pragma unroll
    for (int k = 0; k < V; ++k) mean[k] = __fdiv_rn(num[k], den);
#pragma unroll 4
    for (int i = lo; i < hi; i += step) store_slot<V, kVec16>(out + i * d + col, mean);
  } else {
    // no survivors: the group keeps its rows exactly
#pragma unroll 4
    for (int i = lo; i < hi; i += step) copy_slot<T, V, kVec16>(x + i * d + col, out + i * d + col);
  }
}

// One pass (partial == nullptr): blocks over (groups_per_block groups,
// column tile); each reduces its groups and writes their means. Split pass
// one: blocks over (work item, column tile); each writes its item's partial
// sums to partial[item, :] and (tile 0) its weight sum to
// partial[items * d + item].
template <typename T, int V, bool kVec16>
__global__ void __launch_bounds__(kThreads)
group_mean_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
                  float* __restrict__ partial, const Plan p) {
  if (partial != nullptr) allow_dependent_launch();
  const int tile = static_cast<int>(blockIdx.x % p.tiles);
  const int64_t work = blockIdx.x / p.tiles;
  const int sub = p.lanes * p.rows;
  const int t = threadIdx.x;
  const int gi = t / sub, rt = (t % sub) / p.lanes, lane = t % p.lanes;
  const int slot = tile * p.lanes + lane;
  const int64_t col = static_cast<int64_t>(slot) * V;
  int lo = 0, hi = 0;
  bool live = slot < p.slots;
  if (partial != nullptr) {
    int first, count;
    item_span(p, work, first, count, lo, hi);
  } else {
    const int64_t g = work * p.groups_per_block + gi;
    live = live && g < p.groups;
    if (live) group_rows(p, static_cast<int>(g), lo, hi);
  }
  float num[V];
  float den = 0.0f;
#pragma unroll
  for (int k = 0; k < V; ++k) num[k] = 0.0f;
  if (live) {
    for (int base = lo + rt; base < hi; base += kBatch * p.rows) {
      Slot<T, V, kVec16> v[kBatch];
      float wv[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = base + b * p.rows;
        if (i < hi) {
          wv[b] = __ldg(w + i);
          v[b].load(x + i * p.d + col);
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (base + b * p.rows < hi) {
          float f[V];
          v[b].get(f);
#pragma unroll
          for (int k = 0; k < V; ++k) num[k] = __fadd_rn(num[k], __fmul_rn(f[k], wv[b]));
          den = __fadd_rn(den, wv[b]);
        }
      }
    }
  }
  if (p.rows > 1) combine_rows<V>(num, den, rt, p.rows, p.lanes);
  if (!live) return;
  if (partial != nullptr) {
    if (rt == 0) {
      store_partial<V>(partial + work * p.d + col, num);
      if (slot == 0) partial[p.items * p.d + work] = den;
    }
    return;
  }
  write_rows<T, V, kVec16>(x, out, p.d, col, lo + rt, hi, p.rows, num, den);
}

// Split pass two: blocks over (work item, column tile), as pass one. Each
// sums its group's partials in item order and stores the mean (or, for a
// dead group, the input) to its item's rows.
template <typename T, int V, bool kVec16>
__global__ void __launch_bounds__(kThreads)
group_mean_finish_kernel(const T* __restrict__ x, const float* __restrict__ partial, T* __restrict__ out,
                         const Plan p) {
  const int tile = static_cast<int>(blockIdx.x % p.tiles);
  const int64_t item = blockIdx.x / p.tiles;
  const int t = threadIdx.x;
  const int rt = t / p.lanes, lane = t % p.lanes;
  const int slot = tile * p.lanes + lane;
  const int64_t col = static_cast<int64_t>(slot) * V;
  const bool live = slot < p.slots;
  int first, count, lo, hi;
  item_span(p, item, first, count, lo, hi);
  float num[V];
  float den = 0.0f;
#pragma unroll
  for (int k = 0; k < V; ++k) num[k] = 0.0f;
  wait_for_prior_grid();  // the partials are pass one's
  if (live) {
    const float* dens = partial + p.items * p.d;
    const int end = first + count;
    constexpr int kPartials = V > 4 ? kBatch / 2 : kBatch;  // 32 floats of partials in flight
    for (int base = first + rt; base < end; base += kPartials * p.rows) {
      float v[kPartials][V], dv[kPartials];
#pragma unroll
      for (int b = 0; b < kPartials; ++b) {
        const int j = base + b * p.rows;
        if (j < end) {
          load_partial<V>(partial + j * p.d + col, v[b]);
          dv[b] = __ldg(dens + j);
        }
      }
#pragma unroll
      for (int b = 0; b < kPartials; ++b) {
        if (base + b * p.rows < end) {
#pragma unroll
          for (int k = 0; k < V; ++k) num[k] = __fadd_rn(num[k], v[b][k]);
          den = __fadd_rn(den, dv[b]);
        }
      }
    }
  }
  if (p.rows > 1) combine_rows<V>(num, den, rt, p.rows, p.lanes);
  if (!live) return;
  write_rows<T, V, kVec16>(x, out, p.d, col, lo + rt, hi, p.rows, num, den);
}

template <typename T, int V, bool kVec16>
cudaError_t launch(const void* x, const void* w, void* out, float* partial, const Plan& p, int64_t blocks,
                   int threads, cudaStream_t s) {
  group_mean_kernel<T, V, kVec16><<<static_cast<unsigned int>(blocks), threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<T*>(out), partial, p);
  if (partial == nullptr) return cudaGetLastError();
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(blocks));
  cfg.blockDim = dim3(threads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, group_mean_finish_kernel<T, V, kVec16>, static_cast<const T*>(x),
                            static_cast<const float*>(partial), static_cast<T*>(out), p);
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, void* out, float* partial, const Plan& p, int vec,
                     int vec16, int64_t blocks, int threads, cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
  if (vec == 1) return launch<T, 1, false>(x, w, out, partial, p, blocks, threads, s);
  if (vec != kV) return cudaErrorInvalidValue;
  return vec16 ? launch<T, kV, true>(x, w, out, partial, p, blocks, threads, s)
               : launch<T, kV, false>(x, w, out, partial, p, blocks, threads, s);
}

// Checks the schedule the wrapper chose, fills the plan's tiling and returns
// the block count (0 for a schedule this file cannot run).
int64_t plan_tiles(Plan& p, int n, int d, int dtype, int vec, int lanes, int rows, int groups_per_block,
                   int chunk_rows, bool split) {
  if (n <= 0 || d <= 0 || p.groups <= 0 || (dtype != 0 && dtype != 1) || vec <= 0 || d % vec != 0 ||
      lanes <= 0 || rows <= 0 || groups_per_block <= 0 || chunk_rows <= 0 ||
      static_cast<int64_t>(lanes) * rows * groups_per_block > kThreads || (split && groups_per_block != 1))
    return 0;
  p.d = d;
  p.slots = d / vec;
  p.lanes = lanes;
  p.rows = rows;
  p.groups_per_block = groups_per_block;
  p.tiles = (p.slots + lanes - 1) / lanes;
  p.chunk_rows = chunk_rows;
  const int64_t work = split ? p.items : (p.groups + static_cast<int64_t>(groups_per_block) - 1) / groups_per_block;
  const int64_t blocks = work * p.tiles;
  return blocks > kMaxBlocks ? 0 : blocks;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vec, lanes, rows, groups_per_block and
// chunk_rows: the wrapper's schedule (hier_aggregate._schedule); a group of
// more than chunk_rows rows is split over blocks and two kernels, with
// scratch holding (G * chunks) * (d + 1) floats. vec16: x and out are
// 16-byte aligned. Returns a cudaError_t (0 on success).
extern "C" int hier_grouped_mean(const void* x, const void* w, void* out, void* scratch, int n, int d,
                                 int num_groups, int dtype, int vec, int lanes, int rows,
                                 int groups_per_block, int chunk_rows, int vec16, void* stream) {
  if (num_groups <= 0 || n % num_groups != 0 || chunk_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan p{};
  p.groups = num_groups;
  p.group_size = n / num_groups;
  p.chunks = (p.group_size + chunk_rows - 1) / chunk_rows;
  const bool split = p.chunks > 1;
  p.items = split ? static_cast<int64_t>(num_groups) * p.chunks : 0;
  const int64_t blocks = plan_tiles(p, n, d, dtype, vec, lanes, rows, groups_per_block, chunk_rows, split);
  if (blocks == 0 || (split && scratch == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  float* partial = split ? static_cast<float*>(scratch) : nullptr;
  const int threads = lanes * rows * groups_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? dispatch<float>(x, w, out, partial, p, vec, vec16, blocks, threads, s)
                 : dispatch<__nv_bfloat16>(x, w, out, partial, p, vec, vec16, blocks, threads, s);
  return static_cast<int>(err);
}

// table: the wrapper's segment table (hier_aggregate.segment_table): the
// (G+1) offsets, then, when items > 0, the (G+1) first work item of each
// segment and the segment of each of the items (scratch: items * (d + 1)
// floats). items == 0: one pass.
extern "C" int hier_segment_mean(const void* x, const void* w, const void* table, void* out, void* scratch,
                                 int n, int d, int num_segments, int items, int dtype, int vec, int lanes,
                                 int rows, int groups_per_block, int chunk_rows, int vec16, void* stream) {
  if (num_segments <= 0 || items < 0 || table == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const bool split = items > 0;
  const int* tab = static_cast<const int*>(table);
  Plan p{};
  p.groups = num_segments;
  p.items = items;
  p.offsets = tab;
  if (split) {
    p.item_first = tab + num_segments + 1;
    p.item_seg = tab + 2 * (static_cast<int64_t>(num_segments) + 1);
  }
  const int64_t blocks = plan_tiles(p, n, d, dtype, vec, lanes, rows, groups_per_block, chunk_rows, split);
  if (blocks == 0 || (split && scratch == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  float* partial = split ? static_cast<float*>(scratch) : nullptr;
  const int threads = lanes * rows * groups_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? dispatch<float>(x, w, out, partial, p, vec, vec16, blocks, threads, s)
                 : dispatch<__nv_bfloat16>(x, w, out, partial, p, vec, vec16, blocks, threads, s);
  return static_cast<int>(err);
}

namespace {

__global__ void __launch_bounds__(kThreads)
segment_dequant_mean_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                            const float* __restrict__ w, const int* __restrict__ offsets,
                            float* __restrict__ out, int d, int qblock, int num_segments) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= d) return;
  const int64_t nb = d / qblock;
  const int64_t sb = col / qblock;
  for (int g = blockIdx.y; g < num_segments; g += gridDim.y) {
    const int start = offsets[g], end = offsets[g + 1];
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
}

}  // namespace

// q (n, d) int8, scales (n, d / qblock) f32 -> out (n, d) f32. offsets: the
// first num_segments + 1 entries of the segment table.
extern "C" int hier_segment_dequant_mean(const void* q, const void* scales, const void* w,
                                         const void* offsets, void* out, int n, int d, int qblock,
                                         int num_segments, void* stream) {
  if (num_segments <= 0 || d <= 0 || n <= 0 || qblock <= 0 || d % qblock != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((d + kThreads - 1) / kThreads, num_segments < kMaxGridY ? num_segments : kMaxGridY);
  segment_dequant_mean_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales), static_cast<const float*>(w),
      static_cast<const int*>(offsets), static_cast<float*>(out), d, qblock, num_segments);
  return static_cast<int>(cudaGetLastError());
}

// The CUDA runtime's name and description of an error code.
extern "C" const char* hier_error_name(int err) { return cudaGetErrorName(static_cast<cudaError_t>(err)); }

extern "C" const char* hier_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
