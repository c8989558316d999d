// Table gather into planes (K3) and CDF count (K4) for Hopper.
//
// launch_gather_planes replaces two Pallas TPU kernels of
// pupiloptixlab_tpu/accel/gather.py:
//   _make_gather_kernel (one-hot matmul gather, tables <= 2048 rows) and
//   _transpose_kernel   (the (N, C) -> (C, N) relayout after XLA's native
//                        gather for larger tables),
// both reached through gather_cols. It computes
//   out[k, i] = table[clamp(idx[i], 0, T-1) * ld + off(k)]
// for a float32 table of T rows (row stride ld elements), int32 indices
// and K selected columns at element offsets off(k), writing (K, N) planes.
// The TPU needed the one-hot matmul, whose cost is the same for 1 column
// or 32, because it has no per-lane gather. Hopper gathers natively, so one
// kernel serves every table size, reads a strided table (a column slice, a
// view) in place, and writes only the columns a caller reads; it is
// bit-exact by construction (a copy, no arithmetic).
// Bounds on the card: memory. Bytes ~ N * (4 + 4 * K) + the rows' reads,
// which hit L2 (the tables on the main path are at most 2.1 MB). The grid
// is sized to the SMs and strides over the lanes. Each thread owns 4
// consecutive lanes: one int4 load of their indices, and per column one
// float4 store of their 4 values, coalesced across the warp. Where the
// selected columns are a run in 16-byte-aligned rows, each
// lane reads 4 columns with one float4 load and the thread transposes the
// 4 x 4 block in registers: with 4 lanes a thread, one-column reads keep 4
// times as many rows in flight as one lane a thread did, and a table larger
// than L1 (the 402 KB quad pool) then loses the lines between its columns.
// The launcher takes the float4 path whenever the table allows it.
// Measured and left out (PERF.md): float2 reads of 8-byte-aligned
// rows (tris.attrs), staging tables of <= 48 KB in shared memory, and a
// warp that reads its 32 lanes' rows one by one with consecutive threads
// and transposes them through shared memory (1.3-11 times slower).
//
// launch_count_less replaces _make_count_kernel (gather.py, reached through
// count_less): per query, the number of table entries strictly below it.
// The TPU kernel compares every query with every entry (a VPU-shaped linear
// count); here each query runs a lower-bound binary search, which for a
// nondecreasing table (every CDF on the path) is the same count, ties and
// flat runs included. Two forms in one kernel: a shared table (T,) for all
// queries, or a row-indexed table (R, T) where query i searches row
// clamp(rows[i], 0, R-1) (the envmap's column CDF: the TPU gathered each
// ray's whole row with the one-hot matmul and compared it all, because a
// whole row costs it what one entry does; here a search probes ~8 of its
// 129 entries). The shared form keeps its table in shared memory when it
// fits in 48 KB, loaded once per block of a grid sized to the SMs (it paid
// on the 65-entry row CDF, PERF.md); the row form reads its table through
// L1 (staging the (64, 129) column CDF, 33 KB, did not pay on the frame's
// rows). Each thread owns 4 consecutive queries (float4 / int4 accesses).
// Bounds on the card: memory, 8 bytes per query (12 with rows).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;            // consecutive lanes (queries) per thread
constexpr int kBlocksPerSm = 8;      // 8 x 256 threads fill an SM
constexpr int kMaxSmemBytes = 48 * 1024;
constexpr int kMaxCols = 32;         // explicit column lists; runs take any length

struct ColSpec {
  int n;     // columns selected
  int step;  // > 0: off(k) = off[0] + k * step; 0: off(k) = off[k]
  int off[kMaxCols];
};

__device__ __forceinline__ int col_off(const ColSpec& cs, int k) {
  return cs.step > 0 ? cs.off[0] + k * cs.step : cs.off[k];
}

__device__ __forceinline__ int clamp_row(int r, int t_rows) {
  return r < 0 ? 0 : (r > t_rows - 1 ? t_rows - 1 : r);
}

int grid_for(int work_items, int blocks_per_sm) {
  static int sms_of[64];  // SM count per device, read once
  int dev = 0;
  cudaGetDevice(&dev);
  int& sms = sms_of[dev & 63];
  if (sms == 0 && cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != 0) {
    sms = 132;
  }
  const int need = (work_items + kThreads - 1) / kThreads;
  const int cap = sms * blocks_per_sm;
  return need < cap ? (need > 0 ? need : 1) : cap;
}

// Loads the 4 row indices of lanes i0..i0+3 (clamped; lanes past n read row
// 0 and are never stored).
__device__ __forceinline__ void load_rows(const int* __restrict__ idx, int n, int i0,
                                          bool vec_io, int t_rows, int r[kLanes]) {
  if (vec_io) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(idx + i0));
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) r[j] = i0 + j < n ? __ldg(idx + i0 + j) : 0;
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j) r[j] = clamp_row(r[j], t_rows);
}

__device__ __forceinline__ void store4(float* __restrict__ dst, int n, int i0,
                                       bool vec_io, float a, float b, float c, float d) {
  if (vec_io) {
    *reinterpret_cast<float4*>(dst + i0) = make_float4(a, b, c, d);
  } else {
    if (i0 < n) dst[i0] = a;
    if (i0 + 1 < n) dst[i0 + 1] = b;
    if (i0 + 2 < n) dst[i0 + 2] = c;
    if (i0 + 3 < n) dst[i0 + 3] = d;
  }
}

// kVecRows: groups of 4 columns of a run by float4 (rows and the first
// column 16-byte aligned), then the rest one by one.
template <bool kVecRows>
__global__ void __launch_bounds__(kThreads)
gather_planes_kernel(const float* __restrict__ table, int t_rows, int ld, ColSpec cs,
                     const int* __restrict__ idx, int n, int vec_io,
                     float* __restrict__ out) {
  const int ncols = cs.n;
  const int groups = (n + kLanes - 1) / kLanes;
  for (int g = blockIdx.x * kThreads + threadIdx.x; g < groups; g += gridDim.x * kThreads) {
    const int i0 = g * kLanes;
    int r[kLanes];
    load_rows(idx, n, i0, vec_io, t_rows, r);
    int k = 0;
    if (kVecRows) {
      for (; k + 4 <= ncols; k += 4) {
        float4 v[kLanes];
#pragma unroll
        for (int j = 0; j < kLanes; ++j) {
          v[j] = __ldg(reinterpret_cast<const float4*>(table + (size_t)r[j] * ld + cs.off[0] + k));
        }
        store4(out + (size_t)k * n, n, i0, vec_io, v[0].x, v[1].x, v[2].x, v[3].x);
        store4(out + (size_t)(k + 1) * n, n, i0, vec_io, v[0].y, v[1].y, v[2].y, v[3].y);
        store4(out + (size_t)(k + 2) * n, n, i0, vec_io, v[0].z, v[1].z, v[2].z, v[3].z);
        store4(out + (size_t)(k + 3) * n, n, i0, vec_io, v[0].w, v[1].w, v[2].w, v[3].w);
      }
    }
    for (; k < ncols; ++k) {
      const int o = col_off(cs, k);
      float v[kLanes];
#pragma unroll
      for (int j = 0; j < kLanes; ++j) v[j] = __ldg(table + (size_t)r[j] * ld + o);
      store4(out + (size_t)k * n, n, i0, vec_io, v[0], v[1], v[2], v[3]);
    }
  }
}

// Lower bound in tab[0..t): the first entry not below x, i.e. the count of
// entries strictly below x in a nondecreasing row.
__device__ __forceinline__ int lower_bound(const float* tab, int t, float x) {
  int lo = 0, hi = t;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tab[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// rows == nullptr: one shared row of t_cols entries; else (r_rows, t_cols)
// with row stride ld.
template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
count_less_kernel(const float* __restrict__ table, int r_rows, int t_cols, int ld,
                  const float* __restrict__ q, const int* __restrict__ rows, int n,
                  int vec_io, int* __restrict__ out) {
  extern __shared__ __align__(16) float s_tab[];
  if (kSmem) {
    for (int j = threadIdx.x; j < r_rows * t_cols; j += kThreads) {
      const int r = j / t_cols;
      s_tab[j] = table[(size_t)r * ld + (j - r * t_cols)];
    }
    __syncthreads();
  }
  const float* tab = kSmem ? s_tab : table;
  const size_t stride = kSmem ? (size_t)t_cols : (size_t)ld;
  const int groups = (n + kLanes - 1) / kLanes;
  for (int g = blockIdx.x * kThreads + threadIdx.x; g < groups; g += gridDim.x * kThreads) {
    const int i0 = g * kLanes;
    float x[kLanes];
    int r[kLanes] = {0, 0, 0, 0};
    if (vec_io) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(q + i0));
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < kLanes; ++j) x[j] = i0 + j < n ? __ldg(q + i0 + j) : 0.0f;
    }
    if (rows != nullptr) load_rows(rows, n, i0, vec_io, r_rows, r);
    int c[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) c[j] = lower_bound(tab + r[j] * stride, t_cols, x[j]);
    if (vec_io) {
      *reinterpret_cast<int4*>(out + i0) = make_int4(c[0], c[1], c[2], c[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kLanes; ++j)
        if (i0 + j < n) out[i0 + j] = c[j];
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// cols: n_cols element offsets (step == 0, n_cols <= 32), or off[0] and a
// step (> 0) for a run of n_cols columns.
extern "C" int launch_gather_planes(const float* table, int t_rows, int ld,
                                    const int* cols, int n_cols, int step,
                                    const int* idx, int n, float* out,
                                    cudaStream_t stream) {
  if (n <= 0 || n_cols <= 0) return static_cast<int>(cudaGetLastError());
  if (t_rows <= 0 || (step <= 0 && n_cols > kMaxCols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ColSpec cs{};
  cs.n = n_cols;
  cs.step = step > 0 ? step : 0;
  for (int k = 0; k < (step > 0 ? 1 : n_cols); ++k) cs.off[k] = cols[k];
  const int vec_io = n % kLanes == 0 && aligned16(idx) && aligned16(out);
  // float4 row reads: a run of >= 4 columns, rows and first column 16-byte aligned
  const bool vec_rows = step == 1 && n_cols >= 4 && ld % 4 == 0 && aligned16(table + cs.off[0]);
  const int grid = grid_for((n + kLanes - 1) / kLanes, kBlocksPerSm);
  if (vec_rows) {
    gather_planes_kernel<true><<<grid, kThreads, 0, stream>>>(table, t_rows, ld, cs, idx, n,
                                                              vec_io, out);
  } else {
    gather_planes_kernel<false><<<grid, kThreads, 0, stream>>>(table, t_rows, ld, cs, idx, n,
                                                               vec_io, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// rows == nullptr: the shared form (table (t_cols,), r_rows == 1); else the
// row-indexed form (table (r_rows, t_cols), row stride ld). The shared form
// stages its table in shared memory where it fits in 48 KB, with no more
// blocks than the SMs hold at once, so that each block stages it once.
extern "C" int launch_count_less(const float* table, int r_rows, int t_cols, int ld,
                                 const float* q, const int* rows, int n, int* out,
                                 cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (r_rows <= 0 || t_cols < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vec_io = n % kLanes == 0 && aligned16(q) && aligned16(out) &&
                     (rows == nullptr || aligned16(rows));
  const size_t bytes = (size_t)r_rows * t_cols * sizeof(float);
  const int groups = (n + kLanes - 1) / kLanes;
  if (rows == nullptr && bytes <= (size_t)kMaxSmemBytes) {
    // an SM has 228 KB of shared memory, 1 KB of it reserved per block
    const int fit = (int)((228u * 1024u) / (bytes + 1024u));
    const int per_sm = fit < kBlocksPerSm ? (fit > 0 ? fit : 1) : kBlocksPerSm;
    count_less_kernel<true><<<grid_for(groups, per_sm), kThreads, bytes, stream>>>(
        table, r_rows, t_cols, ld, q, rows, n, vec_io, out);
  } else {
    count_less_kernel<false><<<grid_for(groups, kBlocksPerSm), kThreads, 0, stream>>>(
        table, r_rows, t_cols, ld, q, rows, n, vec_io, out);
  }
  return static_cast<int>(cudaGetLastError());
}
