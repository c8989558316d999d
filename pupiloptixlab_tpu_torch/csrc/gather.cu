// Table gather into planes (K3) and CDF count (K4) for Hopper.
//
// launch_gather_planes replaces two Pallas TPU kernels of
// pupiloptixlab_tpu/accel/gather.py:
//   _make_gather_kernel (one-hot matmul gather, tables <= 2048 rows) and
//   _transpose_kernel   (the (N, C) -> (C, N) relayout after XLA's native
//                        gather for larger tables),
// both reached through gather_cols. It computes
//   out[c, i] = table[clamp(idx[i], 0, T-1), c]
// for a (T, C) float32 table and (N,) int32 indices, writing (C, N) planes.
// The TPU needed the one-hot matmul because it has no per-lane gather;
// Hopper gathers natively, so one kernel serves every table size and is
// bit-exact by construction (a copy, no arithmetic).
// Bounds on the card: memory. Each thread owns one lane i and loops over the
// C columns, so every store of a plane is coalesced across the warp; the
// table reads are row gathers that hit L2 (the tables on the main path are
// at most 2.1 MB: tris.attrs (20544, 26)). Bytes moved ~ N * (4 + 8 * C).
//
// launch_count_less replaces _make_count_kernel (gather.py, reached through
// count_less): per query, the number of table entries strictly below it.
// The TPU kernel compares every query with every entry (a VPU-shaped linear
// count); here each thread runs a lower-bound binary search, which for a
// nondecreasing table (every CDF on the path) is the same count, ties and
// flat runs included. The table sits in shared memory when it fits in
// 48 KB (the 65-entry env row CDF does) and is read from global memory
// otherwise. Bounds on the card: memory (8 bytes per query); the
// log2(T) shared-memory probes are cheap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGatherThreads = 256;
constexpr int kCountThreads = 256;
constexpr int kMaxSmemBytes = 48 * 1024;

__global__ void __launch_bounds__(kGatherThreads)
gather_planes_kernel(const float* __restrict__ table, int t_rows, int cols,
                     const int* __restrict__ idx, int n,
                     float* __restrict__ out) {
  const int i = blockIdx.x * kGatherThreads + threadIdx.x;
  if (i >= n) return;
  int r = idx[i];
  r = r < 0 ? 0 : (r > t_rows - 1 ? t_rows - 1 : r);
  const float* __restrict__ src = table + (size_t)r * cols;
  for (int c = 0; c < cols; ++c) {
    out[(size_t)c * n + i] = __ldg(src + c);
  }
}

__global__ void __launch_bounds__(kCountThreads)
count_less_kernel(const float* __restrict__ table, int t_rows, int use_smem,
                  const float* __restrict__ q, int n, int* __restrict__ out) {
  extern __shared__ float s_table[];
  if (use_smem) {
    for (int j = threadIdx.x; j < t_rows; j += kCountThreads) {
      s_table[j] = table[j];
    }
    __syncthreads();
  }
  const float* tab = use_smem ? s_table : table;
  const int i = blockIdx.x * kCountThreads + threadIdx.x;
  if (i >= n) return;
  const float x = q[i];
  int lo = 0, hi = t_rows;
  while (lo < hi) {  // first entry not below x
    const int mid = (lo + hi) >> 1;
    if (tab[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  out[i] = lo;
}

}  // namespace

extern "C" int launch_gather_planes(const float* table, int t_rows, int cols,
                                    const int* idx, int n, float* out,
                                    cudaStream_t stream) {
  if (n > 0 && cols > 0) {
    gather_planes_kernel<<<(n + kGatherThreads - 1) / kGatherThreads,
                           kGatherThreads, 0, stream>>>(table, t_rows, cols,
                                                        idx, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int launch_count_less(const float* table, int t_rows, const float* q,
                                 int n, int* out, cudaStream_t stream) {
  if (n > 0) {
    const int use_smem = t_rows * (int)sizeof(float) <= kMaxSmemBytes;
    const size_t smem = use_smem ? (size_t)t_rows * sizeof(float) : 0;
    count_less_kernel<<<(n + kCountThreads - 1) / kCountThreads, kCountThreads,
                        smem, stream>>>(table, t_rows, use_smem, q, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
