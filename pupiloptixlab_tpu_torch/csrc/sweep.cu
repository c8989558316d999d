// Chunk sweep over a small triangle table for Hopper: closest hit (K5) and
// any hit (K6). The route of scenes without a BVH (bvh_nodes == 0).
//
// Replaces the Pallas TPU kernels of pupiloptixlab_tpu/accel/pallas_intersect.py:
//   launch_sweep_closest <- _kernel_grid (<= 4 chunks, no culling) and
//                           _make_kernel (5-32 chunks unrolled without
//                           culling; above that culled by chunk boxes and
//                           32-chunk super-boxes), both reached through
//                           sweep_triangles
//   launch_sweep_anyhit  <- _kernel_grid_any, reached through
//                           sweep_triangles_any
// One kernel serves both closest-hit rows: they compute the same function
// and differ only in how the TPU grid walks the chunks, which here is a loop
// inside each thread either way.
//
// What it computes: per ray, over the (T, 12) [p0, e1, e2, pad] triangle
// table (T a multiple of 64; padding rows are all zero, det = 0, never hit):
//   K5: the closest Moller-Trumbore hit (t, row) with t in (tmin, tmax),
//       the lowest row among equal t; a miss writes t = 1e16, row = -1.
//   K6: an int32 flag, 1 when any row is hit in (tmin, tmax).
//
// Design. The TPU kernel tests a whole 1024-ray tile against each 64-row
// chunk and skips a chunk only when no ray of the tile can improve (it has
// no per-lane control flow). Here each thread owns one ray and walks the
// chunks in ascending order on its own: above 32 chunks it first slab-tests
// the super-box of each group of 32 chunks, then each chunk box inside a
// group that passes, and runs the 64 triangle tests of a chunk only when the
// ray itself can improve there (tfar clamped by its running best t, the
// reference's box_test). Up to 32 chunks no box is read, as on the TPU.
// Skipping never changes a lane: a chunk is skipped only when its box cannot
// hold a hit nearer than the ray's best, and rows are visited in ascending
// order with a strict t < tbest, so the lowest row wins among equal t as the
// plain sweep's argmin does. K6 stops at the first hit and culls by the same
// boxes against tmax (the TPU kernel reads no box; the flag is the same).
//
// Bounds on the card. Without culling the work is N x T triangle tests of
// about 50 float operations each, bound by FP32 issue (no FMA: every op
// rounds on its own so that t equals the plain sweep bit for bit). The rays
// are read once (32 B) and the result written once (4-8 B); the table is a
// few KB to 1 MB and every thread of a warp reads the same row at the same
// time, a broadcast load served by L1 through the read-only path.

#include "ray_tests.cuh"

namespace {

using namespace rt;

constexpr int kThreads = 128;
constexpr int kChunk = 64;  // rows per chunk (the flatten's pad_tris_to)
constexpr int kGroup = 32;  // chunks per super-box

// Closest hit of ray r in chunk c; rows ascend, strict <, so ties keep the
// lowest row.
__device__ __forceinline__ void chunk_closest(const float4* __restrict__ tri,
                                              int c, const Ray& r, float* tbest,
                                              int* ibest) {
  const int base = c * kChunk;
  const float4* row = tri + (size_t)base * 3;
#pragma unroll 4
  for (int j = 0; j < kChunk; ++j) {
    float t;
    if (moller_trumbore(row + j * 3, r, &t) && t < *tbest) {
      *tbest = t;
      *ibest = base + j;
    }
  }
}

__device__ __forceinline__ bool chunk_any(const float4* __restrict__ tri, int c,
                                          const Ray& r) {
  const float4* row = tri + (size_t)c * kChunk * 3;
  for (int j = 0; j < kChunk; ++j) {
    float t;
    if (moller_trumbore(row + j * 3, r, &t)) return true;
  }
  return false;
}

template <bool kCull>
__global__ void __launch_bounds__(kThreads)
sweep_closest_kernel(const float* __restrict__ rox, const float* __restrict__ roy,
                     const float* __restrict__ roz, const float* __restrict__ rdx,
                     const float* __restrict__ rdy, const float* __restrict__ rdz,
                     const float* __restrict__ tmin, const float* __restrict__ tmax,
                     const float4* __restrict__ tri, const float4* __restrict__ boxes,
                     const float4* __restrict__ sboxes, int n, int n_chunks,
                     int n_groups, float* __restrict__ t_out,
                     int* __restrict__ i_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin, tmax);
  float tbest = kMaxDistance;
  int ibest = -1;
  if (r.tmx > r.tmn) {  // culled lanes (empty interval) return at once
    if (!kCull) {
      for (int c = 0; c < n_chunks; ++c) chunk_closest(tri, c, r, &tbest, &ibest);
    } else {
      float tn;
      for (int g = 0; g < n_groups; ++g) {
        if (!slab(sboxes + (size_t)g * 2, r, fminf(tbest, r.tmx), &tn)) continue;
        const int c_end = min((g + 1) * kGroup, n_chunks);
        for (int c = g * kGroup; c < c_end; ++c) {
          if (slab(boxes + (size_t)c * 2, r, fminf(tbest, r.tmx), &tn)) {
            chunk_closest(tri, c, r, &tbest, &ibest);
          }
        }
      }
    }
  }
  t_out[i] = tbest;
  i_out[i] = ibest;
}

template <bool kCull>
__global__ void __launch_bounds__(kThreads)
sweep_anyhit_kernel(const float* __restrict__ rox, const float* __restrict__ roy,
                    const float* __restrict__ roz, const float* __restrict__ rdx,
                    const float* __restrict__ rdy, const float* __restrict__ rdz,
                    const float* __restrict__ tmin, const float* __restrict__ tmax,
                    const float4* __restrict__ tri, const float4* __restrict__ boxes,
                    const float4* __restrict__ sboxes, int n, int n_chunks,
                    int n_groups, int* __restrict__ occ_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin, tmax);
  int occluded = 0;
  if (r.tmx > r.tmn) {
    if (!kCull) {
      for (int c = 0; c < n_chunks && !occluded; ++c) {
        occluded = chunk_any(tri, c, r) ? 1 : 0;
      }
    } else {
      float tn;
      for (int g = 0; g < n_groups && !occluded; ++g) {
        if (!slab(sboxes + (size_t)g * 2, r, r.tmx, &tn)) continue;
        const int c_end = min((g + 1) * kGroup, n_chunks);
        for (int c = g * kGroup; c < c_end && !occluded; ++c) {
          if (slab(boxes + (size_t)c * 2, r, r.tmx, &tn)) {
            occluded = chunk_any(tri, c, r) ? 1 : 0;
          }
        }
      }
    }
  }
  occ_out[i] = occluded;
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// n_groups > 1 selects the culled form and needs boxes ((n_chunks, 8)) and
// sboxes ((n_groups, 8)); with n_groups <= 1 neither is read.
extern "C" int launch_sweep_closest(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, const float* tmin, const float* tmax,
    const float* tri, const float* boxes, const float* sboxes, int n,
    int n_chunks, int n_groups, float* t_out, int* i_out, cudaStream_t stream) {
  if (n > 0) {
    const float4* tri4 = reinterpret_cast<const float4*>(tri);
    const float4* box4 = reinterpret_cast<const float4*>(boxes);
    const float4* sbox4 = reinterpret_cast<const float4*>(sboxes);
    if (n_groups > 1) {
      sweep_closest_kernel<true><<<blocks_for(n), kThreads, 0, stream>>>(
          rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri4, box4, sbox4, n,
          n_chunks, n_groups, t_out, i_out);
    } else {
      sweep_closest_kernel<false><<<blocks_for(n), kThreads, 0, stream>>>(
          rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri4, box4, sbox4, n,
          n_chunks, n_groups, t_out, i_out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int launch_sweep_anyhit(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, const float* tmin, const float* tmax,
    const float* tri, const float* boxes, const float* sboxes, int n,
    int n_chunks, int n_groups, int* occ_out, cudaStream_t stream) {
  if (n > 0) {
    const float4* tri4 = reinterpret_cast<const float4*>(tri);
    const float4* box4 = reinterpret_cast<const float4*>(boxes);
    const float4* sbox4 = reinterpret_cast<const float4*>(sboxes);
    if (n_groups > 1) {
      sweep_anyhit_kernel<true><<<blocks_for(n), kThreads, 0, stream>>>(
          rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri4, box4, sbox4, n,
          n_chunks, n_groups, occ_out);
    } else {
      sweep_anyhit_kernel<false><<<blocks_for(n), kThreads, 0, stream>>>(
          rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri4, box4, sbox4, n,
          n_chunks, n_groups, occ_out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
