// Wide-BVH ray traversal for Hopper: closest hit (K1) and any hit (K2).
//
// Replaces the Pallas TPU kernels of pupiloptixlab_tpu/accel/pallas_bvh.py:
//   launch_bvh_closest <- _make_closest_kernel (resident, non-instanced),
//                         reached through bvh_closest
//   launch_bvh_anyhit  <- _make_anyhit_kernel  (resident, non-instanced),
//                         reached through bvh_anyhit
//
// What it computes: per ray, over the 8-wide BVH of accel/bvh.py (child ids
// with leaves encoded as -(row+1), one split axis per node, 8 child boxes of
// 8 floats per node) and the (T, 12) [p0, e1, e2, pad] triangle table:
//   K1: the closest Moller-Trumbore hit (t, row) with t in (tmin, tmax);
//       a miss writes t = 1e16, row = -1.
//   K2: an int32 flag, 1 when any triangle is hit in (tmin, tmax).
//
// Design. The TPU kernel walks a 1024-ray TILE through the tree together
// because the TPU has no per-lane control flow; Hopper does, so here each
// thread walks the tree for its own ray with a private stack (64 int32 in
// local memory; the wrapper checks 7 * depth + 1 <= 64 from the depth the
// flatten records). Children are pushed far-to-near by the ray's own
// direction sign along the node's split axis (children are stored sorted
// along it), so the near child pops first.
//
// Bounds on the card: traversal is latency-bound on dependent loads of node
// boxes (32 B) and leaf rows (48 B) plus divergence between the rays of a
// warp. Rays are 128-thread blocks in the caller's lane order; on the main
// path primary rays arrive in 8x128 pixel blocks, so a warp's rays are
// coherent. Node and triangle tables are small (mesh_env: 80 KB of boxes,
// 1 MB of triangles) and stay in L2/L1; all loads go through the read-only
// path. Sorting secondary rays for coherence is left to later, measured work.
//
// Exactness. The slab test (ray_tests.cuh) is exactly _slab8 with tfar
// clamped by the running best t, and the leaf test is _mt_planes with IEEE
// 1/det under -fmad=false, so t is bit-identical to the plain PyTorch
// sweep. Ties at equal t keep the lowest row, which makes
// (t, row) independent of visit order and equal to the brute sweep's
// choice. Empty child slots carry child id 0 with a never-hit point box at
// 1e30; id 0 is never pushed as a child, and a visit cap (every slot of the
// tree once) sets an error flag that the wrapper raises on.

#include "ray_tests.cuh"

namespace {

using namespace rt;

constexpr int kStack = 64;
constexpr int kThreads = 128;

enum : int { kErrVisitCap = 1, kErrStack = 2 };

__device__ __forceinline__ int leaf_start(int id, int t_rows, int tcl) {
  // clamp_leaf of the reference: rows [start, start + tcl) stay in the table
  const int s = -(id + 1);
  return min(max(s, 0), t_rows - tcl);
}

__global__ void __launch_bounds__(kThreads)
bvh_closest_kernel(const float* __restrict__ rox, const float* __restrict__ roy,
                   const float* __restrict__ roz, const float* __restrict__ rdx,
                   const float* __restrict__ rdy, const float* __restrict__ rdz,
                   const float* __restrict__ tmin, const float* __restrict__ tmax,
                   const float4* __restrict__ tri, const int* __restrict__ child,
                   const int* __restrict__ axis, const float4* __restrict__ boxes,
                   int n, int t_rows, int tcl, int n_nodes,
                   float* __restrict__ t_out, int* __restrict__ i_out,
                   int* __restrict__ err) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin, tmax);
  float tbest = kMaxDistance;
  int ibest = -1;
  if (r.tmx > r.tmn) {  // culled lanes (empty interval) return at once
    int stack[kStack];
    float stack_tn[kStack];
    int sp = 0;
    stack[sp] = 0;
    stack_tn[sp] = r.tmn;
    ++sp;
    int visits = n_nodes * 8 + 1;  // every slot of the tree at most once
    while (sp > 0) {
      if (--visits < 0) { atomicOr(err, kErrVisitCap); break; }
      --sp;
      const int id = stack[sp];
      // entries whose box starts beyond the best hit cannot improve it
      // (ties stay: the slab test's tn <= tf is inclusive too)
      if (stack_tn[sp] > tbest) continue;
      if (id < 0) {
        const int s = leaf_start(id, t_rows, tcl);
        for (int j = 0; j < tcl; ++j) {
          float t;
          const int row = s + j;
          if (moller_trumbore(tri + (size_t)row * 3, r, &t) &&
              (t < tbest || (t == tbest && row < ibest))) {
            tbest = t;
            ibest = row;
          }
        }
        continue;
      }
      const int ax = __ldg(axis + id);
      const float d = ax == 0 ? r.dx : (ax == 1 ? r.dy : r.dz);
      const bool fwd = d >= 0.0f;
      const float tfar = fminf(tbest, r.tmx);
      for (int k = 0; k < 8; ++k) {
        // children ascend along the axis: push far first so near pops first
        const int kk = fwd ? 7 - k : k;
        float tn;
        if (!slab(boxes + (size_t)(id * 8 + kk) * 2, r, tfar, &tn)) continue;
        if (sp >= kStack) { atomicOr(err, kErrStack); sp = 0; break; }
        stack[sp] = __ldg(child + id * 8 + kk);
        stack_tn[sp] = tn;
        ++sp;
      }
    }
  }
  t_out[i] = tbest;
  i_out[i] = ibest;
}

__global__ void __launch_bounds__(kThreads)
bvh_anyhit_kernel(const float* __restrict__ rox, const float* __restrict__ roy,
                  const float* __restrict__ roz, const float* __restrict__ rdx,
                  const float* __restrict__ rdy, const float* __restrict__ rdz,
                  const float* __restrict__ tmin, const float* __restrict__ tmax,
                  const float4* __restrict__ tri, const int* __restrict__ child,
                  const int* __restrict__ axis, const float4* __restrict__ boxes,
                  int n, int t_rows, int tcl, int n_nodes,
                  int* __restrict__ occ_out, int* __restrict__ err) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin, tmax);
  int occluded = 0;
  if (r.tmx > r.tmn) {
    int stack[kStack];
    int sp = 0;
    stack[sp++] = 0;
    int visits = n_nodes * 8 + 1;
    while (sp > 0 && !occluded) {
      if (--visits < 0) { atomicOr(err, kErrVisitCap); break; }
      const int id = stack[--sp];
      if (id < 0) {
        const int s = leaf_start(id, t_rows, tcl);
        for (int j = 0; j < tcl; ++j) {
          float t;
          if (moller_trumbore(tri + (size_t)(s + j) * 3, r, &t)) {
            occluded = 1;
            break;
          }
        }
        continue;
      }
      for (int k = 0; k < 8; ++k) {  // fixed order: any hit terminates
        float tn;
        if (!slab(boxes + (size_t)(id * 8 + k) * 2, r, r.tmx, &tn)) continue;
        if (sp >= kStack) { atomicOr(err, kErrStack); sp = 0; break; }
        stack[sp++] = __ldg(child + id * 8 + k);
      }
    }
  }
  occ_out[i] = occluded;
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int launch_bvh_closest(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, const float* tmin, const float* tmax,
    const float* tri, const int* child, const int* axis, const float* boxes,
    int n, int t_rows, int tcl, int n_nodes, float* t_out, int* i_out, int* err,
    cudaStream_t stream) {
  if (n > 0) {
    bvh_closest_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        rox, roy, roz, rdx, rdy, rdz, tmin, tmax,
        reinterpret_cast<const float4*>(tri), child, axis,
        reinterpret_cast<const float4*>(boxes), n, t_rows, tcl, n_nodes,
        t_out, i_out, err);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int launch_bvh_anyhit(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, const float* tmin, const float* tmax,
    const float* tri, const int* child, const int* axis, const float* boxes,
    int n, int t_rows, int tcl, int n_nodes, int* occ_out, int* err,
    cudaStream_t stream) {
  if (n > 0) {
    bvh_anyhit_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        rox, roy, roz, rdx, rdy, rdz, tmin, tmax,
        reinterpret_cast<const float4*>(tri), child, axis,
        reinterpret_cast<const float4*>(boxes), n, t_rows, tcl, n_nodes,
        occ_out, err);
  }
  return static_cast<int>(cudaGetLastError());
}
