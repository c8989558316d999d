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
//
// What it computes: per ray, over the rows below `rows` of the (T, 12)
// [p0, e1, e2, pad] triangle table (T a multiple of 64; every row at or
// past `rows` is all zero and can never hit, det = 0):
//   K5: the closest Moller-Trumbore hit (t, row) with t in (tmin, tmax),
//       the lowest row among equal t; a miss writes t = 1e16, row = -1.
//   K6: an int32 flag, 1 when any row is hit in (tmin, tmax).
// Both equal the brute sweep over every row bit for bit, except where a
// ray runs nearly in a triangle's plane: there Moller-Trumbore's t can err
// by more than any finite box margin covers, and a culled chunk can drop a
// hit the brute sweep reports (the same holds for the BVH's boxes).
//
// Design. The TPU kernel tests a whole 1024-ray tile against each 64-row
// chunk, skips a chunk only when no ray of the tile can improve (it has no
// per-lane control flow), and reads no box up to 32 chunks. Here each
// thread owns one ray:
//   - Only rows below `rows` are tested: chunks wholly past it are never
//     entered, the chunk that straddles it stops at it.
//   - From 2 live chunks on, every chunk is culled by its box (above 32
//     chunks each group of 32 first by its super-box). A ray enters the one
//     box of a 1-chunk table anyway (oracle_mat: every ray), so that box is
//     not read. The boxes come padded from sweep_boxes
//     (accel/bvh_traverse.py, the padding of the BVH's sub-leaf group
//     boxes) and are tested with group_slab's relative slack, so that
//     rounding never drops a chunk that holds a hit or a tie.
//   - Above 32 chunks K5 goes nearest first: the groups by their
//     super-box's entry, the chunks of a group by their box's entry, each
//     tested against min(best t, tmax) when it is reached, until the
//     nearest left starts beyond the best t. Ties compare (t, row)
//     outright, so the lowest row still wins. Each ray keeps a mask of the
//     super-boxes it entered (64 at a time), so that picking the next group
//     re-tests only those. Up to 32 chunks (one group) it walks the chunks
//     it enters in table order: there nearest first saved a few chunk tests
//     at most and cost more than it saved.
//   - K6 walks its groups and chunks in table order against tmax and stops
//     at its first hit.
//   - Above 32 chunks the boxes and super-boxes are copied to shared memory
//     once a block, up to 24 KB (mesh_env's 332 boxes: 10.6 KB). Beyond
//     that (a ring shard of big_env: ~1,630 boxes, 52 KB) they are read
//     through L1 as on smaller tables: 52 KB a block would hold an SM to 4
//     blocks of 128 rays where registers allow 9 (on an H100, 1.45 times
//     slower). One block a tile of 128 rays: the block scheduler balances
//     the tiles' unequal work.
//   - A pair is rejected before the IEEE division where u must fail (u < 0
//     far from underflow, or u > 1); the others take the full test,
//     operation for operation, so t is unchanged bit for bit.
//
// Bounds on the card. The rays are read once (32 B) and the result written
// once (4-8 B); a ray tests the rows of the chunks its boxes admit, about
// 25 float operations a row rejected before the division and 50 a row past
// it (no FMA: every op rounds on its own so that t equals the plain sweep
// bit for bit). On oracle_mat (4 live rows) the kernel is bound by the
// rays' bytes; on the larger tables by the rows a ray must test.

#include "ray_tests.cuh"

namespace {

using namespace rt;

constexpr int kThreads = 128;
constexpr int kMinBlocks = 8;  // __launch_bounds__: at most 64 registers a thread
constexpr int kChunk = 64;     // rows per chunk (the flatten's pad_tris_to)
constexpr int kGroup = 32;     // chunks per super-box
constexpr int kCullFrom = 2;   // chunk boxes are read from this many live chunks on
constexpr int kStageBytes = 24 * 1024;  // boxes staged in shared memory up to this size

struct Params {
  const float *rox, *roy, *roz, *rdx, *rdy, *rdz, *tmin, *tmax;
  const float4* tri;
  const float4* boxes;  // sweep_boxes: n_chunks chunk boxes, then the super-boxes
  int n, n_chunks, rows;
  float* t_out;
  int* i_out;
  int* occ_out;
  int* counts;
};

// The chunk geometry of one launch: live chunks and their groups.
struct Layout {
  int chunks;  // chunks holding a row below `rows`
  int groups;  // super-box groups over them (1: no super-box is read)
  int boxes;   // boxes staged: the chunks', then the super-boxes'
};

__host__ __device__ __forceinline__ Layout layout_of(const Params& p) {
  Layout l;
  l.chunks = (p.rows + kChunk - 1) / kChunk;
  l.groups = l.chunks > kGroup ? (l.chunks + kGroup - 1) / kGroup : 1;
  l.boxes = l.chunks + (l.groups > 1 ? l.groups : 0);
  return l;
}

// With kStage the block copies the live chunk boxes, then their super-boxes,
// to shared memory (sm[2b], sm[2b + 1]).
template <bool kStage>
__device__ __forceinline__ void stage(const Params& p, const Layout& l, float4* sm) {
  if constexpr (kStage) {
    for (int b = threadIdx.x; b < l.boxes; b += kThreads) {
      const int src = b < l.chunks ? b : p.n_chunks + (b - l.chunks);
      sm[2 * b] = __ldg(p.boxes + 2 * src);
      sm[2 * b + 1] = __ldg(p.boxes + 2 * src + 1);
    }
    __syncthreads();
  }
}

// The slab test (group_slab) of chunk box k (super-box k with kSuper).
template <bool kStage, bool kSuper>
__device__ __forceinline__ bool box_slab(const Params& p, const Layout& l, const float4* sm,
                                         int k, const Ray& r, float tfar, float* tn) {
  float4 lo, hi;
  if constexpr (kStage) {
    const int s = kSuper ? l.chunks + k : k;
    lo = sm[2 * s];
    hi = sm[2 * s + 1];
  } else {
    const float4* b = p.boxes + 2 * (kSuper ? p.n_chunks + k : k);
    lo = __ldg(b);
    hi = __ldg(b + 1);
  }
  return group_slab(lo, hi, r, tfar, tn);
}

// Moller-Trumbore of moller_trumbore_row (ray_tests.cuh), operation for
// operation, after a pre-test that rejects, before the IEEE division, the
// pairs whose u = u_num * (1 / det) is sure to fail. With s(u_num) = u_num
// with det's sign (u has its sign): |det| below kDetEps (the full test
// requires |det| >= kDetEps); u < 0, s(u_num) below -|det| * 2^-100 (far
// enough from 0 that the product cannot underflow to -0.0, which passes
// u >= 0); u > 1, s(u_num) above |det| * (1 + 2^-20) (then u + v > 1 for
// every v >= 0; the margin covers the roundings of 1 / det and the
// product). The pairs it passes give the full test's t and verdict bit for
// bit. Its plain mirror is accel/sweep.py mt_pretest.
__device__ __forceinline__ bool mt_cheap(const float4 a, const float4 b, const float4 c,
                                         const Ray& r, float* t_out) {
  const float p0x = a.x, p0y = a.y, p0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float adet = fabsf(det);
  if (!(adet >= kDetEps)) return false;
  const float tvx = r.ox - p0x;
  const float tvy = r.oy - p0y;
  const float tvz = r.oz - p0z;
  const float un = tvx * pvx + tvy * pvy + tvz * pvz;
  const float su = det < 0.0f ? -un : un;
  if (su < -(adet * 0x1p-100f) || su > adet * 0x1.00001p+0f) return false;
  const float inv = 1.0f / det;
  const float u = un * inv;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv;
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
  *t_out = t;
  return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > r.tmn && t < r.tmx;
}

__device__ __forceinline__ bool row_test(const float4* __restrict__ tri, int row, const Ray& r,
                                         float* t) {
  const float4* q = tri + (size_t)row * 3;
  return mt_cheap(__ldg(q), __ldg(q + 1), __ldg(q + 2), r, t);
}

struct Counts {
  int entered = 0, tested = 0, rows = 0;
};

// The mask of chunks [c0, c0 + nk) whose boxes the ray enters against tfar.
template <bool kStage>
__device__ __forceinline__ unsigned entered_mask(const Params& p, const Layout& l,
                                                 const float4* sm, int c0, int nk, const Ray& r,
                                                 float tfar) {
  unsigned mask = 0;
  float tn;
  for (int k = 0; k < nk; ++k) {
    mask |= (unsigned)box_slab<kStage, false>(p, l, sm, c0 + k, r, tfar, &tn) << k;
  }
  return mask;
}

// Chunk c's rows below `rows` against the best (t, row): a row replaces it
// when its t is lower, or equal with a lower row (chunks come in any order).
__device__ __forceinline__ void chunk_closest(const Params& p, int c, const Ray& r,
                                              float& tbest, int& ibest) {
  const int end = min((c + 1) * kChunk, p.rows);
  for (int j = c * kChunk; j < end; ++j) {
    float t;
    if (row_test(p.tri, j, r, &t) && (t < tbest || (t == tbest && j < ibest))) {
      tbest = t;
      ibest = j;
    }
  }
}

// K5 on one ray, nearest first, for tables above 32 chunks: the groups
// whose super-boxes it enters in order of their entry (then group), each
// group's chunks whose boxes it enters in order of their entry (then
// chunk), each against min(best t, tmax) when it is reached; a group or
// chunk that starts beyond the best t is dropped, one that starts at it is
// still tested. The groups are taken 64 at a time: a mask of the super-boxes
// entered against tmax, each pick re-testing only those left. A box's entry
// t does not depend on the far limit, so the order is fixed per ray.
template <bool kStage, bool kCount>
__device__ __forceinline__ void closest_nearest_first(const Params& p, const Layout& l,
                                                      const float4* sm, const Ray& r,
                                                      float& tbest, int& ibest, Counts& cnt) {
  for (int w = 0; w < l.groups; w += 64) {
    const int nw = min(64, l.groups - w);
    unsigned long long gm = 0;
    for (int h = 0; h < nw; ++h) {
      float tn;
      gm |= (unsigned long long)box_slab<kStage, true>(p, l, sm, w + h, r, r.tmx, &tn) << h;
    }
    while (gm) {
      const float tfar_g = fminf(tbest, r.tmx);
      int g = -1;
      float tg = CUDART_INF_F;
      for (unsigned long long m = gm; m; m &= m - 1) {
        const int h = __ffsll(m) - 1;
        float tn;
        if (!box_slab<kStage, true>(p, l, sm, w + h, r, tfar_g, &tn)) {
          gm &= ~(1ull << h);
        } else if (tn < tg) {
          tg = tn;
          g = h;
        }
      }
      if (g < 0) break;
      gm &= ~(1ull << g);
      const int c0 = (w + g) * kGroup;
      unsigned mask = entered_mask<kStage>(p, l, sm, c0, min(kGroup, l.chunks - c0), r, tfar_g);
      if constexpr (kCount) cnt.entered += __popc(mask);
      while (mask) {
        const float tfar = fminf(tbest, r.tmx);
        int k_near = -1;
        float t_near = CUDART_INF_F;
        for (unsigned m = mask; m; m &= m - 1) {
          const int k = __ffs(m) - 1;
          float tn;
          if (!box_slab<kStage, false>(p, l, sm, c0 + k, r, tfar, &tn)) {
            mask &= ~(1u << k);
          } else if (tn < t_near) {
            t_near = tn;
            k_near = k;
          }
        }
        if (k_near < 0) break;
        mask &= ~(1u << k_near);
        const int c = c0 + k_near;
        if constexpr (kCount) {
          cnt.tested += 1;
          cnt.rows += min(kChunk, p.rows - c * kChunk);
        }
        chunk_closest(p, c, r, tbest, ibest);
      }
    }
  }
}

// K5 on one ray in table order, for tables of up to 32 chunks (one group):
// the mask of chunks whose boxes it enters against min(best t, tmax),
// walked in table order, each box tested again once the best t has shrunk;
// a strictly lower t replaces the best, so the lowest row keeps a tie.
// There nearest first tests as many chunks or a few fewer and costs more
// (PERF.md).
template <bool kStage, bool kCount>
__device__ __forceinline__ void closest_table_order(const Params& p, const Layout& l,
                                                    const float4* sm, const Ray& r,
                                                    float& tbest, int& ibest, Counts& cnt) {
  const float tmask = fminf(tbest, r.tmx);
  unsigned m = entered_mask<kStage>(p, l, sm, 0, l.chunks, r, tmask);
  if constexpr (kCount) cnt.entered += __popc(m);
  for (; m; m &= m - 1) {
    const int c = __ffs(m) - 1;
    const float tfar = fminf(tbest, r.tmx);
    float tn;
    if (tfar != tmask && !box_slab<kStage, false>(p, l, sm, c, r, tfar, &tn)) continue;
    if constexpr (kCount) {
      cnt.tested += 1;
      cnt.rows += min(kChunk, p.rows - c * kChunk);
    }
    const int end = min((c + 1) * kChunk, p.rows);
    for (int j = c * kChunk; j < end; ++j) {
      float t;
      if (row_test(p.tri, j, r, &t) && t < tbest) {
        tbest = t;
        ibest = j;
      }
    }
  }
}

// K6 on one ray, in table order: the groups whose super-boxes it enters,
// the chunks of each whose boxes it enters against tmax (the mask of a
// group's 32 boxes first), until its first hit. Testing each box only when
// it is reached lets an early hit skip the rest of the mask, but measured
// 14-28% slower on bounce and shadow rays, which mostly miss (PERF.md).
template <bool kStage>
__device__ __forceinline__ void anyhit_table_order(const Params& p, const Layout& l,
                                                   const float4* sm, const Ray& r, int& occ) {
  for (int g = 0; g < l.groups && !occ; ++g) {
    float tn;
    if (l.groups > 1 && !box_slab<kStage, true>(p, l, sm, g, r, r.tmx, &tn)) continue;
    const int c0 = g * kGroup;
    for (unsigned m = entered_mask<kStage>(p, l, sm, c0, min(kGroup, l.chunks - c0), r, r.tmx);
         m && !occ; m &= m - 1) {
      const int c = c0 + __ffs(m) - 1;
      const int end = min((c + 1) * kChunk, p.rows);
      float t;
      for (int j = c * kChunk; j < end && !occ; ++j) occ = row_test(p.tri, j, r, &t) ? 1 : 0;
    }
  }
}

// One ray a thread: K5's closest hit (t, row), or K6's flag (kAny). A table
// of one live chunk is tested whole (its one box is not read). kCount: the
// measurement form of K5, which also writes per ray (N, 4) int32 [chunks
// whose boxes it entered when their groups were reached, chunks it tested,
// rows it tested, the same rows (all below `rows`)].
template <bool kAny, bool kStage, bool kCount>
__device__ __forceinline__ void sweep_ray(const Params& p) {
  extern __shared__ float4 sm[];
  const Layout l = layout_of(p);
  stage<kStage>(p, l, sm);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  const Ray r = load_ray(i, p.rox, p.roy, p.roz, p.rdx, p.rdy, p.rdz, p.tmin, p.tmax);
  float tbest = kMaxDistance;
  int ibest = -1;
  int occ = 0;
  Counts cnt;
  if (r.tmx > r.tmn) {  // culled lanes (empty interval) miss
    if (l.chunks < kCullFrom) {
      for (int j = 0; j < p.rows && !occ; ++j) {
        float t;
        if (!row_test(p.tri, j, r, &t)) continue;
        if (kAny) {
          occ = 1;
        } else if (t < tbest) {
          tbest = t;
          ibest = j;
        }
      }
      if constexpr (kCount) {
        cnt.entered = cnt.tested = l.chunks;
        cnt.rows = p.rows;
      }
    } else if constexpr (kAny) {
      anyhit_table_order<kStage>(p, l, sm, r, occ);
    } else if (l.groups <= 1) {
      closest_table_order<kStage, kCount>(p, l, sm, r, tbest, ibest, cnt);
    } else {
      closest_nearest_first<kStage, kCount>(p, l, sm, r, tbest, ibest, cnt);
    }
  }
  if constexpr (kAny) {
    p.occ_out[i] = occ;
  } else {
    p.t_out[i] = tbest;
    p.i_out[i] = ibest;
  }
  if constexpr (kCount) {
    reinterpret_cast<int4*>(p.counts)[i] = make_int4(cnt.entered, cnt.tested, cnt.rows, cnt.rows);
  }
}

template <bool kStage, bool kCount>
__global__ void __launch_bounds__(kThreads, kMinBlocks) sweep_closest_kernel(const Params p) {
  sweep_ray<false, kStage, kCount>(p);
}

template <bool kStage>
__global__ void __launch_bounds__(kThreads, kMinBlocks) sweep_anyhit_kernel(const Params p) {
  sweep_ray<true, kStage, false>(p);
}

// One block a tile of 128 rays (the block scheduler balances the tiles'
// unequal work); boxes staged above 32 chunks, up to kStageBytes.
template <class K>
int launch_grid(K stage_kernel, K global_kernel, const Params& p, cudaStream_t stream) {
  if (p.n <= 0) return static_cast<int>(cudaGetLastError());
  const Layout l = layout_of(p);
  const size_t bytes = (size_t)l.boxes * 32;
  const int blocks = (p.n + kThreads - 1) / kThreads;
  if (l.chunks <= kGroup || bytes > kStageBytes) {
    global_kernel<<<blocks, kThreads, 0, stream>>>(p);
  } else {
    stage_kernel<<<blocks, kThreads, bytes, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

Params params(const float* rox, const float* roy, const float* roz, const float* rdx,
              const float* rdy, const float* rdz, const float* tmin, const float* tmax,
              const float* tri, const float* boxes, int n, int n_chunks, int rows) {
  Params p;
  p.rox = rox; p.roy = roy; p.roz = roz; p.rdx = rdx; p.rdy = rdy; p.rdz = rdz;
  p.tmin = tmin; p.tmax = tmax;
  p.tri = reinterpret_cast<const float4*>(tri);
  p.boxes = reinterpret_cast<const float4*>(boxes);
  p.n = n; p.n_chunks = n_chunks; p.rows = rows;
  p.t_out = nullptr; p.i_out = nullptr; p.occ_out = nullptr; p.counts = nullptr;
  return p;
}

}  // namespace

// boxes: sweep_boxes of the table, (n_chunks + G, 8) with G super-boxes
// when n_chunks > 32, else none (read from 2 live chunks on); rows: the
// rows below which the table holds triangles (0 <= rows <= n_chunks * 64).
extern "C" int launch_sweep_closest(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, const float* tmin, const float* tmax,
    const float* tri, const float* boxes, int n, int n_chunks, int rows, float* t_out,
    int* i_out, cudaStream_t stream) {
  Params p = params(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, boxes, n, n_chunks, rows);
  p.t_out = t_out;
  p.i_out = i_out;
  return launch_grid(sweep_closest_kernel<true, false>, sweep_closest_kernel<false, false>, p,
                     stream);
}

extern "C" int launch_sweep_anyhit(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, const float* tmin, const float* tmax,
    const float* tri, const float* boxes, int n, int n_chunks, int rows, int* occ_out,
    cudaStream_t stream) {
  Params p = params(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, boxes, n, n_chunks, rows);
  p.occ_out = occ_out;
  return launch_grid(sweep_anyhit_kernel<true>, sweep_anyhit_kernel<false>, p, stream);
}

// K5 with per-ray counts ((n, 4) int32, see sweep_ray), for measurement
// only: no wrapper, no path launches it.
extern "C" int launch_sweep_closest_visits(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, const float* tmin, const float* tmax,
    const float* tri, const float* boxes, int n, int n_chunks, int rows, float* t_out,
    int* i_out, int* counts, cudaStream_t stream) {
  Params p = params(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, boxes, n, n_chunks, rows);
  p.t_out = t_out;
  p.i_out = i_out;
  p.counts = counts;
  return launch_grid(sweep_closest_kernel<true, true>, sweep_closest_kernel<false, true>, p,
                     stream);
}
