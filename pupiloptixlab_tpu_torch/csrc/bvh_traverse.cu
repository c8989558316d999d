// Wide-BVH ray traversal for Hopper: closest hit (K1) and any hit (K2) over
// world-space tables, and their instanced forms K7 and K8.
//
// Replaces the Pallas TPU kernels of pupiloptixlab_tpu/accel/pallas_bvh.py:
//   launch_bvh_closest      <- _make_closest_kernel, resident and stream=True
//                              (the streamed form differs only in how the TPU
//                              brings leaf rows to its core), via bvh_closest
//   launch_bvh_anyhit       <- _make_anyhit_kernel, resident and stream=True,
//                              via bvh_anyhit
//   launch_bvh_closest_inst <- _make_closest_kernel(instanced=True)
//   launch_bvh_anyhit_inst  <- _make_anyhit_kernel(instanced=True)
//   launch_bvh_closest_mt   <- _make_closest_kernel_mxu (bvh_closest(mxu=True),
//                              pallas_bvh.py:599), via bvh_closest_mt
//   launch_bvh_closest_count <- _make_closest_kernel(count_iters=True)
//                              (pallas_bvh.py:514-590), via
//                              bvh_closest(count_iters=True)
//   launch_bvh_closest_visits   K1 with four counts a tile, for measurement
//                              only (no wrapper, no path launches it)
//   launch_bvh_closest_mt_at, launch_bvh_closest_mt_visits   K10 with some or
//                              all leaves on the CUDA cores, the latter with
//                              counts, for measurement and as the filter's
//                              reference (no wrapper, no path launches them)
//
// What it computes: per ray, over the 8-wide BVH of accel/bvh.py (child ids
// with leaves encoded as -(id+1), one split axis per node, 8 child boxes of
// 8 floats per node) and the (T, 12) [p0, e1, e2, pad] triangle table:
//   K1: the closest Moller-Trumbore hit (t, row) with t in (tmin, tmax);
//       a miss writes t = 1e16, row = -1.
//   K2: an int32 flag, 1 when any triangle is hit in (tmin, tmax).
//   K11: K1's (t, row), bit for bit, and per tile of 1024 consecutive rays
//       two int32 sums over its rays: [pops, leaves]. pops counts the stack
//       entries of inner nodes (id >= 0) that a ray takes off its stack,
//       those pruned because their entry t exceeds the best t included;
//       leaves counts the leaf entries (id < 0) it takes off and tests (a
//       pruned leaf entry is not tested and not counted). A lane with an
//       empty interval counts 0. The root is the first inner pop.
// Baked tables: a leaf id is -(row+1), the leaf's first row.
//
// K1/K2/K11's sub-leaf level (baked trees). A baked leaf holds tcl rows in
// the tree build's argpartition order, in no spatial order, and K1 used to
// test all of them at every leaf it visited (big_env: 55-75 rows a ray
// for at most one hit). The port's own table subleaf (accel/bvh_traverse.py
// make_baked_subleaf; not the reference's) holds a leaf-local order of the
// rows, one byte a row, that splits each leaf's live rows into
// kGroups = 8 spatial groups (three levels of median splits along the
// widest centroid axis), and one world box a group, padded (2^-13 of the
// box's largest coordinate plus 2^-19 of the table's) and tested with a
// relative slack (group_slab) so that rounding never drops a group holding
// a row Moller-Trumbore accepts. At a leaf the 8 boxes and the order bytes
// are loaded together and slab-tested against min(best t, tmax); K1 and
// K11 take the groups nearest entry first (the lower group on equal entry)
// and stop once the nearest group left starts strictly beyond the best t;
// K2 takes them in table order and stops at its first hit. A group's rows
// are tested together (tcl / 8 of them, a compile-time count: the kernels
// are instantiated for tcl 16, 32, 64 and 128, and the launchers refuse
// any other), up to 4 rows' loads issued before the first test. The
// tree, the pops and leaves K11 counts and the results are unchanged:
// ties compare (t, row) outright, so the order in which rows are tested
// does not matter; an all-pass table (every box +-1e30, the
// rows in table order) makes the kernels the full leaf scan again, which
// chip_smoke.py holds them against at full N.
//
// Inner nodes of the baked forms (K10's too): the node's 16 box loads and
// its 8 child ids are issued before its first slab test, so they are in
// flight together (the former loop, which the instanced form keeps, tests
// and pushes child by child, each load behind the previous child's
// branches); the push order and the prune rule are the former ones.
// Instanced tables (flatten/instanced.py): the tree is a world tree over
// per-instance leaf boxes built at one leaf per slot, and a leaf id -(li+1)
// indexes leaf_start / leaf_inst; the triangle table holds unique
// OBJECT-space rows. At a leaf the ray is mapped into the instance's object
// space through its 3x4 world-to-object matrix (w0*x + w1*y + w2*z + w3,
// summed left to right; directions are not renormalised, so t stays the
// world parameter) and tested against the leaf's tcl rows. Tree boxes are
// world boxes tested with the world ray.
//   K7: closest (t, unique row, world leaf); a miss writes (1e16, -1, -1).
//   K8: the any-hit flag.
//
// K7/K8's sub-leaf level. A world leaf holds tcl = 64 rows on the
// 64-instance scene (the reference doubles tcl to keep under 12,000 world
// leaves); testing every row of each leaf a ray visits comes to ~260 rows
// a ray for at most one hit, and the floor's leaf holds 62 zero rows. The
// port's own table subleaf (accel/bvh_traverse.py
// make_subleaf_boxes; not the reference's) holds 8 object-space boxes per
// unique leaf, one for each group of tcl / 8 consecutive (Morton-ordered)
// rows, widened by a small margin so that rounding in the slab test never
// drops a group holding a row that Moller-Trumbore accepts; a group of
// padding rows alone holds the never-box. At a world leaf the ray is mapped
// into object space (K7: once for a run of consecutive leaves of one
// instance), with the inverse and zero-component flag of its object
// direction (the slab test's inputs), the 8 boxes are slab-tested,
// and only the rows of the groups it enters are tested: K7 takes them
// nearest entry first (the lower group on equal entry) against tfar =
// min(best t, tmax) and stops once the nearest group left starts strictly
// beyond the best t; K8 takes them in table order against tmax and stops
// at the first hit. The reference's tables, the world tree and the
// results are unchanged: a row skipped lies in a group the ray does not
// enter before the best t, so it could not have won; an all-pass table
// (every box +-1e30) makes the kernels the full leaf scan again, which
// chip_smoke.py holds them against at full N.
// Linear-form leaves (K10, baked tables with 32-row leaves): the tree and
// the result are K1's, but each row is tested through the reference's
// linear form (_mt_cols_table): det, u*det, v*det and t*det are 10-term dots
// of the ray's features f = [d, (o-c) x d, o-c, 1] (c: the mean of the rows'
// p0, computed once per call) with the row's 40 table floats
// [det(10) | u(10) | v(10) | t(10)] (accel/bvh_traverse.py mt_rows_table), of
// which 21 are structural zeros; a hit needs |det| >= 1e-12, u*det*det >= 0,
// v*det*det >= 0, (det-u-v)*det >= 0 and tmin < t < tmax with
// t = (t*det) / det.
//
// Design. The TPU kernel walks a 1024-ray TILE through the tree together
// because the TPU has no per-lane control flow; Hopper does, so here each
// thread walks the tree for its own ray with a private stack (128 entries of
// node id and entry t in local memory, the reference's STACK_SIZE; the
// wrapper checks 7 * depth + 1 <= 128 from the depth the flatten records,
// so trees up to depth 18 are walked). Only the entries a walk reaches are
// touched, so a shallow tree pays the larger stack in reserved local memory,
// not in traffic; one stack size keeps one code path for every tree. Children are pushed far-to-near by the ray's own
// direction sign along the node's split axis (children are stored sorted
// along it), so the near child pops first. One templated body serves the
// baked and instanced (kInst) closest-hit forms, so both share the
// traversal loop; K10 walks with K1's node step in a warp-synchronous loop
// of its own (bvh_closest_mt_kernel).
//
// K11's design. The TPU walks a 1024-ray tile in lockstep, so its count is
// the tile's loop iterations, packed as pops * 65536 + leaves into every
// lane's idx. Here each ray walks alone, so the cost of the same kind is a
// sum over the tile's rays. It is K1's body behind kCount: each thread counts
// in registers, a block of 128 threads sums its counts with one warp
// reduction and a shared-memory pass, and one thread adds the block's two
// sums into its tile's slot with integer atomicAdd (8 blocks a tile;
// integer sums are exact and independent of order). The counts go to their
// own (N / 1024, 2) output: a tile's pops can pass 32,767, and pops * 65536
// would overflow int32. Bound: K1's, plus two atomics per 128 rays.
//
// Bounds on the card: traversal is latency-bound on dependent loads of node
// boxes (32 B) and leaf rows (48 B) plus divergence between the rays of a
// warp. Rays are 128-thread blocks in the caller's lane order; on the main
// path primary rays arrive in 8x128 pixel blocks, so a warp's rays are
// coherent. The TPU streams tables above 8 MB through a DMA ring because its
// core holds ~16 MB; here every table is read from device memory through the
// read-only path and the 50 MB L2 (big_env: 19.4 MB of rows, 0.4 MB of
// boxes), so one kernel serves both sizes. The instanced unique table is
// small (the 64-instance scene: 396 KB, its sub-leaf boxes 33 KB) and stays
// in L2. Sorting secondary
// rays for coherence is left to later, measured work.
//
// K10's design. The TPU runs the leaf test as one (10,128) x (10,N) product
// on its matrix unit, for a tile of 1024 rays that walk the tree together.
// Here each lane walks its own ray (K1's stack and node step), but the
// walk is warp-synchronous: a lane walks until it takes a leaf off its
// stack, then the warp meets for a leaf step (bvh_closest_mt_kernel). Each
// pending leaf goes through the tensor cores once for the lanes that share
// it: a TF32 m16n8k8 product of the 32 rays'
// features [d, (o-c) x d] with the leaf's u*det, v*det and w*det columns,
// kept in fragment order (one 16-byte load a lane per m16n8k8 B pair), is
// a sound FILTER (tc_filter: a pair whose three values surely differ in
// sign is rejected, the margin bounding the TF32 product's error from the
// row's and the ray's norms); the rows that pass (about 2 of 32 on
// mesh_env's hit leaves) are tested by their lane on the CUDA cores
// through the linear form's 19 non-zero products
// (lean_form: 80 B a row instead of 160, and no division for a row that
// fails its sign tests). t*det, which only the exact test needs, stays off
// the tensor cores. Both tests are the plain version's arithmetic, so the
// result is the plain linear-form sweep's bit for bit whichever way a leaf
// goes, and chip_smoke.py holds the tensor-core path against the same
// kernel with every leaf on the CUDA cores (launch_bvh_closest_mt_at) on
// every lane of five ray sets.
// The reference takes an approximate reciprocal and one Newton step for
// 1/det (pallas_bvh.py:673-675); this kernel divides in IEEE.
//
// Exactness. The slab test (ray_tests.cuh) is exactly _slab8 with tfar
// clamped by the running best t, and the leaf test is _mt_planes with IEEE
// 1/det under -fmad=false (the instance transform too), so t is
// bit-identical to the plain PyTorch versions. Ties at equal t keep the
// lowest row (K1, K11), or the lowest world leaf and then the lowest row
// (K7: the rule of the reference's plain leaf scan, intersect.py:447-505),
// compared outright, since the groups of a leaf come in no fixed order,
// which makes the result independent of visit order. Entries are pruned only when their
// box starts strictly beyond the best t, so a tied leaf is still visited.
// Hidden instances carry a zero matrix: their object-space direction is 0,
// so det = 0 fails |det| >= 1e-12 (no NaN). Empty child slots carry child id
// 0 with a never-hit point box at 1e30; id 0 is never pushed as a child, and
// a visit cap (every slot of the tree once) sets an error flag that the
// wrapper raises on.

#include <type_traits>

#include "ray_tests.cuh"

namespace {

using namespace rt;

constexpr int kStack = 128;
constexpr int kThreads = 128;
constexpr int kTile = 1024;  // rays per K11 count tile

enum : int { kErrVisitCap = 1, kErrStack = 2, kErrLeafGrid = 4 };

constexpr int kGroups = 8;  // sub-leaf groups of a leaf (baked and unique leaves)

// Leaf tables of an instanced scene (unused by the baked form).
struct InstTables {
  const int* leaf_start;  // (L,) first unique row of each world leaf
  const int* leaf_inst;   // (L,) instance of each world leaf
  const float* w2o;       // (I, 12) world-to-object 3x4, row-major
  const float4* subleaf;  // (T / tcl * 8, 8) object-space group boxes
  int n_leaves;
};

// K10's tables (accel/bvh_traverse.py mt_kernel_tables).
struct MtTables {
  const float4* lean;   // (T, 20) as 5 float4 per row: the 19 products' factors
  const float4* frag;   // (T / 32 * 256) float4: per leaf, the warp's B fragments
  const float* center;  // (3,) recentring point
};

// The sub-leaf table of a baked tree (K1, K2, K11; unused by the others).
struct SubTable {
  const uint8_t* order;  // (T,) leaf-local row of each slot, group-major
  const float4* boxes;   // (T / tcl * kGroups, 8) world group boxes
};

// The linear-form test of one row through its 19 non-zero products: the
// table's row is [det 0-2 | u 0-5 | v 0-5 | t 6-9 | 0] (mt_lean_table), and
// each dot is summed left to right over its non-zero terms (unfused under
// -fmad=false). The plain version's 40-term dots add the other 21 terms as
// signed zeros, which change a value only where it is zero, and then only
// its sign: no decision and no hit's t (tests/test_torch_mt_filter.py). A
// row that fails the sign tests skips the division.
__device__ __forceinline__ bool lean_form(const float4* __restrict__ row,
                                          const float (&f)[10], const Ray& r,
                                          float* t_out) {
  const float4 q0 = __ldg(row), q1 = __ldg(row + 1), q2 = __ldg(row + 2);
  const float4 q3 = __ldg(row + 3), q4 = __ldg(row + 4);
  const float det = f[0] * q0.x + f[1] * q0.y + f[2] * q0.z;
  const float up = f[0] * q0.w + f[1] * q1.x + f[2] * q1.y + f[3] * q1.z + f[4] * q1.w +
                   f[5] * q2.x;
  const float vp = f[0] * q2.y + f[1] * q2.z + f[2] * q2.w + f[3] * q3.x + f[4] * q3.y +
                   f[5] * q3.z;
  if (!(fabsf(det) >= kDetEps && up * det >= 0.0f && vp * det >= 0.0f &&
        (det - up - vp) * det >= 0.0f)) {
    return false;
  }
  const float tp = f[6] * q3.w + f[7] * q4.x + f[8] * q4.y + f[9] * q4.z;
  const float t = tp / det;  // |det| >= kDetEps here
  *t_out = t;
  return t > r.tmn && t < r.tmx;
}

__device__ __forceinline__ int baked_start(int id, int t_rows, int tcl) {
  // clamp_leaf of the reference: rows [start, start + tcl) stay in the table
  const int s = -(id + 1);
  return min(max(s, 0), t_rows - tcl);
}

// The world-leaf index of a leaf id, clamped as the reference clips it.
__device__ __forceinline__ int world_leaf(int id, const InstTables& it) {
  return min(max(-(id + 1), 0), it.n_leaves - 1);
}

// The ray in the object space of one instance: w0*x + w1*y + w2*z + w3,
// summed left to right (unfused under -fmad=false), as the plain leaf scan,
// with the inverse direction and the zero-component flag of the OBJECT
// direction (the group boxes are slab-tested in object space, where a
// component may be exactly 0 although the world direction has none).
__device__ __forceinline__ Ray to_object(const Ray& r, const float* __restrict__ w) {
  const float w0 = __ldg(w + 0), w1 = __ldg(w + 1), w2 = __ldg(w + 2), w3 = __ldg(w + 3);
  const float w4 = __ldg(w + 4), w5 = __ldg(w + 5), w6 = __ldg(w + 6), w7 = __ldg(w + 7);
  const float w8 = __ldg(w + 8), w9 = __ldg(w + 9), w10 = __ldg(w + 10),
              w11 = __ldg(w + 11);
  Ray o = r;
  o.ox = w0 * r.ox + w1 * r.oy + w2 * r.oz + w3;
  o.oy = w4 * r.ox + w5 * r.oy + w6 * r.oz + w7;
  o.oz = w8 * r.ox + w9 * r.oy + w10 * r.oz + w11;
  o.dx = w0 * r.dx + w1 * r.dy + w2 * r.dz;
  o.dy = w4 * r.dx + w5 * r.dy + w6 * r.dz;
  o.dz = w8 * r.dx + w9 * r.dy + w10 * r.dz;
  o.ix = safe_inv(o.dx);
  o.iy = safe_inv(o.dy);
  o.iz = safe_inv(o.dz);
  o.axis0 = o.dx == 0.0f || o.dy == 0.0f || o.dz == 0.0f;
  return o;
}

// The first row of world leaf li's unique leaf, clamped as the reference
// clamps it; a start off the tcl grid (which the flatten never writes)
// would read groups of two unique leaves, and sets the fault flag.
__device__ __forceinline__ int inst_start(int li, const InstTables& it, int t_rows,
                                          int tcl, int* err) {
  const int s = min(max(__ldg(it.leaf_start + li), 0), t_rows - tcl);
  if (s % tcl) atomicOr(err, kErrLeafGrid);
  return s;
}

// The 8 child boxes of node id, all 16 loads issued before any test, then
// slab-tested against tfar: the mask of the children that pass, and their
// entry t. The 8 child ids come in two 16-byte loads beside them.
__device__ __forceinline__ unsigned test_children(const float4* __restrict__ boxes,
                                                  const int* __restrict__ child, int id,
                                                  const Ray& r, float tfar, float (&tn)[8],
                                                  int (&ch)[8]) {
  const float4* nb = boxes + (size_t)id * 16;
  float4 b[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) b[q] = __ldg(nb + q);
  const int4* nc = reinterpret_cast<const int4*>(child + (size_t)id * 8);
  const int4 c0 = __ldg(nc), c1 = __ldg(nc + 1);
  ch[0] = c0.x; ch[1] = c0.y; ch[2] = c0.z; ch[3] = c0.w;
  ch[4] = c1.x; ch[5] = c1.y; ch[6] = c1.z; ch[7] = c1.w;
  unsigned ok = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    ok |= (unsigned)slab_box(b[2 * k], b[2 * k + 1], r, tfar, &tn[k]) << k;
  }
  return ok;
}

// A baked leaf's sub-leaf data: its kTcl order bytes as kTcl / 4 words
// (16-byte loads) and its group boxes slab-tested against tfar, all loads
// issued before the first test; returns the mask of the groups that pass
// and their entry t.
template <int kTcl>
__device__ __forceinline__ unsigned leaf_groups(const SubTable& sub, int s, const Ray& r,
                                                float tfar, uint32_t (&ow)[kTcl / 4],
                                                float (&gtn)[kGroups]) {
  const uint4* ord = reinterpret_cast<const uint4*>(sub.order + s);
#pragma unroll
  for (int q = 0; q < kTcl / 16; ++q) {
    const uint4 v = __ldg(ord + q);
    ow[4 * q] = v.x; ow[4 * q + 1] = v.y; ow[4 * q + 2] = v.z; ow[4 * q + 3] = v.w;
  }
  const float4* gb = sub.boxes + (size_t)(s / kTcl) * (2 * kGroups);
  float4 b[2 * kGroups];
#pragma unroll
  for (int q = 0; q < 2 * kGroups; ++q) b[q] = __ldg(gb + q);
  unsigned ok = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    ok |= (unsigned)group_slab(b[2 * g], b[2 * g + 1], r, tfar, &gtn[g]) << g;
  }
  return ok;
}

// Word q of a register array, q known only at run time, by selects (an
// indexed register array would go to local memory).
template <int kW>
__device__ __forceinline__ uint32_t pick_word(const uint32_t (&w)[kW], int q) {
  uint32_t x = w[0];
#pragma unroll
  for (int k = 1; k < kW; ++k) x = q == k ? w[k] : x;
  return x;
}

// Moller-Trumbore on the kGr rows of one group, up to 4 rows' loads issued
// before their first test (each test's IEEE division branches, which would
// otherwise hold the next row's loads behind it).
template <int kGr>
__device__ __forceinline__ void test_rows(const float4* __restrict__ tri, const int (&rw)[kGr],
                                          const Ray& r, float (&t)[kGr], bool (&hit)[kGr]) {
  constexpr int kB = kGr < 4 ? kGr : 4;
#pragma unroll
  for (int j0 = 0; j0 < kGr; j0 += kB) {
    float4 q[3 * kB];
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const float4* row = tri + (size_t)rw[j0 + j] * 3;
      q[3 * j] = __ldg(row);
      q[3 * j + 1] = __ldg(row + 1);
      q[3 * j + 2] = __ldg(row + 2);
    }
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      hit[j0 + j] = moller_trumbore_row(q[3 * j], q[3 * j + 1], q[3 * j + 2], r, &t[j0 + j]);
    }
  }
}

// The table rows of group g of the leaf at row s: s + its order bytes.
template <int kTcl>
__device__ __forceinline__ void group_rows(const uint32_t (&ow)[kTcl / 4], int g, int s,
                                           int (&rows)[kTcl / kGroups]) {
  constexpr int kGr = kTcl / kGroups;
  if constexpr (kGr == 2) {
    const uint32_t x = pick_word<kTcl / 4>(ow, g >> 1) >> ((g & 1) * 16);
    rows[0] = s + (int)(x & 0xffu);
    rows[1] = s + (int)((x >> 8) & 0xffu);
  } else {
#pragma unroll
    for (int q = 0; q < kGr / 4; ++q) {
      const uint32_t x = pick_word<kTcl / 4>(ow, g * (kGr / 4) + q);
#pragma unroll
      for (int b = 0; b < 4; ++b) rows[4 * q + b] = s + (int)((x >> (8 * b)) & 0xffu);
    }
  }
}

// kCount: 0 none; 2 K11's [pops, leaves]; 4 also [groups entered, rows
// tested] (the measurement launchers). kTcl: the baked form's leaf size
// (0 for the instanced form, which takes tcl at run time).
template <bool kInst, int kCount, int kTcl>
__global__ void __launch_bounds__(kThreads)
bvh_closest_kernel(const float* __restrict__ rox, const float* __restrict__ roy,
                   const float* __restrict__ roz, const float* __restrict__ rdx,
                   const float* __restrict__ rdy, const float* __restrict__ rdz,
                   const float* __restrict__ tmin, const float* __restrict__ tmax,
                   const float4* __restrict__ tri, const int* __restrict__ child,
                   const int* __restrict__ axis, const float4* __restrict__ boxes,
                   const InstTables it, const SubTable sub, int n,
                   int t_rows, int tcl, int n_nodes, float* __restrict__ t_out,
                   int* __restrict__ i_out, int* __restrict__ l_out,
                   int* __restrict__ counts, int* __restrict__ err) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  // a counting launch runs n / kThreads full blocks (the launchers require
  // n % kTile == 0), so no thread leaves before its block's reduction
  if (i >= n) return;
  const Ray r = load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin, tmax);
  float tbest = kMaxDistance;
  int ibest = -1;
  int lbest = -1;  // world leaf of the best hit (instanced form)
  // the counts of this ray: pops, leaves, groups entered, rows tested
  int pops = 0, leaves = 0, groups = 0, rows = 0;
  if (r.tmx > r.tmn) {  // culled lanes (empty interval) return at once
    int stack[kStack];
    float stack_tn[kStack];
    int sp = 0;
    stack[sp] = 0;
    stack_tn[sp] = r.tmn;
    ++sp;
    int visits = n_nodes * 8 + 1;  // every slot of the tree at most once
    int cur_inst = -1;  // K7: the instance whose object space ro is in
    Ray ro = r;
    while (sp > 0) {
      if (--visits < 0) { atomicOr(err, kErrVisitCap); break; }
      --sp;
      const int id = stack[sp];
      if constexpr (kCount > 0) pops += id >= 0;
      // entries whose box starts beyond the best hit cannot improve it
      // (ties stay: the slab test's tn <= tf is inclusive too)
      if (stack_tn[sp] > tbest) continue;
      if (id < 0) {
        if constexpr (kCount > 0) ++leaves;
        if constexpr (kInst) {
          const int li = world_leaf(id, it);
          const int s = inst_start(li, it, t_rows, tcl, err);
          // consecutive leaves of one instance share its object-space ray
          const int inst = __ldg(it.leaf_inst + li);
          if (inst != cur_inst) {
            ro = to_object(r, it.w2o + (size_t)inst * 12);
            cur_inst = inst;
          }
          const float4* gbox = it.subleaf + (size_t)(s / tcl) * (2 * kGroups);
          const int gr = tcl / kGroups;
          const float tfar = fminf(tbest, r.tmx);
          float gtn[kGroups];
          unsigned todo = 0;
#pragma unroll
          for (int g = 0; g < kGroups; ++g) {
            if (slab(gbox + 2 * g, ro, tfar, &gtn[g])) todo |= 1u << g;
          }
          while (todo) {
            // the nearest group left, the lower one on equal entry t
            int gs = -1;
            float ts = CUDART_INF_F;
#pragma unroll
            for (int g = 0; g < kGroups; ++g) {
              if (((todo >> g) & 1u) && gtn[g] < ts) {
                ts = gtn[g];
                gs = g;
              }
            }
            // every group left starts beyond the best hit (a tie is tested)
            if (gs < 0 || ts > tbest) break;
            todo &= ~(1u << gs);
            if constexpr (kCount == 4) { ++groups; rows += gr; }
            const int r0 = s + gs * gr;
            for (int j = 0; j < gr; ++j) {
              float t;
              const int row = r0 + j;
              // groups come in any order: ties compare (leaf, row) outright
              if (moller_trumbore(tri + (size_t)row * 3, ro, &t) &&
                  (t < tbest ||
                   (t == tbest && (li < lbest || (li == lbest && row < ibest))))) {
                tbest = t;
                ibest = row;
                lbest = li;
              }
            }
          }
        } else {
          // the leaf's spatial groups, nearest entry first (the lower group
          // on equal entry), against min(best t, tmax) at the leaf's entry
          constexpr int kGr = kTcl / kGroups;
          const int s = baked_start(id, t_rows, kTcl);
          if (s % kTcl) atomicOr(err, kErrLeafGrid);
          uint32_t ow[kTcl / 4];
          float gtn[kGroups];
          unsigned todo = leaf_groups<kTcl>(sub, s, r, fminf(tbest, r.tmx), ow, gtn);
          while (todo) {
            int gs = -1;
            float ts = CUDART_INF_F;
#pragma unroll
            for (int g = 0; g < kGroups; ++g) {
              if (((todo >> g) & 1u) && gtn[g] < ts) {
                ts = gtn[g];
                gs = g;
              }
            }
            // every group left starts beyond the best hit (a tie is tested)
            if (gs < 0 || ts > tbest) break;
            todo &= ~(1u << gs);
            if constexpr (kCount == 4) { ++groups; rows += kGr; }
            int rw[kGr];
            group_rows<kTcl>(ow, gs, s, rw);
            float t[kGr];
            bool hit[kGr];
            test_rows<kGr>(tri, rw, r, t, hit);
            // rows come in any order: ties compare (t, row) outright
#pragma unroll
            for (int j = 0; j < kGr; ++j) {
              if (hit[j] && (t[j] < tbest || (t[j] == tbest && rw[j] < ibest))) {
                tbest = t[j];
                ibest = rw[j];
              }
            }
          }
        }
        continue;
      }
      const int ax = __ldg(axis + id);
      const float d = ax == 0 ? r.dx : (ax == 1 ? r.dy : r.dz);
      const float tfar = fminf(tbest, r.tmx);
      // children ascend along the axis: push far first so near pops first
      if constexpr (kTcl > 0) {
        float tn[8];
        int ch[8];
        const unsigned ok = test_children(boxes, child, id, r, tfar, tn, ch);
        if (sp + __popc(ok) > kStack) { atomicOr(err, kErrStack); break; }
        if (d >= 0.0f) {
#pragma unroll
          for (int k = 7; k >= 0; --k) {
            if ((ok >> k) & 1u) { stack[sp] = ch[k]; stack_tn[sp] = tn[k]; ++sp; }
          }
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if ((ok >> k) & 1u) { stack[sp] = ch[k]; stack_tn[sp] = tn[k]; ++sp; }
          }
        }
      } else {
        // the instanced form tests and pushes child by child (its walk
        // holds more registers: the batched loads cost K7 4-10%)
        const bool fwd = d >= 0.0f;
        for (int k = 0; k < 8; ++k) {
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
  }
  t_out[i] = tbest;
  i_out[i] = ibest;
  if constexpr (kInst) l_out[i] = lbest;
  if constexpr (kCount > 0) {
    const int mine[4] = {pops, leaves, groups, rows};
    __shared__ int part[kCount][kThreads / 32];
#pragma unroll
    for (int c = 0; c < kCount; ++c) {
      const int w = __reduce_add_sync(0xffffffffu, mine[c]);
      if ((threadIdx.x & 31) == 0) part[c][threadIdx.x >> 5] = w;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int* slot = counts + (size_t)(i / kTile) * kCount;
#pragma unroll
      for (int c = 0; c < kCount; ++c) {
        int b = 0;
#pragma unroll
        for (int w = 0; w < kThreads / 32; ++w) b += part[c][w];
        atomicAdd(slot + c, b);
      }
    }
  }
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMtTcl = 32;          // rows per linear-form leaf
constexpr int kMtFrag = 256;        // float4 of B fragments and margins a leaf (8 x 32 lanes)
constexpr int kMtCounts = 8 + 32;   // per count tile: 8 sums, then the share histogram
constexpr float kGuard = 0x1p-100f; // absolute slack of every filter margin
// blocks an SM K10 is compiled for: at most 96 registers (128 without the
// cap, 4 blocks) with a few spills, 5-7% faster on primary, bounce and
// shadow rays
constexpr int kMtBlocks = 5;

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero,
// as mt_frag_table rounds the table's side (tf32_round).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d = A (16 x 8, TF32, row-major fragment a) x B (8 x 8, TF32, column
// fragment b0 b1), summed in FP32 on the tensor cores; all 32 lanes take part.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], float b0,
                                         float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)), "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
}

// The tensor-core filter of one leaf (first row ls) for the whole warp: the
// rows of the leaf that may hit this lane's ray. For each of the leaf's 32
// rows and the warp's 32 rays, u*det, v*det and w*det = (det - u - v)*det
// come from one product of the rays' features [d, (o-c) x d, 0, 0]
// (fragments a, built once a call) with the leaf's fragments (mt_frag_table:
// 4 blocks of 8 rows, each 3 n-tiles u, v, w, and a margin factor G a row),
// 2 m-tiles of 16 rays x 12 n-tiles: 24 mma, 12 where only one m-tile's rays
// need the leaf (need: the lanes whose pending leaf it is). A hit needs the
// three to share det's sign, and u + v + w = det, so a pair whose three
// values surely differ in sign cannot hit: it is rejected where some value
// exceeds M and another lies below -M, M = rn * G + 2^-100 (rn: the ray's
// |f[0:6]|, rounded up; G: 1.25 * 2^-10 * (|g_det| + |g_u| + |g_v|) of the
// row, rounded up), a bound on the distance between the product (TF32
// inputs, FP32 sums) and the FP32 values the exact test computes. Lane
// (g, t) holds rays 16 mt + g (+ 8) against rows 8 b + 2t (+ 1); the quad's
// bits are ORed and each lane takes its own ray's 32-bit mask.
__device__ __forceinline__ unsigned tc_filter(const float4* __restrict__ frag, int ls,
                                              unsigned need, const uint32_t (&a)[2][4],
                                              const float (&rn)[2][2], int lane) {
  const float4* fp = frag + (size_t)(ls / kMtTcl) * kMtFrag + lane;
  float4 q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) q[k] = __ldg(fp + 32 * k);
  const int t = lane & 3;
  unsigned part[2][2] = {{0u, 0u}, {0u, 0u}};
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (!((need >> (16 * mt)) & 0xffffu)) continue;  // no ray of this m-tile needs it
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float4 x = q[2 * b], y = q[2 * b + 1];
      float du[4], dv[4], dw[4];
      mma_tf32(du, a[mt], x.x, x.y);
      mma_tf32(dv, a[mt], x.z, x.w);
      mma_tf32(dw, a[mt], y.x, y.y);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int h = p >> 1, c = p & 1;
        const float m = __fmaf_rn(rn[mt][h], c ? y.w : y.z, kGuard);
        const float hi = fmaxf(fmaxf(du[p], dv[p]), dw[p]);
        const float lo = fminf(fminf(du[p], dv[p]), dw[p]);
        if (!(hi > m && lo < -m)) part[mt][h] |= 1u << (8 * b + 2 * t + c);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    unsigned& v = part[k >> 1][k & 1];
    v |= __shfl_xor_sync(kFull, v, 1);
    v |= __shfl_xor_sync(kFull, v, 2);
  }
  const int src = 4 * (lane & 7);
  const unsigned m0 = __shfl_sync(kFull, part[0][0], src);
  const unsigned m1 = __shfl_sync(kFull, part[0][1], src);
  const unsigned m2 = __shfl_sync(kFull, part[1][0], src);
  const unsigned m3 = __shfl_sync(kFull, part[1][1], src);
  const int k = lane >> 3;  // this lane's ray: m-tile k >> 1, row half k & 1
  return k == 0 ? m0 : (k == 1 ? m1 : (k == 2 ? m2 : m3));
}

// K10. Each lane walks its own ray with K1's stack and node loop (the
// node's loads in flight together, far child pushed first) until it takes
// a leaf off its stack or its stack is empty; then the warp meets for one
// leaf step. The lanes' pending leaves are grouped (__match_any_sync): a
// leaf goes through the tensor-core filter once for the lanes that hold it
// (tc_filter), and each of them tests the rows that pass, in row order.
// kEvery false (measurement and reference launchers only): a leaf goes
// through the filter only where at least share_min lanes hold it, and
// every other pending leaf is tested by its lane alone, all 32 rows (33:
// every leaf on the CUDA cores). Both tests are lean_form, so the result is
// the plain version's bit for bit either way. kCount: per 1024-ray tile
// [pops, leaves, leaf steps,
// tensor-core products, lane-leaf tests they served, rows that passed the
// filter for those lanes, rows tested exactly, 0], then from slot 8 the
// histogram of a step's pending leaves by the lanes sharing them (slot
// 8 + c - 1: leaves shared by c lanes).
template <int kCount, bool kEvery>
__global__ void __launch_bounds__(kThreads, kMtBlocks)
bvh_closest_mt_kernel(const float* __restrict__ rox, const float* __restrict__ roy,
                      const float* __restrict__ roz, const float* __restrict__ rdx,
                      const float* __restrict__ rdy, const float* __restrict__ rdz,
                      const float* __restrict__ tmin, const float* __restrict__ tmax,
                      const MtTables mt, const int* __restrict__ child,
                      const int* __restrict__ axis, const float4* __restrict__ boxes, int n,
                      int t_rows, int n_nodes, int share_min, float* __restrict__ t_out,
                      int* __restrict__ i_out, int* __restrict__ counts,
                      int* __restrict__ err) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // lanes past n walk nothing but take part in the warp's leaf steps
  const bool have = i < n;
  Ray r{};
  r.tmn = 1.0f;
  if (have) r = load_ray(i, rox, roy, roz, rdx, rdy, rdz, tmin, tmax);
  float f[10];  // the ray's features [d, (o-c) x d, o-c, 1], as _mt_features
  {
    const float rcx = r.ox - __ldg(mt.center);
    const float rcy = r.oy - __ldg(mt.center + 1);
    const float rcz = r.oz - __ldg(mt.center + 2);
    f[0] = r.dx; f[1] = r.dy; f[2] = r.dz;
    f[3] = rcy * r.dz - rcz * r.dy;
    f[4] = rcz * r.dx - rcx * r.dz;
    f[5] = rcx * r.dy - rcy * r.dx;
    f[6] = rcx; f[7] = rcy; f[8] = rcz; f[9] = 1.0f;
  }
  // the warp's A fragments (rays x features 0-7, features 6 and 7 zero) and
  // the margin factors rn of the 4 rays whose products this lane holds
  uint32_t a[2][4];
  float rn[2][2];
  {
    float ss = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) ss = ss + f[k] * f[k];
    const float own_rn = sqrtf(ss) * (1.0f + 0x1p-20f);
    uint32_t ft[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) ft[k] = to_tf32(f[k]);
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int src = 16 * m + 8 * hh + g;
        uint32_t x[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) x[k] = __shfl_sync(kFull, ft[k], src);
        a[m][hh] = t == 0 ? x[0] : (t == 1 ? x[1] : (t == 2 ? x[2] : x[3]));
        a[m][2 + hh] = t == 0 ? x[4] : (t == 1 ? x[5] : 0u);
        rn[m][hh] = __shfl_sync(kFull, own_rn, src);
      }
    }
  }
  float tbest = kMaxDistance;
  int ibest = -1;
  int pops = 0, leaves = 0, steps = 0, products = 0, tc_lanes = 0, passed = 0, rows = 0;
  __shared__ int hist[kCount > 0 ? 32 : 1];
  if constexpr (kCount > 0) {
    if (threadIdx.x < 32) hist[threadIdx.x] = 0;
    __syncthreads();
  }
  int stack[kStack];
  float stack_tn[kStack];
  int sp = 0;
  if (have && r.tmx > r.tmn) {
    stack[0] = 0;
    stack_tn[0] = r.tmn;
    sp = 1;
  }
  int visits = n_nodes * 8 + 1;
  for (;;) {
    int s = -1;  // the first row of this lane's pending leaf
    while (sp > 0) {
      if (--visits < 0) { atomicOr(err, kErrVisitCap); sp = 0; break; }
      --sp;
      const int id = stack[sp];
      if constexpr (kCount > 0) pops += id >= 0;
      if (stack_tn[sp] > tbest) continue;
      if (id < 0) {
        s = baked_start(id, t_rows, kMtTcl);
        break;
      }
      const int ax = __ldg(axis + id);
      const float d = ax == 0 ? r.dx : (ax == 1 ? r.dy : r.dz);
      float tn[8];
      int ch[8];
      const unsigned ok = test_children(boxes, child, id, r, fminf(tbest, r.tmx), tn, ch);
      if (sp + __popc(ok) > kStack) { atomicOr(err, kErrStack); sp = 0; break; }
      if (d >= 0.0f) {
#pragma unroll
        for (int k = 7; k >= 0; --k) {
          if ((ok >> k) & 1u) { stack[sp] = ch[k]; stack_tn[sp] = tn[k]; ++sp; }
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if ((ok >> k) & 1u) { stack[sp] = ch[k]; stack_tn[sp] = tn[k]; ++sp; }
        }
      }
    }
    if (!__ballot_sync(kFull, s >= 0)) break;
    const unsigned peers = __match_any_sync(kFull, s);
    const bool tc = s >= 0 && (kEvery || __popc(peers) >= share_min);
    if constexpr (kCount > 0) {
      steps += lane == 0;
      if (s >= 0) {
        ++leaves;
        if (lane == __ffs(peers) - 1) atomicAdd(&hist[__popc(peers) - 1], 1);
      }
    }
    // the shared leaves, one product each for the whole warp
    unsigned lead = __ballot_sync(kFull, tc && lane == __ffs(peers) - 1);
    while (lead) {
      const int src = __ffs(lead) - 1;
      lead &= lead - 1;
      const int ls = __shfl_sync(kFull, s, src);
      const unsigned need = __shfl_sync(kFull, peers, src);
      const unsigned pass = tc_filter(mt.frag, ls, need, a, rn, lane);
      if constexpr (kCount > 0) products += lane == 0;
      if (s == ls) {
        if constexpr (kCount > 0) { ++tc_lanes; passed += __popc(pass); rows += __popc(pass); }
        unsigned bits = pass;
        while (bits) {
          const int row = ls + __ffs(bits) - 1;
          bits &= bits - 1;
          float t;
          if (lean_form(mt.lean + (size_t)row * 5, f, r, &t) &&
              (t < tbest || (t == tbest && row < ibest))) {
            tbest = t;
            ibest = row;
          }
        }
      }
    }
    // every other pending leaf by its lane alone
    if constexpr (!kEvery) {
      if (s >= 0 && !tc) {
        if constexpr (kCount > 0) rows += kMtTcl;
        for (int j = 0; j < kMtTcl; ++j) {
          float t;
          const int row = s + j;
          if (lean_form(mt.lean + (size_t)row * 5, f, r, &t) &&
              (t < tbest || (t == tbest && row < ibest))) {
            tbest = t;
            ibest = row;
          }
        }
      }
    }
  }
  if (have) {
    t_out[i] = tbest;
    i_out[i] = ibest;
  }
  if constexpr (kCount > 0) {
    const int mine[7] = {pops, leaves, steps, products, tc_lanes, passed, rows};
    __shared__ int part[7][kThreads / 32];
#pragma unroll
    for (int c = 0; c < 7; ++c) {
      const int w = __reduce_add_sync(kFull, mine[c]);
      if (lane == 0) part[c][threadIdx.x >> 5] = w;
    }
    __syncthreads();
    int* slot = counts + (size_t)(blockIdx.x * kThreads / kTile) * kMtCounts;
    if (threadIdx.x < 7) {
      int b = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) b += part[threadIdx.x][w];
      atomicAdd(slot + threadIdx.x, b);
    }
    if (threadIdx.x < 32 && hist[threadIdx.x]) atomicAdd(slot + 8 + threadIdx.x, hist[threadIdx.x]);
  }
}

inline MtTables mt_tables(const float* lean, const float* frag, const float* center) {
  return MtTables{reinterpret_cast<const float4*>(lean), reinterpret_cast<const float4*>(frag),
                  center};
}

template <bool kInst, int kTcl>
__global__ void __launch_bounds__(kThreads)
bvh_anyhit_kernel(const float* __restrict__ rox, const float* __restrict__ roy,
                  const float* __restrict__ roz, const float* __restrict__ rdx,
                  const float* __restrict__ rdy, const float* __restrict__ rdz,
                  const float* __restrict__ tmin, const float* __restrict__ tmax,
                  const float4* __restrict__ tri, const int* __restrict__ child,
                  const int* __restrict__ axis, const float4* __restrict__ boxes,
                  const InstTables it, const SubTable sub, int n, int t_rows, int tcl,
                  int n_nodes, int* __restrict__ occ_out, int* __restrict__ err) {
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
        if constexpr (kInst) {
          // the group boxes in table order against tmax; the first hit ends it
          const int li = world_leaf(id, it);
          const int s = inst_start(li, it, t_rows, tcl, err);
          const Ray ro = to_object(r, it.w2o + (size_t)__ldg(it.leaf_inst + li) * 12);
          const float4* gbox = it.subleaf + (size_t)(s / tcl) * (2 * kGroups);
          const int gr = tcl / kGroups;
          for (int g = 0; g < kGroups && !occluded; ++g) {
            float tn;
            if (!slab(gbox + 2 * g, ro, r.tmx, &tn)) continue;
            for (int j = 0; j < gr; ++j) {
              float t;
              if (moller_trumbore(tri + (size_t)(s + g * gr + j) * 3, ro, &t)) {
                occluded = 1;
                break;
              }
            }
          }
        } else {
          // the groups the ray enters in table order against tmax, each
          // group's rows together; the first hit ends the walk
          constexpr int kGr = kTcl / kGroups;
          const int s = baked_start(id, t_rows, kTcl);
          if (s % kTcl) atomicOr(err, kErrLeafGrid);
          uint32_t ow[kTcl / 4];
          float gtn[kGroups];
          unsigned todo = leaf_groups<kTcl>(sub, s, r, r.tmx, ow, gtn);
          while (todo && !occluded) {
            const int g = __ffs(todo) - 1;
            todo &= todo - 1;
            int rw[kGr];
            group_rows<kTcl>(ow, g, s, rw);
            float t[kGr];
            bool hit[kGr];
            test_rows<kGr>(tri, rw, r, t, hit);
#pragma unroll
            for (int j = 0; j < kGr; ++j) occluded |= hit[j];
          }
        }
        continue;
      }
      if constexpr (kTcl > 0) {
        float tn[8];
        int ch[8];
        const unsigned ok = test_children(boxes, child, id, r, r.tmx, tn, ch);
        if (sp + __popc(ok) > kStack) { atomicOr(err, kErrStack); break; }
#pragma unroll
        for (int k = 0; k < 8; ++k) {  // fixed order: any hit terminates
          if ((ok >> k) & 1u) stack[sp++] = ch[k];
        }
      } else {
        for (int k = 0; k < 8; ++k) {  // fixed order: any hit terminates
          float tn;
          if (!slab(boxes + (size_t)(id * 8 + k) * 2, r, r.tmx, &tn)) continue;
          if (sp >= kStack) { atomicOr(err, kErrStack); sp = 0; break; }
          stack[sp++] = __ldg(child + id * 8 + k);
        }
      }
    }
  }
  occ_out[i] = occluded;
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

inline InstTables inst_tables(const int* leaf_start, const int* leaf_inst, const float* w2o,
                              const float* subleaf, int n_leaves) {
  return InstTables{leaf_start, leaf_inst, w2o, reinterpret_cast<const float4*>(subleaf),
                    n_leaves};
}

inline SubTable sub_table(const unsigned char* order, const float* boxes) {
  return SubTable{order, reinterpret_cast<const float4*>(boxes)};
}

// Runs f(std::integral_constant<int, tcl>) for a leaf size the baked
// kernels are compiled for (accel/bvh_traverse.py KERNEL_TCLS), else
// returns cudaErrorInvalidValue (the wrappers raise before that).
template <typename F>
int with_leaf_size(int tcl, F&& f) {
  switch (tcl) {
    case 16: f(std::integral_constant<int, 16>{}); break;
    case 32: f(std::integral_constant<int, 32>{}); break;
    case 64: f(std::integral_constant<int, 64>{}); break;
    case 128: f(std::integral_constant<int, 128>{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1 and its counting forms (kCount 2: K11; 4: the measurement launcher).
template <int kCount>
int launch_closest_baked(const float* rox, const float* roy, const float* roz,
                         const float* rdx, const float* rdy, const float* rdz,
                         const float* tmin, const float* tmax, const float* tri,
                         const int* child, const int* axis, const float* boxes,
                         const unsigned char* sub_order, const float* sub_boxes, int n,
                         int t_rows, int tcl, int n_nodes, float* t_out, int* i_out,
                         int* counts, int* err, cudaStream_t stream) {
  if (kCount > 0 && n % kTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  return with_leaf_size(tcl, [&](auto leaf) {
    if (n <= 0) return;
    bvh_closest_kernel<false, kCount, decltype(leaf)::value>
        <<<blocks_for(n), kThreads, 0, stream>>>(
            rox, roy, roz, rdx, rdy, rdz, tmin, tmax, reinterpret_cast<const float4*>(tri),
            child, axis, reinterpret_cast<const float4*>(boxes), InstTables{},
            sub_table(sub_order, sub_boxes), n, t_rows, tcl,
            n_nodes, t_out, i_out, nullptr, counts, err);
  });
}

}  // namespace

extern "C" int launch_bvh_closest(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, const float* tmin, const float* tmax,
    const float* tri, const int* child, const int* axis, const float* boxes,
    const unsigned char* sub_order, const float* sub_boxes, int n, int t_rows, int tcl,
    int n_nodes, float* t_out, int* i_out, int* err, cudaStream_t stream) {
  return launch_closest_baked<0>(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, child, axis,
                                 boxes, sub_order, sub_boxes, n, t_rows, tcl, n_nodes, t_out,
                                 i_out, nullptr, err, stream);
}

// counts: (n / 1024, 2) int32, zeroed by the caller; n % 1024 == 0.
extern "C" int launch_bvh_closest_count(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, const float* tmin, const float* tmax,
    const float* tri, const int* child, const int* axis, const float* boxes,
    const unsigned char* sub_order, const float* sub_boxes, int n, int t_rows, int tcl,
    int n_nodes, float* t_out, int* i_out, int* counts, int* err, cudaStream_t stream) {
  return launch_closest_baked<2>(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, child, axis,
                                 boxes, sub_order, sub_boxes, n, t_rows, tcl, n_nodes, t_out,
                                 i_out, counts, err, stream);
}

// K1 with per-tile counts of its walk, for measurement only (no wrapper;
// no path launches it): counts (n / 1024, 4) int32 [pops, leaves, groups
// entered, rows tested], zeroed by the caller; n % 1024 == 0.
extern "C" int launch_bvh_closest_visits(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, const float* tmin, const float* tmax,
    const float* tri, const int* child, const int* axis, const float* boxes,
    const unsigned char* sub_order, const float* sub_boxes, int n, int t_rows, int tcl,
    int n_nodes, float* t_out, int* i_out, int* counts, int* err, cudaStream_t stream) {
  return launch_closest_baked<4>(rox, roy, roz, rdx, rdy, rdz, tmin, tmax, tri, child, axis,
                                 boxes, sub_order, sub_boxes, n, t_rows, tcl, n_nodes, t_out,
                                 i_out, counts, err, stream);
}

extern "C" int launch_bvh_anyhit(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, const float* tmin, const float* tmax,
    const float* tri, const int* child, const int* axis, const float* boxes,
    const unsigned char* sub_order, const float* sub_boxes, int n, int t_rows, int tcl,
    int n_nodes, int* occ_out, int* err, cudaStream_t stream) {
  return with_leaf_size(tcl, [&](auto leaf) {
    if (n <= 0) return;
    bvh_anyhit_kernel<false, decltype(leaf)::value><<<blocks_for(n), kThreads, 0, stream>>>(
        rox, roy, roz, rdx, rdy, rdz, tmin, tmax, reinterpret_cast<const float4*>(tri), child,
        axis, reinterpret_cast<const float4*>(boxes), InstTables{},
        sub_table(sub_order, sub_boxes), n, t_rows, tcl, n_nodes, occ_out, err);
  });
}

extern "C" int launch_bvh_closest_inst(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, const float* tmin, const float* tmax,
    const float* tri, const int* child, const int* axis, const float* boxes,
    const int* leaf_start, const int* leaf_inst, const float* w2o, const float* subleaf,
    int n, int t_rows, int tcl, int n_nodes, int n_leaves,
    float* t_out, int* i_out, int* l_out, int* err, cudaStream_t stream) {
  if (n > 0) {
    bvh_closest_kernel<true, 0, 0><<<blocks_for(n), kThreads, 0, stream>>>(
        rox, roy, roz, rdx, rdy, rdz, tmin, tmax,
        reinterpret_cast<const float4*>(tri), child, axis,
        reinterpret_cast<const float4*>(boxes),
        inst_tables(leaf_start, leaf_inst, w2o, subleaf, n_leaves), SubTable{},
        n, t_rows, tcl, n_nodes, t_out, i_out, l_out, nullptr, err);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7 with per-tile visit counts, for measurement only (no wrapper; no
// path launches it): counts (n / 1024, 4) int32 [pops, leaves, groups,
// rows tested], zeroed by the caller; n % 1024 == 0.
extern "C" int launch_bvh_closest_inst_count(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, const float* tmin, const float* tmax,
    const float* tri, const int* child, const int* axis, const float* boxes,
    const int* leaf_start, const int* leaf_inst, const float* w2o, const float* subleaf,
    int n, int t_rows, int tcl, int n_nodes, int n_leaves,
    float* t_out, int* i_out, int* l_out, int* counts, int* err, cudaStream_t stream) {
  if (n % kTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    bvh_closest_kernel<true, 4, 0><<<n / kThreads, kThreads, 0, stream>>>(
        rox, roy, roz, rdx, rdy, rdz, tmin, tmax,
        reinterpret_cast<const float4*>(tri), child, axis,
        reinterpret_cast<const float4*>(boxes),
        inst_tables(leaf_start, leaf_inst, w2o, subleaf, n_leaves), SubTable{},
        n, t_rows, tcl, n_nodes, t_out, i_out, l_out, counts, err);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int launch_bvh_anyhit_inst(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, const float* tmin, const float* tmax,
    const float* tri, const int* child, const int* axis, const float* boxes,
    const int* leaf_start, const int* leaf_inst, const float* w2o, const float* subleaf,
    int n, int t_rows, int tcl, int n_nodes, int n_leaves,
    int* occ_out, int* err, cudaStream_t stream) {
  if (n > 0) {
    bvh_anyhit_kernel<true, 0><<<blocks_for(n), kThreads, 0, stream>>>(
        rox, roy, roz, rdx, rdy, rdz, tmin, tmax,
        reinterpret_cast<const float4*>(tri), child, axis,
        reinterpret_cast<const float4*>(boxes),
        inst_tables(leaf_start, leaf_inst, w2o, subleaf, n_leaves), SubTable{},
        n, t_rows, tcl, n_nodes, occ_out, err);
  }
  return static_cast<int>(cudaGetLastError());
}

// K10: lean (T, 20), frag (T / 32 * 256, 4) and center (3,) from
// accel/bvh_traverse.py mt_kernel_tables; every pending leaf on the
// tensor-core filter.
extern "C" int launch_bvh_closest_mt(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, const float* tmin, const float* tmax,
    const float* lean, const float* frag, const float* center, const int* child,
    const int* axis, const float* boxes, int n, int t_rows, int n_nodes, float* t_out,
    int* i_out, int* err, cudaStream_t stream) {
  if (n > 0) {
    bvh_closest_mt_kernel<0, true><<<blocks_for(n), kThreads, 0, stream>>>(
        rox, roy, roz, rdx, rdy, rdz, tmin, tmax, mt_tables(lean, frag, center), child, axis,
        reinterpret_cast<const float4*>(boxes), n, t_rows, n_nodes, 1, t_out, i_out,
        nullptr, err);
  }
  return static_cast<int>(cudaGetLastError());
}

// K10 where only a leaf that at least share_min lanes of a warp hold goes
// through the tensor-core filter (33: every leaf on the CUDA cores), for
// measurement and as the reference K10's filter is held against (no
// wrapper; no path launches it).
extern "C" int launch_bvh_closest_mt_at(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, const float* tmin, const float* tmax,
    const float* lean, const float* frag, const float* center, const int* child,
    const int* axis, const float* boxes, int n, int t_rows, int n_nodes, int share_min,
    float* t_out, int* i_out, int* err, cudaStream_t stream) {
  if (n > 0) {
    bvh_closest_mt_kernel<0, false><<<blocks_for(n), kThreads, 0, stream>>>(
        rox, roy, roz, rdx, rdy, rdz, tmin, tmax, mt_tables(lean, frag, center), child, axis,
        reinterpret_cast<const float4*>(boxes), n, t_rows, n_nodes, share_min, t_out, i_out,
        nullptr, err);
  }
  return static_cast<int>(cudaGetLastError());
}

// launch_bvh_closest_mt_at with per-tile counts (see bvh_closest_mt_kernel),
// for measurement only (no wrapper; no path launches it): counts
// (n / 1024, 40) int32, zeroed by the caller; n % 1024 == 0.
extern "C" int launch_bvh_closest_mt_visits(
    const float* rox, const float* roy, const float* roz, const float* rdx,
    const float* rdy, const float* rdz, const float* tmin, const float* tmax,
    const float* lean, const float* frag, const float* center, const int* child,
    const int* axis, const float* boxes, int n, int t_rows, int n_nodes, int share_min,
    float* t_out, int* i_out, int* counts, int* err, cudaStream_t stream) {
  if (n % kTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    bvh_closest_mt_kernel<1, false><<<n / kThreads, kThreads, 0, stream>>>(
        rox, roy, roz, rdx, rdy, rdz, tmin, tmax, mt_tables(lean, frag, center), child, axis,
        reinterpret_cast<const float4*>(boxes), n, t_rows, n_nodes, share_min, t_out, i_out,
        counts, err);
  }
  return static_cast<int>(cudaGetLastError());
}
