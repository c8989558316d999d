// Ray tests shared by the traversal kernels (bvh_traverse.cu) and the
// chunk-sweep kernels (sweep.cu): the ray record, the slab test against an
// 8-float box row [lox loy loz hix hiy hiz 0 0] (exact, and with a relative
// slack), and Moller-Trumbore.
//
// Exactness. The slab test is _slab8 (pallas_bvh.py:176-196) and box_test
// (pallas_intersect.py:209-227) in their min/max form with the inclusive
// tn <= tf, apart from an axis of exactly zero direction (see slab);
// inverse directions are safe_inv of both files. The triangle test
// follows _mt_planes (intersect.py:98-108) operation by operation with IEEE
// 1/det; the libraries are compiled with -fmad=false, so t is bit-identical
// to the plain PyTorch sweep.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace rt {

constexpr float kMaxDistance = 1e16f;
constexpr float kDetEps = 1e-12f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmn, tmx;
  bool axis0;  // some direction component is exactly 0 (slab's rare path)
};

__device__ __forceinline__ float safe_inv(float d) {
  // safe_inv of both Pallas files: sign(d) / max(|d|, 1e-12)
  const float mag = fmaxf(fabsf(d), 1e-12f);
  return (d < 0.0f ? -1.0f : 1.0f) / mag;
}

// The slab test for one box loaded as its two float4 halves [lox loy loz
// hix] [hiy hiz 0 0]; returns tn (entry distance) and whether the box
// passes (tn <= tf). An axis on which the ray's direction is exactly 0
// bounds nothing, and the box fails when the origin lies outside its span
// on that axis (lo <= o <= hi passes, faces included). The reference's
// _slab8 takes (hi - o) * safe_inv(0) = 0 there, so a ray running along the
// box's hi face gets tf = 0 < tn and drops the box while Moller-Trumbore
// still hits a triangle edge in that face; a 1024-ray tile of the TPU
// pushes a box when any lane passes it, which hides that, a walk of one ray
// per thread does not. Rays with no zero component (all but a few) take
// the reference's arithmetic unchanged, behind one branch on a flag set
// once per ray.
__device__ __forceinline__ bool slab_box(const float4 lo, const float4 hi, const Ray& r,
                                         float tfar, float* tn_out) {
  float tx0 = (lo.x - r.ox) * r.ix;
  float ty0 = (lo.y - r.oy) * r.iy;
  float tz0 = (lo.z - r.oz) * r.iz;
  float tx1 = (lo.w - r.ox) * r.ix;
  float ty1 = (hi.x - r.oy) * r.iy;
  float tz1 = (hi.y - r.oz) * r.iz;
  bool outside = false;
  if (r.axis0) {
    if (r.dx == 0.0f) {
      outside |= r.ox < lo.x || r.ox > lo.w;
      tx0 = -CUDART_INF_F; tx1 = CUDART_INF_F;
    }
    if (r.dy == 0.0f) {
      outside |= r.oy < lo.y || r.oy > hi.x;
      ty0 = -CUDART_INF_F; ty1 = CUDART_INF_F;
    }
    if (r.dz == 0.0f) {
      outside |= r.oz < lo.z || r.oz > hi.y;
      tz0 = -CUDART_INF_F; tz1 = CUDART_INF_F;
    }
  }
  const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                         fmaxf(fminf(tz0, tz1), r.tmn));
  const float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                         fminf(fmaxf(tz0, tz1), tfar));
  *tn_out = tn;
  return !outside && tn <= tf;
}

__device__ __forceinline__ bool slab(const float4* __restrict__ box,
                                     const Ray& r, float tfar, float* tn_out) {
  return slab_box(__ldg(box), __ldg(box + 1), r, tfar, tn_out);
}

// The relative slack s of group_slab (2^-13; the plain mirror is
// accel/bvh_traverse.py group_slab).
constexpr float kSlack = 1.0f / 8192.0f;
constexpr float kSlackLo = 1.0f - kSlack;
constexpr float kSlackHi = 1.0f + kSlack;

// The slab test of a baked group box (bvh_traverse.cu) and of a chunk box
// (sweep.cu, on boxes padded as make_baked_subleaf pads a group's). The
// entry and exit t of the axes with a nonzero direction component are
// widened by the relative slack s before their clamps (tn * (1 - s) where
// tn >= 0, tn * (1 + s) below; tf the other way). An axis with a zero
// component bounds nothing, and the box fails when the origin lies outside
// its span widened by s times the distance the other axes give (max(|tn|,
// |tf|) times the direction's largest component): Moller-Trumbore's
// rounding grows with the origin's distance, on that axis as on the
// others. A point box at 1e30 (the never-box) still fails: its entry t
// exceeds every tmax.
__device__ __forceinline__ bool group_slab(const float4 lo, const float4 hi, const Ray& r,
                                           float tfar, float* tn_out) {
  float tx0 = (lo.x - r.ox) * r.ix;
  float ty0 = (lo.y - r.oy) * r.iy;
  float tz0 = (lo.z - r.oz) * r.iz;
  float tx1 = (lo.w - r.ox) * r.ix;
  float ty1 = (hi.x - r.oy) * r.iy;
  float tz1 = (hi.y - r.oz) * r.iz;
  if (r.axis0) {
    if (r.dx == 0.0f) { tx0 = -CUDART_INF_F; tx1 = CUDART_INF_F; }
    if (r.dy == 0.0f) { ty0 = -CUDART_INF_F; ty1 = CUDART_INF_F; }
    if (r.dz == 0.0f) { tz0 = -CUDART_INF_F; tz1 = CUDART_INF_F; }
  }
  float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  bool outside = false;
  if (r.axis0) {
    const float dmax = fmaxf(fmaxf(fabsf(r.dx), fabsf(r.dy)), fabsf(r.dz));
    const float m = kSlack * fmaxf(fabsf(tn), fabsf(tf)) * dmax;
    outside = (r.dx == 0.0f && (r.ox < lo.x - m || r.ox > lo.w + m)) ||
              (r.dy == 0.0f && (r.oy < lo.y - m || r.oy > hi.x + m)) ||
              (r.dz == 0.0f && (r.oz < lo.z - m || r.oz > hi.y + m));
  }
  tn = fmaxf(tn * (tn >= 0.0f ? kSlackLo : kSlackHi), r.tmn);
  tf = fminf(tf * (tf >= 0.0f ? kSlackHi : kSlackLo), tfar);
  *tn_out = tn;
  return !outside && tn <= tf;
}

// _mt_planes + the acceptance test of _sweep_tris_xla on one row loaded as
// its three float4 [p0x p0y p0z e1x] [e1y e1z e2x e2y] [e2z pad pad pad];
// t valid iff true.
__device__ __forceinline__ bool moller_trumbore_row(const float4 a, const float4 b,
                                                    const float4 c, const Ray& r,
                                                    float* t_out) {
  const float p0x = a.x, p0y = a.y, p0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float inv = 1.0f / (fabsf(det) < kDetEps ? kDetEps : det);
  const float tvx = r.ox - p0x;
  const float tvy = r.oy - p0y;
  const float tvz = r.oz - p0z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv;
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
  *t_out = t;
  return fabsf(det) >= kDetEps && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
         t > r.tmn && t < r.tmx;
}

__device__ __forceinline__ bool moller_trumbore(const float4* __restrict__ row,
                                                const Ray& r, float* t_out) {
  return moller_trumbore_row(__ldg(row), __ldg(row + 1), __ldg(row + 2), r, t_out);
}

__device__ __forceinline__ Ray load_ray(int i, const float* rox, const float* roy,
                                        const float* roz, const float* rdx,
                                        const float* rdy, const float* rdz,
                                        const float* tmin, const float* tmax) {
  Ray r;
  r.ox = rox[i]; r.oy = roy[i]; r.oz = roz[i];
  r.dx = rdx[i]; r.dy = rdy[i]; r.dz = rdz[i];
  r.ix = safe_inv(r.dx); r.iy = safe_inv(r.dy); r.iz = safe_inv(r.dz);
  r.axis0 = r.dx == 0.0f || r.dy == 0.0f || r.dz == 0.0f;
  r.tmn = tmin[i]; r.tmx = tmax[i];
  return r;
}

}  // namespace rt
