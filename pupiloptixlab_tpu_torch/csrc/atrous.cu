// One edge-avoiding a-trous iteration for Hopper (K9).
//
// Replaces the Pallas TPU kernel _iter_kernel of
// pupiloptixlab_tpu/denoise/pallas_atrous.py:54, launched once per iteration
// by atrous_denoise_pallas (:167); the wrapper is
// denoise/atrous_kernel.py::atrous_iter.
//
// What it computes, per pixel (y, x) of (h, w) float32 planes, at step s:
// the 5x5 B3-spline taps at (y + iy*s, x + ix*s), iy, ix in -2..2, each
// weighted by
//   k(iy, ix) * exp(-(dl*dl) * inv_2sc)       dl: tap luminance - centre's
//   * exp(-da * inv_2sa)                      (use_albedo) da: squared albedo
//                                             distance over 3 planes
//   * clamp(n_tap . n_centre, 0, 1)^p         (use_normal) p integer 1..8 by
//                                             repeated multiplication, else powf
// and the 3 colour planes are the weighted sums divided by max(wsum, 1e-8).
// Inputs: colour, albedo and normal as (3, h, w) blocks of planes; output:
// (3, h, w) colour planes.
//
// Design. The TPU kernel DMAs halo'd windows of the 9 planes (HALO_V = 32
// rows, so steps up to 16) into VMEM stripes and column tiles, because its
// core reads device memory only through DMA. Here a warp takes 32
// consecutive output columns and each thread kRows outputs down its column
// on the step's residue lattice (rows y, y + s, ..., the rows whose taps
// share the image rows y + k*s): the kRows + 4 tap rows and 5 tap columns
// it reads serve up to kRows outputs each, so a thread loads 5 (kRows + 4)
// points for 25 kRows taps (guided, kRows 2: 30 points of 9 planes for 50
// taps, where one output a thread loaded 25 for 25), and computes each
// point's luminance once. Loads go through L1 with 32-bit offsets and the
// 5 clamped column offsets computed once, coalesced along x at any step;
// clamped indices are exactly the reference's edge padding (jnp.pad
// mode="edge") at any step. kRows is 4 without guides and 2 with them
// (their 6 more planes and centre values cost registers: at 4 the guided
// form held 118 registers and 16 warps an SM and ran at 0.28-0.34 ms a
// launch, at 2 it holds 64-72). A staged lattice tile in shared memory (a
// block's 16 x 32 outputs on one residue, its window with a halo of two
// lattice points) lost on the card: 0.23-0.36 ms guided, its staging
// reading a 32-byte sector for each 4-byte value at large steps (PERF.md
// row 13). One call reads 9 and writes 3 planes (at 1920x1080, 99.5 MB: a
// bound of 0.030 ms at 3.35 TB/s) and does ~41 float operations per tap
// (~1,035 per pixel guided, ~0.032 ms at 67 TFLOP/s); the time is flat
// across steps, so issue, not memory, bounds it.
//
// Arithmetic. The operations follow the plain version (atrous_kernel.py
// atrous_step, itself _atrous_denoise_jnp of the reference) in its order,
// with three departures that a float32 model holds within the gate (atol
// 2e-6, rtol 1e-5) of atrous_step (_atrous_iter_model,
// tests/test_torch_denoise.py): the albedo distance and the normal dot are
// chains of fused multiply-adds (__fmaf_rn; the build's -fmad=false fuses
// nothing by itself), the two edge-stop exponents are summed into one expf
// (w = k * exp(fma(-da, inv_2sa, -(dl*dl) * inv_2sc))), and the weighted
// sums accumulate with fused multiply-adds. The luminance is the plain
// version's ((0.2126*r + 0.7152*g) + 0.0722*b), unfused; the normal power
// for an integer exponent 1..8 is repeated multiplication in the plain
// order, predicated instead of looped, else powf; IEEE division for
// 1 / max(wsum, 1e-8).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kTX = 32;     // columns of a block: a warp's lanes
constexpr int kWarps = 4;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ float b3(int k) {  // the 5-tap B3 spline, k = 0..4
  return k == 2 ? 6.0f / 16.0f : (k == 1 || k == 3 ? 4.0f / 16.0f : 1.0f / 16.0f);
}

// kRows: the outputs a thread computes down its lattice column
template <bool kAlbedo, bool kNormal, int kRows>
__global__ void __launch_bounds__(kTX * kWarps)
atrous_iter_kernel(const float* __restrict__ color, const float* __restrict__ albedo,
                   const float* __restrict__ normal, float* __restrict__ out,
                   int h, int w, int step, int tiles_y, float inv_2sc, float inv_2sa,
                   int npow_int, float n_pow) {
  const int s = step;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = blockIdx.x * kTX + lane;
  const int ry = blockIdx.y / tiles_y, ty = blockIdx.y - ry * tiles_y;
  const int l0 = (ty * kWarps + warp) * kRows;  // this thread's first lattice row
  const int hw = h * w;
  int cx[5];
#pragma unroll
  for (int ix = 0; ix < 5; ++ix) cx[ix] = clampi(x + (ix - 2) * s, 0, w - 1);
  float lum_c[kRows], acr[kRows], acg[kRows], acb[kRows], ncx[kRows], ncy[kRows], ncz[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int o = clampi(ry + (l0 + r) * s, 0, h - 1) * w + cx[2];
    lum_c[r] = 0.2126f * __ldg(color + o) + 0.7152f * __ldg(color + hw + o) +
               0.0722f * __ldg(color + 2 * hw + o);
    if constexpr (kAlbedo) {
      acr[r] = __ldg(albedo + o); acg[r] = __ldg(albedo + hw + o);
      acb[r] = __ldg(albedo + 2 * hw + o);
    }
    if constexpr (kNormal) {
      ncx[r] = __ldg(normal + o); ncy[r] = __ldg(normal + hw + o);
      ncz[r] = __ldg(normal + 2 * hw + o);
    }
  }
  float acc_r[kRows], acc_g[kRows], acc_b[kRows], wsum[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc_r[r] = acc_g[r] = acc_b[r] = wsum[r] = 0.0f;
  // lattice rows l0 - 2 .. l0 + kRows + 1; output r takes rows l0 + r - 2 ..
  // l0 + r + 2 as its taps iy = -2..2, so every output sums its taps in
  // row-major order
#pragma unroll
  for (int wr = 0; wr < kRows + 4; ++wr) {
    const int row = clampi(ry + (l0 + wr - 2) * s, 0, h - 1) * w;
#pragma unroll
    for (int ix = 0; ix < 5; ++ix) {
      const int o = row + cx[ix];
      const float sr = __ldg(color + o), sg = __ldg(color + hw + o),
                  sb = __ldg(color + 2 * hw + o);
      const float lum = 0.2126f * sr + 0.7152f * sg + 0.0722f * sb;
      float ar, ag, ab, nx, ny, nz;
      if constexpr (kAlbedo) {
        ar = __ldg(albedo + o); ag = __ldg(albedo + hw + o); ab = __ldg(albedo + 2 * hw + o);
      }
      if constexpr (kNormal) {
        nx = __ldg(normal + o); ny = __ldg(normal + hw + o); nz = __ldg(normal + 2 * hw + o);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int iy = wr - r;
        if (iy < 0 || iy > 4) continue;
        const float k = b3(iy) * b3(ix);  // exact: a dyadic product
        const float dl = lum - lum_c[r];
        float e = -(dl * dl) * inv_2sc;
        if constexpr (kAlbedo) {
          const float d0 = ar - acr[r], d1 = ag - acg[r], d2 = ab - acb[r];
          const float da = __fmaf_rn(d2, d2, __fmaf_rn(d1, d1, d0 * d0));
          e = __fmaf_rn(-da, inv_2sa, e);
        }
        float wt = k * expf(e);
        if constexpr (kNormal) {
          const float nd = __fmaf_rn(nz, ncz[r], __fmaf_rn(ny, ncy[r], nx * ncx[r]));
          const float ndot = fminf(fmaxf(nd, 0.0f), 1.0f);
          float pw;
          if (npow_int > 0) {  // ((ndot * ndot) * ndot) ..., predicated, no loop
            pw = ndot;
#pragma unroll
            for (int q = 1; q < 8; ++q) {
              if (q < npow_int) pw = pw * ndot;
            }
          } else {
            pw = powf(ndot, n_pow);
          }
          wt = wt * pw;
        }
        acc_r[r] = __fmaf_rn(sr, wt, acc_r[r]);
        acc_g[r] = __fmaf_rn(sg, wt, acc_g[r]);
        acc_b[r] = __fmaf_rn(sb, wt, acc_b[r]);
        wsum[r] = wsum[r] + wt;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = ry + (l0 + r) * s;
    if (x < w && y < h) {
      const int o = y * w + x;
      const float inv_w = 1.0f / fmaxf(wsum[r], 1e-8f);
      out[o] = acc_r[r] * inv_w;
      out[hw + o] = acc_g[r] * inv_w;
      out[2 * hw + o] = acc_b[r] * inv_w;
    }
  }
}

template <bool kAlbedo, bool kNormal>
int launch_form(const float* color, const float* albedo, const float* normal, float* out,
                int h, int w, int step, float inv_2sc, float inv_2sa, int npow_int,
                float n_pow, cudaStream_t stream) {
  constexpr int kRows = kAlbedo || kNormal ? 2 : 4;
  // lattice rows of the tallest residue, in tiles; residue-major rows of blocks
  const int tiles_y = ((h + step - 1) / step + kRows * kWarps - 1) / (kRows * kWarps);
  const long long rows = (long long)step * tiles_y;
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // the body's plane offsets are 32-bit
  if (3LL * h * w > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + kTX - 1) / kTX, (unsigned)rows), block(kTX * kWarps);
  atrous_iter_kernel<kAlbedo, kNormal, kRows><<<grid, block, 0, stream>>>(
      color, albedo, normal, out, h, w, step, tiles_y, inv_2sc, inv_2sa, npow_int, n_pow);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int launch_atrous_iter(const float* color, const float* albedo,
                                  const float* normal, float* out, int h, int w,
                                  int step, int use_albedo, int use_normal,
                                  float inv_2sc, float inv_2sa, int npow_int,
                                  float n_pow, cudaStream_t stream) {
  if (h <= 0 || w <= 0 || step <= 0) return static_cast<int>(cudaGetLastError());
  const auto form = use_albedo ? (use_normal ? launch_form<true, true>
                                             : launch_form<true, false>)
                               : (use_normal ? launch_form<false, true>
                                             : launch_form<false, false>);
  return form(color, albedo, normal, out, h, w, step, inv_2sc, inv_2sa, npow_int, n_pow,
              stream);
}
