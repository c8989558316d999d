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
// core reads device memory only through DMA. Here each thread computes one
// output pixel and reads its 25 taps with CLAMPED indices, which is exactly
// the reference's edge padding (jnp.pad mode="edge"), at any step: no halo
// windows, no column tiles. Blocks are 32 x 8 pixels, a warp along a row, so
// a tap's loads are coalesced along x. Neighbouring threads share most taps,
// so the 225 loads per pixel are served by L1/L2; one call reads 9 and
// writes 3 planes (at 1920x1080, 99.5 MB: a bound of 0.030 ms at 3.35 TB/s)
// and does ~41 float operations per tap (~1,035 per pixel guided, ~0.032 ms
// at 67 TFLOP/s), so the bound is near the balance point; a shared-memory
// tile and a fused multi-iteration launch are later work.
//
// Exactness. Every operation follows the plain version (atrous_kernel.py
// atrous_step, itself _atrous_denoise_jnp of the reference) in its order:
// dl = ((0.2126*r + 0.7152*g) + 0.0722*b) - lum_c, w = k * exp(..), then
// w * exp(-da * inv_2sa), then the power; sums run over the taps in row-major
// order. Built with -fmad=false and IEEE division, so only expf/powf can
// differ from PyTorch's, by an ulp or so.

#include <cuda_runtime.h>

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

template <bool kAlbedo, bool kNormal>
__global__ void __launch_bounds__(kBX * kBY)
atrous_iter_kernel(const float* __restrict__ color, const float* __restrict__ albedo,
                   const float* __restrict__ normal, float* __restrict__ out,
                   int h, int w, int step, float inv_2sc, float inv_2sa,
                   int npow_int, float n_pow) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t hw = (size_t)h * w;
  const size_t c = (size_t)y * w + x;
  const float lum_c = 0.2126f * __ldg(color + c) + 0.7152f * __ldg(color + hw + c) +
                      0.0722f * __ldg(color + 2 * hw + c);
  float ar = 0.0f, ag = 0.0f, ab = 0.0f, nr = 0.0f, ng = 0.0f, nb = 0.0f;
  if constexpr (kAlbedo) {
    ar = __ldg(albedo + c); ag = __ldg(albedo + hw + c); ab = __ldg(albedo + 2 * hw + c);
  }
  if constexpr (kNormal) {
    nr = __ldg(normal + c); ng = __ldg(normal + hw + c); nb = __ldg(normal + 2 * hw + c);
  }
  const float b3[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f, 4.0f / 16.0f,
                       1.0f / 16.0f};
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, wsum = 0.0f;
#pragma unroll
  for (int iy = -2; iy <= 2; ++iy) {
    const size_t row = (size_t)clampi(y + iy * step, 0, h - 1) * w;
#pragma unroll
    for (int ix = -2; ix <= 2; ++ix) {
      const size_t p = row + clampi(x + ix * step, 0, w - 1);
      const float k = b3[iy + 2] * b3[ix + 2];  // exact: a dyadic product
      const float sr = __ldg(color + p);
      const float sg = __ldg(color + hw + p);
      const float sb = __ldg(color + 2 * hw + p);
      const float dl = 0.2126f * sr + 0.7152f * sg + 0.0722f * sb - lum_c;
      float wt = k * expf(-(dl * dl) * inv_2sc);
      if constexpr (kAlbedo) {
        const float d0 = __ldg(albedo + p) - ar;
        const float d1 = __ldg(albedo + hw + p) - ag;
        const float d2 = __ldg(albedo + 2 * hw + p) - ab;
        const float da = d0 * d0 + d1 * d1 + d2 * d2;
        wt = wt * expf(-da * inv_2sa);
      }
      if constexpr (kNormal) {
        const float nd = __ldg(normal + p) * nr + __ldg(normal + hw + p) * ng +
                         __ldg(normal + 2 * hw + p) * nb;
        const float ndot = fminf(fmaxf(nd, 0.0f), 1.0f);
        float pw;
        if (npow_int > 0) {
          pw = ndot;
          for (int q = 1; q < npow_int; ++q) pw = pw * ndot;
        } else {
          pw = powf(ndot, n_pow);
        }
        wt = wt * pw;
      }
      acc_r = acc_r + sr * wt;
      acc_g = acc_g + sg * wt;
      acc_b = acc_b + sb * wt;
      wsum = wsum + wt;
    }
  }
  const float inv_w = 1.0f / fmaxf(wsum, 1e-8f);
  out[c] = acc_r * inv_w;
  out[hw + c] = acc_g * inv_w;
  out[2 * hw + c] = acc_b * inv_w;
}

}  // namespace

extern "C" int launch_atrous_iter(const float* color, const float* albedo,
                                  const float* normal, float* out, int h, int w,
                                  int step, int use_albedo, int use_normal,
                                  float inv_2sc, float inv_2sa, int npow_int,
                                  float n_pow, cudaStream_t stream) {
  if (h > 0 && w > 0) {
    const dim3 block(kBX, kBY);
    const dim3 grid((w + kBX - 1) / kBX, (h + kBY - 1) / kBY);
    if (use_albedo && use_normal) {
      atrous_iter_kernel<true, true><<<grid, block, 0, stream>>>(
          color, albedo, normal, out, h, w, step, inv_2sc, inv_2sa, npow_int, n_pow);
    } else if (use_albedo) {
      atrous_iter_kernel<true, false><<<grid, block, 0, stream>>>(
          color, albedo, normal, out, h, w, step, inv_2sc, inv_2sa, npow_int, n_pow);
    } else if (use_normal) {
      atrous_iter_kernel<false, true><<<grid, block, 0, stream>>>(
          color, albedo, normal, out, h, w, step, inv_2sc, inv_2sa, npow_int, n_pow);
    } else {
      atrous_iter_kernel<false, false><<<grid, block, 0, stream>>>(
          color, albedo, normal, out, h, w, step, inv_2sc, inv_2sa, npow_int, n_pow);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
