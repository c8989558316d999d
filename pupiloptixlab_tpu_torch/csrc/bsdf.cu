// BSDF evaluation (K12) and sampling (K13) for Hopper.
//
// launch_bsdf_eval and launch_bsdf_sample replace no Pallas kernel: the JAX
// package evaluates its seven BSDFs in plain jnp (pupiloptixlab_tpu/render/
// bsdf.py), which XLA fuses on the TPU. The port's plain version
// (render/bsdf.py: evaluate_plain, sample_plain) is the same code in plain
// PyTorch, where nothing fuses: every type in the scene's mat_types runs on
// every lane, one (N,) plane op at a time, and is then chosen by ``where``,
// about 2,600 plane ops a bounce on a scene with all seven types. Here one
// thread owns one lane, reads its own material's planes once, runs only its
// own type's branch in registers and writes f, pdf (and wi, lobe). Warps
// diverge only at material borders, which are spatially coherent.
//
// Bounds on the card: memory, about 80-150 bytes a lane a call (the planes
// a lane's type reads, wo and wi or the three uniforms, the outputs).
//
// The numbers equal the plain version on the card bit for bit: the build has
// -fmad=false with IEEE division and square root, every float op below is
// written in the plain code's order (a * b * c is (a * b) * c), and each
// PyTorch idiom keeps its CUDA semantics:
//   - a Python float is a float32 scalar: (float)1e-12, and x / c for a
//     Python c is x * (1.0f / (float)c) (PyTorch's division by a CPU scalar);
//   - 1.0 / t is torch.reciprocal(t) * 1.0, torch.reciprocal is 1.0f / t;
//   - torch.clamp(x, min=c) keeps a NaN (clamp_min below), where fmaxf
//     would drop it;
//   - x ** 2 is x * x; torch.sqrt, torch.sin and torch.cos are sqrtf, sinf
//     and cosf without fast math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// material type ids (render/bsdf.py, scene/materials.py MatType)
constexpr int kDiffuse = 1, kDielectric = 2, kRoughDielectric = 3, kConductor = 4,
              kRoughConductor = 5, kPlastic = 6, kRoughPlastic = 7;
// lobe flags (render/bsdf.py LOBE_*)
constexpr int kLobeDiffuseRefl = 1, kLobeGlossyRefl = 2, kLobeDeltaRefl = 4,
              kLobeGlossyTrans = 16, kLobeDeltaTrans = 32;

constexpr double kPiD = 3.14159265358979323846;
constexpr float kTiny = (float)1e-12;      // render/bsdf.py _TINY, ggx's clamps
constexpr float kTiny18 = (float)1e-18;    // ggx.sample's tangent length
constexpr float kTiny20 = (float)1e-20;    // fresnel's and ggx.d's denominators
constexpr float kGrazing = (float)1e-6;    // rough dielectric's |wo.z| cut
constexpr float kCosMax = (float)0.9999;   // ggx.sample's degenerate frame
constexpr float kPi = (float)kPiD;
constexpr float kTwoPi = (float)(2.0 * kPiD);
// x / math.pi, and x * (1.0 / math.pi): both round to this float
constexpr float kInvPi = 1.0f / (float)kPiD;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }

__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }

__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// Vec3.normalized: v * reciprocal(clamp(sqrt(clamp(v.v, 0)), 1e-20))
__device__ __forceinline__ V3 normalized(V3 v) {
  const float len = sqrtf(clamp_min(dot(v, v), 0.0f));
  return scale(v, 1.0f / clamp_min(len, kTiny20));
}

// --- fresnel.py ----------------------------------------------------------------

struct Fresnel {
  float f, cos_t;
};

__device__ Fresnel dielectric_reflectance(float eta, float ci) {
  const float sc = ci > 0.0f ? 1.0f / eta : eta;
  const float cos_t2 = 1.0f - (1.0f - ci * ci) * sc * sc;
  const bool tir = cos_t2 <= 0.0f;
  const float ca = fabsf(ci);
  const float ct = sqrtf(clamp_min(cos_t2, 0.0f));
  const float rs = (ca - eta * ct) / clamp_min(ca + eta * ct, kTiny20);
  const float rp = (eta * ca - ct) / clamp_min(eta * ca + ct, kTiny20);
  const float f = 0.5f * (rs * rs + rp * rp);
  const float cos_t = ci > 0.0f ? -ct : ct;
  return {tir ? 1.0f : f, tir ? 0.0f : cos_t};
}

__device__ float conductor_reflectance(float eta, float k, float ci) {
  const float c2 = ci * ci;
  const float s2 = 1.0f - c2;
  const float s4 = s2 * s2;
  const float t1 = eta * eta - k * k - s2;
  const float a2pb2 = sqrtf(clamp_min(t1 * t1 + 4.0f * k * k * eta * eta, 0.0f));
  const float a = sqrtf(clamp_min(0.5f * (a2pb2 + t1), 0.0f));
  const float term1 = a2pb2 + c2;
  const float term2 = 2.0f * a * ci;
  const float rs2 = (term1 - term2) / clamp_min(term1 + term2, kTiny20);
  const float term3 = a2pb2 * c2 + s4;
  const float term4 = term2 * s2;
  const float rp2 = rs2 * (term3 - term4) / clamp_min(term3 + term4, kTiny20);
  return 0.5f * (rp2 + rs2);
}

__device__ __forceinline__ V3 conductor_reflectance_rgb(V3 eta, V3 k, float ci) {
  return {conductor_reflectance(eta.x, k.x, ci), conductor_reflectance(eta.y, k.y, ci),
          conductor_reflectance(eta.z, k.z, ci)};
}

// --- ggx.py ----------------------------------------------------------------------

__device__ __forceinline__ float smith_lambda(V3 w, float au, float av) {
  const float z2 = clamp_min(w.z * w.z, kTiny);
  const float a2 = (w.x * w.x * au * au + w.y * w.y * av * av) / z2;
  return (-1.0f + sqrtf(1.0f + a2)) * 0.5f;
}

__device__ __forceinline__ float ggx_g1(V3 w, float au, float av) {
  return 1.0f / (1.0f + smith_lambda(w, au, av));
}

__device__ __forceinline__ float ggx_g(V3 wi, V3 wo, float au, float av) {
  return ggx_g1(wi, au, av) * ggx_g1(wo, au, av);
}

__device__ __forceinline__ float ggx_d(V3 wh, float au, float av) {
  const float au2 = clamp_min(au * au, kTiny);
  const float av2 = clamp_min(av * av, kTiny);
  const float t = wh.x * wh.x / au2 + wh.y * wh.y / av2 + wh.z * wh.z;
  return 1.0f / clamp_min(kPi * sqrtf(au2 * av2) * t * t, kTiny20);
}

__device__ __forceinline__ float ggx_pdf(V3 wo, V3 wh, float au, float av) {
  return ggx_d(wh, au, av) * ggx_g1(wo, au, av) * dot(wo, wh) /
         clamp_min(fabsf(wo.z), kTiny);
}

// Heitz's visible-normal sampling (ggx.py sample)
__device__ V3 ggx_sample(V3 wo, float au, float av, float u1, float u2) {
  const V3 vh = normalized({au * wo.x, av * wo.y, wo.z});
  const float lensq = vh.x * vh.x + vh.y * vh.y;
  const float inv_len = 1.0f / sqrtf(clamp_min(lensq, kTiny18));
  const V3 t1 = wo.z < kCosMax ? V3{-vh.y * inv_len, vh.x * inv_len, 0.0f}
                               : V3{1.0f, 0.0f, 0.0f};
  const V3 t2 = cross(vh, t1);
  const float r = sqrtf(u1);
  const float phi = kTwoPi * u2;
  const float p1 = r * cosf(phi);
  const float s = 0.5f * (1.0f + vh.z);
  const float p2 = (1.0f - s) * sqrtf(clamp_min(1.0f - p1 * p1, 0.0f)) + s * (r * sinf(phi));
  const float pz = sqrtf(clamp_min(1.0f - p1 * p1 - p2 * p2, 0.0f));
  const V3 nh = {p1 * t1.x + p2 * t2.x + pz * vh.x, p1 * t1.y + p2 * t2.y + pz * vh.y,
                 p1 * t1.z + p2 * t2.z + pz * vh.z};
  return normalized({au * nh.x, av * nh.y, clamp_min(nh.z, 0.0f)});
}

// --- sampling.py ---------------------------------------------------------------------

__device__ __forceinline__ V3 cosine_sample_hemisphere(float u1, float u2) {
  const float sin_t = sqrtf(u1);
  const float phi = kTwoPi * u2;
  const float z = sqrtf(clamp_min(1.0f - u1, 0.0f));
  return {sin_t * cosf(phi), sin_t * sinf(phi), z};
}

__device__ __forceinline__ V3 reflect_z(V3 v) { return {-v.x, -v.y, v.z}; }

__device__ __forceinline__ V3 reflect(V3 v, V3 n) {
  const float d = 2.0f * dot(v, n);
  return {d * n.x - v.x, d * n.y - v.y, d * n.z - v.z};
}

__device__ __forceinline__ V3 refract_z(V3 v, float cos_t, float eta) {
  const float sc = -(cos_t < 0.0f ? 1.0f / eta : eta);
  return normalized({sc * v.x, sc * v.y, cos_t});
}

__device__ __forceinline__ V3 refract(V3 v, V3 n, float cos_t, float eta) {
  const float e = cos_t < 0.0f ? 1.0f / eta : eta;
  const float k = dot(v, n) * e + cos_t;
  return {n.x * k - v.x * e, n.y * k - v.y * e, n.z * k - v.z * e};
}

// --- one lane's LocalBsdf --------------------------------------------------------

struct MatPlanes {  // LocalBsdf's planes, (N,) each
  const int* mtype;
  const uint8_t* nonlinear;  // torch.bool
  const float* refl[3];
  const float* spec[3];
  const float* trans[3];
  const float* eta3[3];
  const float* k3[3];
  const float *alpha, *alpha_v, *eta, *int_fdr, *ssw;
};

struct Mat {
  V3 refl, spec, trans, eta3, k3;
  float alpha, alpha_v, eta, int_fdr, ssw;
  bool nonlinear;
};

// the fields a type reads: a lane loads only its own type's
enum : unsigned {
  kRefl = 1, kSpec = 2, kTrans = 4, kCond = 8 /* eta3, k3 */, kAlpha = 16 /* alpha, alpha_v */,
  kEta = 32, kPlast = 64 /* int_fdr, ssw, nonlinear */
};

__device__ __forceinline__ V3 ld3(const float* const p[3], long long i) {
  return {p[0][i], p[1][i], p[2][i]};
}

template <unsigned F>
__device__ __forceinline__ Mat load_mat(const MatPlanes& p, long long i) {
  Mat m{};
  if (F & kRefl) m.refl = ld3(p.refl, i);
  if (F & kSpec) m.spec = ld3(p.spec, i);
  if (F & kTrans) m.trans = ld3(p.trans, i);
  if (F & kCond) {
    m.eta3 = ld3(p.eta3, i);
    m.k3 = ld3(p.k3, i);
  }
  if (F & kAlpha) {
    m.alpha = p.alpha[i];
    m.alpha_v = p.alpha_v[i];
  }
  if (F & kEta) m.eta = p.eta[i];
  if (F & kPlast) {
    m.int_fdr = p.int_fdr[i];
    m.ssw = p.ssw[i];
    m.nonlinear = p.nonlinear[i] != 0;
  }
  return m;
}

// --- bsdf.py's shared terms ------------------------------------------------------

__device__ __forceinline__ float safe_div(float a, float d) {
  return a / (fabsf(d) < kTiny ? (d < 0.0f ? -kTiny : kTiny) : d);
}

__device__ __forceinline__ float cos_pdf(float wi_z) { return wi_z > 0.0f ? wi_z * kInvPi : 0.0f; }

__device__ __forceinline__ float spec_prob(const Mat& m, float f_o) {
  const float num = f_o * m.ssw;
  const float den = num + (1.0f - f_o) * (1.0f - m.ssw);
  return safe_div(num, clamp_min(den, kTiny));
}

// the diffuse base with internal-scattering compensation, nonlinear or not
__device__ __forceinline__ V3 plastic_base(const Mat& m) {
  if (m.nonlinear) {
    return {m.refl.x / clamp_min(1.0f - m.refl.x * m.int_fdr, kTiny),
            m.refl.y / clamp_min(1.0f - m.refl.y * m.int_fdr, kTiny),
            m.refl.z / clamp_min(1.0f - m.refl.z * m.int_fdr, kTiny)};
  }
  return scale(m.refl, 1.0f / clamp_min(1.0f - m.int_fdr, kTiny));
}

__device__ __forceinline__ V3 plastic_diff(const Mat& m, float f_i, float f_o, float wi_z) {
  const float ce = clamp_min(m.eta, kTiny);
  const float sc = (1.0f - f_i) * (1.0f - f_o) * cos_pdf(wi_z) / (ce * ce * clamp_min(wi_z, kTiny));
  return scale(plastic_base(m), sc);
}

struct Eval {
  V3 f;
  float pdf;
};

__device__ __forceinline__ Eval no_eval() { return {{0.0f, 0.0f, 0.0f}, 0.0f}; }

// --- per-type eval: f(wo, wi) and pdf(wo, wi) ----------------------------------

__device__ Eval eval_diffuse(const Mat& m, V3 wo, V3 wi) {
  if (!(wi.z > 0.0f && wo.z > 0.0f)) return no_eval();
  return {scale(m.refl, kInvPi), cos_pdf(wi.z)};
}

__device__ Eval eval_rough_conductor(const Mat& m, V3 wo, V3 wi) {
  if (!(wi.z > 0.0f && wo.z > 0.0f)) return no_eval();
  const V3 wh = normalized(add(wi, wo));
  const V3 fr = conductor_reflectance_rgb(m.eta3, m.k3, dot(wo, wh));
  const float sc = ggx_d(wh, m.alpha, m.alpha_v) * ggx_g(wi, wo, m.alpha, m.alpha_v) /
                   clamp_min(4.0f * wi.z * wo.z, kTiny);
  const float pdf = ggx_pdf(wo, wh, m.alpha, m.alpha_v) / clamp_min(4.0f * dot(wo, wh), kTiny);
  return {scale(mul(m.spec, fr), sc), pdf};
}

__device__ Eval eval_plastic(const Mat& m, V3 wo, V3 wi) {
  if (!(wi.z > 0.0f && wo.z > 0.0f)) return no_eval();
  const float f_o = dielectric_reflectance(m.eta, wo.z).f;
  const float f_i = dielectric_reflectance(m.eta, wi.z).f;
  const float sp = spec_prob(m, f_o);
  return {plastic_diff(m, f_i, f_o, wi.z), cos_pdf(wi.z) * (1.0f - sp)};
}

__device__ Eval eval_rough_plastic(const Mat& m, V3 wo, V3 wi) {
  if (!(wi.z > 0.0f && wo.z > 0.0f)) return no_eval();
  const float f_o = dielectric_reflectance(m.eta, wo.z).f;
  const float f_i = dielectric_reflectance(m.eta, wi.z).f;
  const V3 wh = normalized(add(wi, wo));
  const float fr = dielectric_reflectance(m.eta, dot(wh, wo)).f;
  const float spec_sc = fr * ggx_d(wh, m.alpha, m.alpha_v) * ggx_g(wi, wo, m.alpha, m.alpha_v) /
                        clamp_min(4.0f * wo.z * wi.z, kTiny);
  const float diff_sc =
      (1.0f - f_i) * (1.0f - f_o) * kInvPi / clamp_min(m.eta * m.eta, kTiny);
  const float sp = spec_prob(m, f_o);
  float pdf = sp * ggx_pdf(wo, wh, m.alpha, m.alpha_v) / clamp_min(4.0f * dot(wi, wh), kTiny);
  pdf = pdf + (1.0f - sp) * cos_pdf(wi.z);
  return {add(scale(m.spec, spec_sc), scale(plastic_base(m), diff_sc)), pdf};
}

__device__ Eval eval_rough_dielectric(const Mat& m, V3 wo, V3 wi) {
  const bool refl_side = wo.z * wi.z > 0.0f;
  const float eta_w = wo.z > 0.0f ? m.eta : 1.0f / clamp_min(m.eta, kTiny);
  const V3 h = normalized(refl_side ? add(wo, wi) : add(wo, scale(wi, eta_w)));
  const V3 wh = scale(h, h.z > 0.0f ? 1.0f : -1.0f);

  const float f_term = dielectric_reflectance(m.eta, dot(wo, wh)).f;
  const float g_val = ggx_g(wi, wo, m.alpha, m.alpha_v);
  const float d_val = ggx_d(wh, m.alpha, m.alpha_v);
  const float refl_sc = f_term * g_val * d_val / clamp_min(4.0f * fabsf(wi.z) * fabsf(wo.z), kTiny);

  const float idoth = dot(wi, wh);
  const float odoth = dot(wo, wh);
  const float sqrt_denom = odoth + eta_w * idoth;
  float denom = sqrt_denom * sqrt_denom * wi.z * wo.z;
  denom = fabsf(denom) < kTiny ? kTiny : denom;
  const float trans_sc = fabsf((1.0f - f_term) * d_val * g_val * idoth * odoth / denom);

  V3 f = refl_side ? scale(m.spec, refl_sc) : scale(m.trans, trans_sc);
  if (fabsf(wo.z) < kGrazing) f = {0.0f, 0.0f, 0.0f};

  const float four_i = 4.0f * idoth;
  const float dwh_r = 1.0f / (fabsf(four_i) < kTiny ? kTiny : four_i);
  const float sd2 = sqrt_denom * sqrt_denom;
  const float dwh_t = eta_w * eta_w * idoth / (sd2 < kTiny ? kTiny : sd2);
  const V3 wo_up = scale(wo, wo.z > 0.0f ? 1.0f : -1.0f);
  const float pdf = fabsf(ggx_pdf(wo_up, wh, m.alpha, m.alpha_v) *
                          (refl_side ? f_term : 1.0f - f_term) * (refl_side ? dwh_r : dwh_t));
  return {f, pdf};
}

// --- per-type sample: (wi, f, pdf, lobe) from 3 uniforms -------------------------

struct Sample {
  V3 wi, f;
  float pdf;
  int lobe;
};

__device__ Sample sample_diffuse(const Mat& m, V3 wo, float, float u1, float u2) {
  const V3 wi = cosine_sample_hemisphere(u1, u2);
  const Eval e = eval_diffuse(m, wo, wi);
  return {wi, e.f, e.pdf, kLobeDiffuseRefl};
}

__device__ Sample sample_conductor(const Mat& m, V3 wo, float, float, float) {
  const V3 wi = reflect_z(wo);
  const V3 fr = conductor_reflectance_rgb(m.eta3, m.k3, wo.z);
  const V3 f = scale(mul(m.spec, fr), 1.0f / clamp_min(fabsf(wi.z), kTiny));
  return {wi, f, 1.0f, kLobeDeltaRefl};
}

__device__ Sample sample_dielectric(const Mat& m, V3 wo, float u_lobe, float, float) {
  const Fresnel fr = dielectric_reflectance(m.eta, wo.z);
  const bool take_refl = u_lobe < fr.f;
  const V3 wi = take_refl ? reflect_z(wo) : refract_z(wo, fr.cos_t, m.eta);
  const float inv_wiz = 1.0f / clamp_min(fabsf(wi.z), kTiny);
  if (take_refl) return {wi, scale(m.spec, fr.f * inv_wiz), fr.f, kLobeDeltaRefl};
  const float factor = fr.cos_t < 0.0f ? 1.0f / clamp_min(m.eta, kTiny) : m.eta;
  return {wi, scale(m.trans, (1.0f - fr.f) * factor * factor * inv_wiz), 1.0f - fr.f,
          kLobeDeltaTrans};
}

__device__ Sample sample_rough_conductor(const Mat& m, V3 wo, float, float u1, float u2) {
  const V3 wh = ggx_sample(wo, m.alpha, m.alpha_v, u1, u2);
  const V3 wi = reflect(wo, wh);
  const Eval e = eval_rough_conductor(m, wo, wi);
  return {wi, e.f, e.pdf, kLobeGlossyRefl};
}

__device__ Sample sample_rough_dielectric(const Mat& m, V3 wo, float u_lobe, float u1,
                                          float u2) {
  const V3 wo_up = scale(wo, wo.z > 0.0f ? 1.0f : -1.0f);
  const V3 wh = ggx_sample(wo_up, m.alpha, m.alpha_v, u1, u2);
  const Fresnel fr = dielectric_reflectance(m.eta, dot(wo, wh));
  const bool take_refl = u_lobe < fr.f;
  const V3 wi = take_refl ? reflect(wo, wh) : refract(wo, wh, fr.cos_t, m.eta);
  const bool valid = take_refl || (fabsf(fr.cos_t) > kGrazing && wi.z * wo.z < 0.0f);
  const int lobe = take_refl ? kLobeGlossyRefl : kLobeGlossyTrans;
  if (!valid) return {wi, {0.0f, 0.0f, 0.0f}, 0.0f, lobe};
  const Eval e = eval_rough_dielectric(m, wo, wi);
  return {wi, e.f, e.pdf, lobe};
}

__device__ Sample sample_plastic(const Mat& m, V3 wo, float u_lobe, float u1, float u2) {
  const float f_o = dielectric_reflectance(m.eta, wo.z).f;
  const float sp = spec_prob(m, f_o);
  const bool take_spec = u_lobe < sp;
  const V3 wi = take_spec ? reflect_z(wo) : cosine_sample_hemisphere(u1, u2);
  const int lobe = take_spec ? kLobeDeltaRefl : kLobeDiffuseRefl;
  if (wo.z <= 0.0f) return {wi, {0.0f, 0.0f, 0.0f}, 0.0f, lobe};
  if (take_spec) return {wi, scale(m.spec, f_o / clamp_min(wi.z, kTiny)), sp, lobe};
  const float f_i = dielectric_reflectance(m.eta, wi.z).f;
  return {wi, plastic_diff(m, f_i, f_o, wi.z), cos_pdf(wi.z) * (1.0f - sp), lobe};
}

__device__ Sample sample_rough_plastic(const Mat& m, V3 wo, float u_lobe, float u1, float u2) {
  const float f_o = dielectric_reflectance(m.eta, wo.z).f;
  const float sp = spec_prob(m, f_o);
  const bool take_spec = u_lobe < sp;
  const V3 wi = take_spec ? reflect(wo, ggx_sample(wo, m.alpha, m.alpha_v, u1, u2))
                          : cosine_sample_hemisphere(u1, u2);
  const int lobe = take_spec ? kLobeGlossyRefl : kLobeDiffuseRefl;
  if (wo.z <= 0.0f) return {wi, {0.0f, 0.0f, 0.0f}, 0.0f, lobe};
  const Eval e = eval_rough_plastic(m, wo, wi);
  return {wi, e.f, e.pdf, lobe};
}

// --- kernels -----------------------------------------------------------------------

// A lane's type: `force` (the one type every lane takes) or, with force 0,
// the lane's own mtype when `mask` (bit t: type t present) holds it, else 0
// (zeros out).
__device__ __forceinline__ int lane_type(const MatPlanes& p, long long i, int force, int mask) {
  if (force) return force;
  const int t = p.mtype[i];
  return t >= kDiffuse && t <= kRoughPlastic && ((mask >> t) & 1) ? t : 0;
}

__global__ void __launch_bounds__(kThreads)
    bsdf_eval_kernel(const MatPlanes p, const float* __restrict__ wo_x,
                     const float* __restrict__ wo_y, const float* __restrict__ wo_z,
                     const float* __restrict__ wi_x, const float* __restrict__ wi_y,
                     const float* __restrict__ wi_z, int n, int force, int mask,
                     float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int t = lane_type(p, i, force, mask);
  Eval e = no_eval();
  if (t != 0) {
    const V3 wo = {wo_x[i], wo_y[i], wo_z[i]};
    const V3 wi = {wi_x[i], wi_y[i], wi_z[i]};
    switch (t) {
      case kDiffuse: e = eval_diffuse(load_mat<kRefl>(p, i), wo, wi); break;
      case kRoughDielectric:
        e = eval_rough_dielectric(load_mat<kSpec | kTrans | kAlpha | kEta>(p, i), wo, wi);
        break;
      case kRoughConductor:
        e = eval_rough_conductor(load_mat<kSpec | kCond | kAlpha>(p, i), wo, wi);
        break;
      case kPlastic: e = eval_plastic(load_mat<kRefl | kEta | kPlast>(p, i), wo, wi); break;
      case kRoughPlastic:
        e = eval_rough_plastic(load_mat<kRefl | kSpec | kAlpha | kEta | kPlast>(p, i), wo, wi);
        break;
      default: break;  // conductor, dielectric: delta lobes, f = 0, pdf = 0
    }
  }
  out[i] = e.f.x;
  out[n + i] = e.f.y;
  out[2LL * n + i] = e.f.z;
  out[3LL * n + i] = e.pdf;
}

__global__ void __launch_bounds__(kThreads)
    bsdf_sample_kernel(const MatPlanes p, const float* __restrict__ wo_x,
                       const float* __restrict__ wo_y, const float* __restrict__ wo_z,
                       const float* __restrict__ u_lobe, const float* __restrict__ u1,
                       const float* __restrict__ u2, int n, int force, int mask,
                       float* __restrict__ out, int* __restrict__ lobe) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int t = lane_type(p, i, force, mask);
  Sample s = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, 0.0f, 0};
  if (t != 0) {
    const V3 wo = {wo_x[i], wo_y[i], wo_z[i]};
    switch (t) {
      case kDiffuse: s = sample_diffuse(load_mat<kRefl>(p, i), wo, 0.0f, u1[i], u2[i]); break;
      case kConductor:
        s = sample_conductor(load_mat<kSpec | kCond>(p, i), wo, 0.0f, 0.0f, 0.0f);
        break;
      case kDielectric:
        s = sample_dielectric(load_mat<kSpec | kTrans | kEta>(p, i), wo, u_lobe[i], 0.0f, 0.0f);
        break;
      case kRoughConductor:
        s = sample_rough_conductor(load_mat<kSpec | kCond | kAlpha>(p, i), wo, 0.0f, u1[i],
                                   u2[i]);
        break;
      case kRoughDielectric:
        s = sample_rough_dielectric(load_mat<kSpec | kTrans | kAlpha | kEta>(p, i), wo,
                                    u_lobe[i], u1[i], u2[i]);
        break;
      case kPlastic:
        s = sample_plastic(load_mat<kRefl | kSpec | kEta | kPlast>(p, i), wo, u_lobe[i], u1[i],
                           u2[i]);
        break;
      default:  // kRoughPlastic
        s = sample_rough_plastic(load_mat<kRefl | kSpec | kAlpha | kEta | kPlast>(p, i), wo,
                                 u_lobe[i], u1[i], u2[i]);
        break;
    }
  }
  out[i] = s.wi.x;
  out[n + i] = s.wi.y;
  out[2LL * n + i] = s.wi.z;
  out[3LL * n + i] = s.f.x;
  out[4LL * n + i] = s.f.y;
  out[5LL * n + i] = s.f.z;
  out[6LL * n + i] = s.pdf;
  lobe[i] = s.lobe;
}

MatPlanes mat_planes(const int* mtype, const uint8_t* nonlinear, const float* refl_x,
                     const float* refl_y, const float* refl_z, const float* spec_x,
                     const float* spec_y, const float* spec_z, const float* trans_x,
                     const float* trans_y, const float* trans_z, const float* eta3_x,
                     const float* eta3_y, const float* eta3_z, const float* k3_x,
                     const float* k3_y, const float* k3_z, const float* alpha,
                     const float* alpha_v, const float* eta, const float* int_fdr,
                     const float* ssw) {
  return {mtype,   nonlinear, {refl_x, refl_y, refl_z}, {spec_x, spec_y, spec_z},
          {trans_x, trans_y, trans_z}, {eta3_x, eta3_y, eta3_z}, {k3_x, k3_y, k3_z},
          alpha,   alpha_v,   eta,     int_fdr,        ssw};
}

bool valid_args(int n, int force, int mask) {
  return n >= 0 && force >= 0 && force <= kRoughPlastic && (mask & ~0xFE) == 0;
}

}  // namespace

// LocalBsdf's planes in the order of the dataclass (mtype, nonlinear,
// reflectance, specular, transmittance, eta3, k3 as x, y, z, then alpha,
// alpha_v, eta, int_fdr, ssw), wo and wi, n lanes; force: the type every
// lane takes (0: each lane its own mtype, when bit mtype of mask is set, and
// zeros otherwise). out: (4, n) f32 planes f.x, f.y, f.z, pdf.
extern "C" int launch_bsdf_eval(const int* mtype, const uint8_t* nonlinear,
                                const float* refl_x, const float* refl_y, const float* refl_z,
                                const float* spec_x, const float* spec_y, const float* spec_z,
                                const float* trans_x, const float* trans_y,
                                const float* trans_z, const float* eta3_x,
                                const float* eta3_y, const float* eta3_z, const float* k3_x,
                                const float* k3_y, const float* k3_z, const float* alpha,
                                const float* alpha_v, const float* eta, const float* int_fdr,
                                const float* ssw, const float* wo_x, const float* wo_y,
                                const float* wo_z, const float* wi_x, const float* wi_y,
                                const float* wi_z, int n, int force, int mask, float* out,
                                cudaStream_t stream) {
  if (!valid_args(n, force, mask)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const MatPlanes p = mat_planes(mtype, nonlinear, refl_x, refl_y, refl_z, spec_x, spec_y,
                                 spec_z, trans_x, trans_y, trans_z, eta3_x, eta3_y, eta3_z,
                                 k3_x, k3_y, k3_z, alpha, alpha_v, eta, int_fdr, ssw);
  const int blocks = (n + kThreads - 1) / kThreads;
  bsdf_eval_kernel<<<blocks, kThreads, 0, stream>>>(p, wo_x, wo_y, wo_z, wi_x, wi_y, wi_z, n,
                                                    force, mask, out);
  return static_cast<int>(cudaGetLastError());
}

// As launch_bsdf_eval, with wo and the three uniforms (u_lobe, u1, u2) in
// place of wo and wi. out: (7, n) f32 planes wi.x, wi.y, wi.z, f.x, f.y, f.z,
// pdf; lobe: (n,) i32.
extern "C" int launch_bsdf_sample(const int* mtype, const uint8_t* nonlinear,
                                  const float* refl_x, const float* refl_y,
                                  const float* refl_z, const float* spec_x,
                                  const float* spec_y, const float* spec_z,
                                  const float* trans_x, const float* trans_y,
                                  const float* trans_z, const float* eta3_x,
                                  const float* eta3_y, const float* eta3_z,
                                  const float* k3_x, const float* k3_y, const float* k3_z,
                                  const float* alpha, const float* alpha_v, const float* eta,
                                  const float* int_fdr, const float* ssw, const float* wo_x,
                                  const float* wo_y, const float* wo_z, const float* u_lobe,
                                  const float* u1, const float* u2, int n, int force,
                                  int mask, float* out, int* lobe, cudaStream_t stream) {
  if (!valid_args(n, force, mask)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const MatPlanes p = mat_planes(mtype, nonlinear, refl_x, refl_y, refl_z, spec_x, spec_y,
                                 spec_z, trans_x, trans_y, trans_z, eta3_x, eta3_y, eta3_z,
                                 k3_x, k3_y, k3_z, alpha, alpha_v, eta, int_fdr, ssw);
  const int blocks = (n + kThreads - 1) / kThreads;
  bsdf_sample_kernel<<<blocks, kThreads, 0, stream>>>(p, wo_x, wo_y, wo_z, u_lobe, u1, u2, n,
                                                      force, mask, out, lobe);
  return static_cast<int>(cudaGetLastError());
}
