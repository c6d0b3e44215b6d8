// K4: fused Monte-Carlo integration of the posterior.
//
// Replaces brutus_tpu/ops/pallas_mc.py:101 _make_mc_kernel (launched
// from _make_mc_call:373, pallas_call at :420; wrapper mc_integrate:425)
// in both of its modes: fed normals (`z`) and in-kernel random numbers
// (`seeds`, the TPU kernel's default, pallas_mc.py:166-175, 241-257).
//
// For every (star, selected model): escalating PSD repair (8 passes)
// of the (s, Av, Rv) precision and its Cholesky factor; n_mc draws
// s, Av, Rv = mean + L z from the given standard normals `z`, or from
// normals made in registers: Philox4x32-10 keyed by the star's seed
// pair, counter (model, draw row, 0, 0), then Box-Muller
// (common.cuh `philox_normals3`; rows from n_mc on are zero); per draw
// the Galactocentric (R, Z) thin/thick-disk and halo log-densities with
// the feh and age mixtures, the dust prior interpolated on a uniform
// ladder of at most 128 rungs, the parallax prior and the bounds mask;
// an online logsumexp and in-bounds count over the draws, in chunks of
// 8 draws as the TPU kernel sums them.  Model tiles with no valid model
// are skipped and write fixed constants (pallas_mc.py:148-158); the
// caller picks the tile (the fit's 512 on the funnel path).
//
// Bound on this card: at the funnel's shape (128 stars x 2048 models,
// 56 draw rows) the bytes of the four (B, 56, K) outputs, which every
// column writes, skipped or not; with the in-kernel normals the
// arithmetic (Philox, ~30 special functions per draw split between the
// special-function units and the FMA pipes) comes first, at ~0.084 ms
// (chip_smoke.py `mc_bound`).  The TPU kernel sums the dust hat interpolation
// over all 128 rungs to avoid gathers; here a thread reads the two rungs
// whose hat weights can be non-zero from the star's ladder in shared
// memory, which is the same sum.
//
// Design: one thread per (star, selected model), the draws a loop inside
// the thread (not unrolled: the code stays small), one star per block,
// at most 64 registers.  What sets a sample or a mask (the
// PSD repair, the Cholesky factor, s, Av, Rv, parallax, distance, the
// dust rung and the bounds test) keeps IEEE arithmetic without
// contraction, as the plain version rounds it.  The log-densities, whose
// limits are 1e-3, use the special-function unit: __expf, __logf,
// __fdividef, approximate square roots, products with reciprocals of the
// constants (the wrapper computes them) and explicit fmaf.  The
// constants ride the kernel's parameters (the constant bank); the mode
// and the prior flags are
// template parameters; padding draw rows (n_mc and beyond) write their
// fixed values without evaluating a prior; the outputs, written once
// and read by a later kernel, go out as streaming stores.  In the
// random-number mode the (B, 3, nmc_pad, K) normals never exist in
// device memory: each thread makes its own, with the accurate libm
// functions of `philox_normals3`, so they are the bits `rng.normals`
// makes.
#include <string.h>

#include "common.cuh"

namespace {

// prm layout (ops/mc.py `_mc_params` writes the same order); the
// divisors of the log-densities come as reciprocals (kInv*).
enum {
  kAvmin, kAvmax, kRvmin, kRvmax, kWidth, kInvW2, kWidth2, kMvnEps,
  kT0, kT1, kT2, kRsolar, kZsol, kInvRthin, kInvZthin, kRsThin2,
  kInvRthick, kInvZthick, kRsThick2, kInvRq, kRq2, kQinf, kQdiff,
  kRsHalo2, kEta, kInvReffSol, kLnFThick, kLnFHalo,
  kFehMu, kFehSig2 = kFehMu + 3, kFehLn = kFehSig2 + 3,
  kAgeMu = kFehLn + 3, kAgeSig = kAgeMu + 3, kAgeLo = kAgeSig + 3,
  kAgeHi = kAgeLo + 3, kAgeLden = kAgeHi + 3,
  kDustScale = kAgeLden + 3, kDustOffset, kDustSmoothScale,
  kDustScatter2, kNPrm
};
// iprm layout: row_map[11], use_feh, use_loga, use_dust, use_gal, passes.
enum { kUseFeh = 11, kUseLoga, kUseDust, kUseGal, kPasses, kNIprm };
// scal layout per star.
enum { kV0, kV1, kV2, kPm, kPw, kPln, kD0, kIdx, kCov, kUmax, kNScal };

constexpr int kNl = 128;                 // dust ladder rungs (NL_PAD)
constexpr int kThreads = 128;            // models per block (one star)
constexpr float kLogSqrt2Pi = 0.91893853320467274f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kLn10 = 2.302585092994046f;

// Everything that does not change within a launch, passed by value: the
// kernel reads it from the constant bank, indexed by the enums above.
struct McConst {
  float prm[kNPrm];
  int iprm[kNIprm];
  int n_rows, K, nmc, nmc_pad, tile;
};

struct McIO {
  const float* tab;
  const float* valid;
  const float* scal;
  const float* dust;
  const float* z;
  const int* seeds;
  const int* flags;
  float* lnmc;
  float* dist;
  float* red;
  float* dred;
  float* agg;
};

struct Parts { float p[6]; };            // p00, p11, p22, p01, p02, p12

__device__ __forceinline__ void equilibrate(const Parts& a, Parts& bp,
                                            float e[3]) {
  e[0] = 1.0f / sqrtf(nmax(fabsf(a.p[0]), 1e-30f));
  e[1] = 1.0f / sqrtf(nmax(fabsf(a.p[1]), 1e-30f));
  e[2] = 1.0f / sqrtf(nmax(fabsf(a.p[2]), 1e-30f));
  bp.p[0] = a.p[0] * e[0] * e[0];
  bp.p[1] = a.p[1] * e[1] * e[1];
  bp.p[2] = a.p[2] * e[2] * e[2];
  bp.p[3] = a.p[3] * e[0] * e[1];
  bp.p[4] = a.p[4] * e[0] * e[2];
  bp.p[5] = a.p[5] * e[1] * e[2];
}

// utils.inverse3_sym_parts
__device__ __forceinline__ Parts inverse_parts(const Parts& in) {
  Parts bp;
  float e[3];
  equilibrate(in, bp, e);
  const float a = bp.p[0], d = bp.p[1], f = bp.p[2];
  const float b = bp.p[3], c = bp.p[4], ee = bp.p[5];
  const float adj00 = d * f - ee * ee;
  const float adj01 = ee * c - b * f;
  const float adj02 = b * ee - d * c;
  const float adj11 = f * a - c * c;
  const float adj12 = c * b - ee * a;
  const float adj22 = a * d - b * b;
  const float det = (adj00 * a + adj01 * b + adj02 * c + adj01 * b
                     + adj11 * d + adj12 * ee + adj02 * c + adj12 * ee
                     + adj22 * f) / 3.0f;
  Parts o;
  o.p[0] = adj00 / det * e[0] * e[0];
  o.p[1] = adj11 / det * e[1] * e[1];
  o.p[2] = adj22 / det * e[2] * e[2];
  o.p[3] = adj01 / det * e[0] * e[1];
  o.p[4] = adj02 / det * e[0] * e[2];
  o.p[5] = adj12 / det * e[1] * e[2];
  return o;
}

// utils.is_psd3_parts
__device__ __forceinline__ bool is_psd(const Parts& in) {
  Parts q;
  float e[3];
  equilibrate(in, q, e);
  const float a = q.p[0], ee = q.p[1], i = q.p[2];
  const float b = q.p[3], c = q.p[4], f = q.p[5];
  const float m1 = a;
  const float m2 = a * ee - b * b;
  const float m3 = a * (ee * i - f * f) - b * (b * i - f * c)
                   + c * (b * f - ee * c);
  return (m1 > 0.f) && (m2 > 0.f) && (m3 > 0.f);
}

// sqrt.approx: one special-function instruction (sqrt(0) = 0).
__device__ __forceinline__ float fast_sqrt(float x) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// log(exp(t0) + exp(t1) + exp(t2)), the largest term factored out.
__device__ __forceinline__ float lse3(float t0, float t1, float t2) {
  const float m = nmax(nmax(t0, t1), t2);
  return m + __logf(__expf(t0 - m) + __expf(t1 - m) + __expf(t2 - m));
}

// The log-prior of one draw at distance `dist` with reddening `a`: the
// Galactic density with its feh and age mixtures and the dust prior
// (the parallax prior and the bounds test are the caller's).
template <bool GAL, bool FEH, bool LOGA, bool DUST>
__device__ __forceinline__ float log_prior(
    const McConst& c, float dist, float a, float v0, float v1, float v2,
    const float feh_g[3], const float age_g[3], float d0, float idx_s,
    float umax, float covered, const float2* lad) {
  const float* p = c.prm;
  float lnp = 0.f;
  if (GAL) {
    const float X = fmaf(dist, v0, p[kT0]);
    const float Y = fmaf(dist, v1, p[kT1]);
    const float Zg = fmaf(dist, v2, p[kT2]);
    const float R2 = fmaf(X, X, Y * Y);
    const float vol = 2.0f * __logf(dist);
    const float az = fabsf(Zg) - p[kZsol];
    const float reff_t = fast_sqrt(R2 + p[kRsThin2]);
    const float lt = vol - fmaf(reff_t - p[kRsolar], p[kInvRthin],
                                az * p[kInvZthin]);
    const float reff_k = fast_sqrt(R2 + p[kRsThick2]);
    const float lk = vol - fmaf(reff_k - p[kRsolar], p[kInvRthick],
                                az * p[kInvZthick]) + p[kLnFThick];
    const float rp = fast_sqrt(fmaf(Zg, Zg, R2) + p[kRq2]);
    const float q = fmaf(-p[kQdiff], __expf(fmaf(-rp, p[kInvRq], 1.0f)),
                         p[kQinf]);
    const float zq = __fdividef(Zg, q);
    const float reff_h = fast_sqrt(fmaf(zq, zq, R2 + p[kRsHalo2]));
    const float lh = fmaf(p[kEta], __logf(reff_h * p[kInvReffSol]), vol)
                     + p[kLnFHalo];
    const float lnden = lse3(lt, lk, lh);
    lnp = lnden;
    if (FEH)
      lnp += lse3(feh_g[0] + (lt - lnden), feh_g[1] + (lk - lnden),
                  feh_g[2] + (lh - lnden));
    if (LOGA)
      lnp += lse3(age_g[0] + (lt - lnden), age_g[1] + (lk - lnden),
                  age_g[2] + (lh - lnden));
  }
  if (DUST) {
    const float u = nclip((dist - d0) * idx_s, 0.0f, umax);
    const int lo = min((int)floorf(u), kNl - 1);
    const float w_lo = fmaxf(0.0f, 1.0f - fabsf(u - (float)lo));
    const float2 l0 = lad[lo];
    float mean_i = w_lo * l0.x;
    float std_i = w_lo * l0.y;
    if (lo + 1 < kNl) {
      const float w_hi = fmaxf(0.0f, 1.0f - fabsf(u - (float)(lo + 1)));
      const float2 l1 = lad[lo + 1];
      mean_i = fmaf(w_hi, l1.x, mean_i);
      std_i = fmaf(w_hi, l1.y, std_i);
    }
    const float da = a - fmaf(p[kDustScale], mean_i, p[kDustOffset]);
    const float sd = p[kDustSmoothScale] * std_i;
    const float err2 = fmaf(sd, sd, p[kDustScatter2]);
    const float dpdf = -0.5f * (__fdividef(da * da, err2)
                                + __logf(kTwoPi * err2));
    lnp += covered > 0.5f ? dpdf : 0.0f;
  }
  return lnp;
}

// At most 64 registers: eight blocks, 32 warps, on each SM.
template <bool RNG, bool GAL, bool FEH, bool LOGA, bool DUST>
__global__ void __launch_bounds__(kThreads, 8)
    mc_kernel(const McIO io, const __grid_constant__ McConst c) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  const int K = c.K, nmc = c.nmc, nmc_pad = c.nmc_pad;
  const float* p = c.prm;

  // the star's dust ladder as (mean, std) pairs
  __shared__ float2 lad[DUST ? kNl : 1];
  if (DUST) {
    const float* dm = io.dust + (size_t)b * 2 * kNl;
    for (int i = threadIdx.x; i < kNl; i += kThreads)
      lad[i] = make_float2(dm[i], dm[kNl + i]);
    __syncthreads();
  }
  if (k >= K) return;
  const size_t dk = (size_t)b * nmc_pad * K + k;   // draw field base
  const size_t ak = (size_t)b * 8 * K + k;         // agg base

  if (io.flags[(size_t)b * (K / c.tile) + k / c.tile] == 0) {  // skip
    for (int r = 0; r < nmc_pad; ++r) {
      const size_t o = dk + (size_t)r * K;
      __stcs(io.lnmc + o, BK_NEG_BIG);
      __stcs(io.dist + o, 1.0f);
      __stcs(io.red + o, 0.0f);
      __stcs(io.dred + o, 0.0f);
    }
    __stcs(io.agg + ak, BK_NEG_BIG);
    for (int r = 1; r < 8; ++r) __stcs(io.agg + ak + (size_t)r * K, 0.0f);
    return;
  }

  const float* tk = io.tab + (size_t)b * c.n_rows * K + k;
  auto row = [&](int i) { return __ldg(tk + (size_t)c.iprm[i] * K); };
  const float mean_s = row(0), mean_a = row(1), mean_r = row(2);
  Parts icov;
#pragma unroll
  for (int j = 0; j < 6; ++j) icov.p[j] = row(3 + j);
  const bool validm = io.valid[(size_t)b * K + k] > 0.5f;

  // ---- PSD repair (utils.psd_repair_parts) + Cholesky ----
  const float sfrac = mean_s * p[kWidth];
  Parts cov = inverse_parts(icov);
  for (int i = 0; i < c.iprm[kPasses]; ++i) {
    const float count = (float)(1 << i);
    const bool not_psd = !is_psd(cov) && validm;
    const bool d1 = cov.p[0] <= 0.f, d2 = cov.p[1] <= 0.f,
               d3 = cov.p[2] <= 0.f;
    const float s1 = (d1 ? 1.f : 0.f) + ((!d2 && !d3) ? 1.f : 0.f);
    const float s2 = (d2 ? 1.f : 0.f) + ((!d1 && !d3) ? 1.f : 0.f);
    const float s3 = (d3 ? 1.f : 0.f) + ((!d1 && !d2) ? 1.f : 0.f);
    const float cw = count * p[kInvW2];
    if (not_psd) {
      icov.p[0] = icov.p[0] + count / (sfrac * sfrac) * s1;
      icov.p[1] = icov.p[1] + cw * s2;
      icov.p[2] = icov.p[2] + cw * s3;
      cov = inverse_parts(icov);
    }
  }
  if (!is_psd(cov)) {
    const float w0 = nmax(sfrac * sfrac, 1e-30f);
    const float d0 = cov.p[0], d1 = cov.p[1], d2 = cov.p[2];
    cov.p[0] = (d0 > 0.f && isfinite(d0)) ? d0 : w0;
    cov.p[1] = (d1 > 0.f && isfinite(d1)) ? d1 : p[kWidth2];
    cov.p[2] = (d2 > 0.f && isfinite(d2)) ? d2 : p[kWidth2];
    cov.p[3] = cov.p[4] = cov.p[5] = 0.f;
  }
  cov.p[0] += p[kMvnEps];
  cov.p[1] += p[kMvnEps];
  cov.p[2] += p[kMvnEps];
  // utils.cholesky3_parts
  Parts bp;
  float e[3];
  equilibrate(cov, bp, e);
  const float l11 = sqrtf(bp.p[0]);
  const float l21 = bp.p[3] / l11;
  const float l31 = bp.p[4] / l11;
  const float l22 = sqrtf(bp.p[1] - l21 * l21);
  const float l32 = (bp.p[5] - l31 * l21) / l22;
  const float l33 = sqrtf(bp.p[2] - l31 * l31 - l32 * l32);
  const float L00 = l11 / e[0], L10 = l21 / e[1], L11 = l22 / e[1];
  const float L20 = l31 / e[2], L21 = l32 / e[2], L22 = l33 / e[2];

  const float* sc = io.scal + (size_t)b * kNScal;
  const float v0 = sc[kV0], v1 = sc[kV1], v2 = sc[kV2];
  const float pm = sc[kPm], pw = sc[kPw], pln = sc[kPln];
  const float d0 = sc[kD0], idx_s = sc[kIdx], covered = sc[kCov];
  const float umax = sc[kUmax];

  // per-model mixture terms, as the plain version rounds them
  float feh_g[3] = {0.f, 0.f, 0.f}, age_g[3] = {0.f, 0.f, 0.f};
  if (FEH) {
    const float feh = row(9);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float dm = p[kFehMu + j] - feh;
      feh_g[j] = -0.5f * (dm * dm / p[kFehSig2 + j]) - p[kFehLn + j];
    }
  }
  if (LOGA) {
    const float age = expf(kLn10 * row(10)) * 1e-9f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float xi = (age - p[kAgeMu + j]) / p[kAgeSig + j];
      const float ans = -kLogSqrt2Pi - 0.5f * xi * xi - p[kAgeLden + j];
      age_g[j] = (age < p[kAgeLo + j] || age > p[kAgeHi + j]) ? BK_NEG_BIG
                                                              : ans;
    }
  }

  const float* zb = RNG ? nullptr : io.z + (size_t)b * 3 * nmc_pad * K + k;
  const uint2 key = RNG ? make_uint2((uint32_t)io.seeds[2 * b],
                                     (uint32_t)io.seeds[2 * b + 1])
                        : make_uint2(0u, 0u);
  float m_acc = BK_NEG_BIG, s_acc = 0.f, n_acc = 0.f;
  for (int c0 = 0; c0 < nmc_pad; c0 += 8) {
    float lnps[8];
    float cmax = -INFINITY;
    // One draw per iteration: eight unrolled draws of the random-number
    // instances (the libm slow paths of Box-Muller inlined eight times)
    // spanned ~6000 instructions and ran slower on the card.
#pragma unroll 1
    for (int r8 = 0; r8 < 8; ++r8) {
      const int rr = c0 + r8;
      const bool real = rr < nmc;
      float z0 = 0.f, z1 = 0.f, z2 = 0.f;
      if (!RNG) {
        z0 = __ldcs(zb + (size_t)rr * K);
        z1 = __ldcs(zb + (size_t)(nmc_pad + rr) * K);
        z2 = __ldcs(zb + (size_t)(2 * nmc_pad + rr) * K);
      } else if (real) {
        philox_normals3(make_uint4((uint32_t)k, (uint32_t)rr, 0u, 0u), key,
                        &z0, &z1, &z2);
      }
      const float s = mean_s + L00 * z0;
      const float a = mean_a + L10 * z0 + L11 * z1;
      const float r = mean_r + L20 * z0 + L21 * z1 + L22 * z2;
      const float par = sqrtf(nmax(s, 1e-30f));
      const float dist = 1.0f / par;
      float lnp = BK_NEG_BIG;
      if (real) {
        const float dp = par - pm;
        lnp = log_prior<GAL, FEH, LOGA, DUST>(c, dist, a, v0, v1, v2, feh_g,
                                              age_g, d0, idx_s, umax,
                                              covered, lad)
              - 0.5f * fmaf(dp * dp, pw, pln);
        const bool inb = (s >= 1e-20f) && (a >= p[kAvmin])
                         && (a <= p[kAvmax]) && (r >= p[kRvmin])
                         && (r <= p[kRvmax]);
        lnp = (inb && isfinite(lnp)) ? lnp : BK_NEG_BIG;
        n_acc += inb ? 1.0f : 0.0f;
      }
      const size_t o = dk + (size_t)rr * K;
      __stcs(io.lnmc + o, lnp);
      __stcs(io.dist + o, dist);
      __stcs(io.red + o, a);
      __stcs(io.dred + o, r);
      lnps[r8] = lnp;
      cmax = nmax(cmax, lnp);
    }
    const float nmx = nmax(m_acc, cmax);
    float ssum = 0.f;
#pragma unroll
    for (int r8 = 0; r8 < 8; ++r8) ssum += __expf(lnps[r8] - nmx);
    s_acc = fmaf(s_acc, __expf(m_acc - nmx), ssum);
    m_acc = nmx;
  }
  __stcs(io.agg + ak, m_acc + logf(nmax(s_acc, 1e-37f)));
  __stcs(io.agg + ak + K, n_acc);
#pragma unroll
  for (int j = 0; j < 6; ++j) __stcs(io.agg + ak + (size_t)(2 + j) * K,
                                     cov.p[j]);
}

using McFn = void (*)(McIO, McConst);

// The instance for a mode and its prior flags; without the Galactic
// prior the feh and age mixtures do not apply (pallas_mc.py:285-315).
template <bool RNG, bool GAL, bool FEH, bool LOGA>
McFn pick_dust(bool dust) {
  return dust ? mc_kernel<RNG, GAL, FEH, LOGA, true>
              : mc_kernel<RNG, GAL, FEH, LOGA, false>;
}

template <bool RNG>
McFn pick(bool gal, bool feh, bool loga, bool dust) {
  if (!gal) return pick_dust<RNG, false, false, false>(dust);
  if (feh) return loga ? pick_dust<RNG, true, true, true>(dust)
                       : pick_dust<RNG, true, true, false>(dust);
  return loga ? pick_dust<RNG, true, false, true>(dust)
              : pick_dust<RNG, true, false, false>(dust);
}

McFn mc_instance(bool rng, bool gal, bool feh, bool loga, bool dust) {
  return rng ? pick<true>(gal, feh, loga, dust)
             : pick<false>(gal, feh, loga, dust);
}

}  // namespace

// tab (B, n_rows, K) gathered fit pack; valid (B, K) 0/1; scal (B, 10);
// dust (B, 2, 128) ladder mean | std; either z (B, 3, nmc_pad, K)
// standard normals or seeds (B, 2) int32 Philox keys, the other null;
// flags (B, K / tile) int32 tile-active; prm (n_prm) / iprm (n_iprm)
// constants in host memory (see the enums), copied into the launch's
// parameters; outputs lnmc, dist, red, dred (B, nmc_pad, K) and agg
// (B, 8, K) =
// [logsumexp, in-bounds count, 6 repaired covariance parts].
extern "C" int bk_mc(const float* tab, const float* valid, const float* scal,
                     const float* dust, const float* z, const int* seeds,
                     const int* flags, const float* prm, const int* iprm,
                     float* lnmc, float* dist, float* red, float* dred,
                     float* agg, int B, int K, int n_rows, int nmc,
                     int nmc_pad, int tile, int n_prm, int n_iprm,
                     void* stream) {
  if (n_prm != kNPrm || n_iprm != kNIprm || nmc_pad % 8 != 0
      || nmc_pad < nmc || tile <= 0 || K % tile != 0
      || (z == nullptr) == (seeds == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || K == 0) return 0;
  McConst c;
  memcpy(c.prm, prm, sizeof c.prm);
  memcpy(c.iprm, iprm, sizeof c.iprm);
  c.n_rows = n_rows;
  c.K = K;
  c.nmc = nmc;
  c.nmc_pad = nmc_pad;
  c.tile = tile;
  const McIO io{tab, valid, scal, dust, z, seeds, flags,
                lnmc, dist, red, dred, agg};
  const McFn fn = mc_instance(seeds != nullptr, iprm[kUseGal] != 0,
                              iprm[kUseFeh] != 0, iprm[kUseLoga] != 0,
                              iprm[kUseDust] != 0);
  dim3 grid(bk_ceil_div(K, kThreads), B);
  fn<<<grid, kThreads, 0, (cudaStream_t)stream>>>(io, c);
  return (int)cudaGetLastError();
}

// Registers and local bytes per thread of the K4 instance for a mode
// (`rng`) and prior flags.
extern "C" int bk_mc_attrs(int rng, int gal, int feh, int loga, int dust,
                           int* out) {
  cudaFuncAttributes at;
  const cudaError_t e = cudaFuncGetAttributes(
      &at, (const void*)mc_instance(rng, gal, feh, loga, dust));
  if (e != cudaSuccess) return (int)e;
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  return 0;
}
