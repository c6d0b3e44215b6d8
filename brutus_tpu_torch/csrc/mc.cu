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
// are skipped and write fixed constants (pallas_mc.py:148-158).
//
// Bound on this card: arithmetic (per draw ~20 transcendental functions
// and ~150 other operations; in the random-number mode another 7
// transcendental functions and ~80 integer operations of Philox).  The
// dust hat interpolation of the TPU kernel sums all 128 rungs to avoid
// gathers; a GPU thread reads the two rungs whose hat weights can be
// non-zero, which is the same sum.
//
// Design: one thread per (star, selected model); the draws are a loop
// inside the thread; per-star scalars and the dust ladder are read
// through the cache.  In the random-number mode the (B, 3, nmc_pad, K)
// normals never exist in device memory: each thread makes its own.
#include "common.cuh"

namespace {

// prm layout (ops/mc.py `_mc_params` writes the same order).
enum {
  kAvmin, kAvmax, kRvmin, kRvmax, kWidth, kInvW2, kWidth2, kMvnEps,
  kT0, kT1, kT2, kRsolar, kZsol, kRthin, kZthin, kRsThin2, kRthick,
  kZthick, kRsThick2, kRq, kRq2, kQinf, kQdiff, kRsHalo2, kEta,
  kReffSol, kLnFThick, kLnFHalo,
  kFehMu, kFehSig2 = kFehMu + 3, kFehLn = kFehSig2 + 3,
  kAgeMu = kFehLn + 3, kAgeSig = kAgeMu + 3, kAgeLo = kAgeSig + 3,
  kAgeHi = kAgeLo + 3, kAgeLden = kAgeHi + 3,
  kDustScale = kAgeLden + 3, kDustOffset, kDustSmoothScale,
  kDustScatter2, kNPrm
};
// iprm layout: row_map[11], use_feh, use_loga, use_dust, use_gal, passes.
enum { kUseFeh = 11, kUseLoga, kUseDust, kUseGal, kPasses };
// scal layout per star.
enum { kV0, kV1, kV2, kPm, kPw, kPln, kD0, kIdx, kCov, kUmax, kNScal };

constexpr int kNl = 128;                 // dust ladder rungs (NL_PAD)
constexpr float kLogSqrt2Pi = 0.91893853320467274f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kLn10 = 2.302585092994046f;

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

__global__ void mc_kernel(const float* __restrict__ tab,
                          const float* __restrict__ valid,
                          const float* __restrict__ scal,
                          const float* __restrict__ dust,
                          const float* __restrict__ z,
                          const int* __restrict__ seeds,
                          const int* __restrict__ flags,
                          const float* __restrict__ prm,
                          const int* __restrict__ iprm,
                          float* __restrict__ lnmc,
                          float* __restrict__ dist_o,
                          float* __restrict__ red_o,
                          float* __restrict__ dred_o,
                          float* __restrict__ agg, int B, int K,
                          int n_rows, int nmc, int nmc_pad, int tile) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (k >= K) return;
  const size_t dk = (size_t)b * nmc_pad * K + k;   // draw field base
  const size_t ak = (size_t)b * 8 * K + k;         // agg base
  const int n_tiles = K / tile;

  if (flags[(size_t)b * n_tiles + k / tile] == 0) {   // tile skip
    for (int r = 0; r < nmc_pad; ++r) {
      lnmc[dk + (size_t)r * K] = BK_NEG_BIG;
      dist_o[dk + (size_t)r * K] = 1.0f;
      red_o[dk + (size_t)r * K] = 0.0f;
      dred_o[dk + (size_t)r * K] = 0.0f;
    }
    agg[ak] = BK_NEG_BIG;
    for (int r = 1; r < 8; ++r) agg[ak + (size_t)r * K] = 0.0f;
    return;
  }

  const float* tk = tab + (size_t)b * n_rows * K + k;
  auto row = [&](int i) { return __ldg(tk + (size_t)iprm[i] * K); };
  const float mean_s = row(0), mean_a = row(1), mean_r = row(2);
  Parts icov;
  for (int j = 0; j < 6; ++j) icov.p[j] = row(3 + j);
  const bool validm = valid[(size_t)b * K + k] > 0.5f;

  // ---- PSD repair (utils.psd_repair_parts) + Cholesky ----
  const float width = prm[kWidth];
  const float sfrac = mean_s * width;
  Parts cov = inverse_parts(icov);
  const int passes = iprm[kPasses];
  for (int i = 0; i < passes; ++i) {
    const float count = (float)(1 << i);
    const bool not_psd = !is_psd(cov) && validm;
    const bool d1 = cov.p[0] <= 0.f, d2 = cov.p[1] <= 0.f,
               d3 = cov.p[2] <= 0.f;
    const float s1 = (d1 ? 1.f : 0.f) + ((!d2 && !d3) ? 1.f : 0.f);
    const float s2 = (d2 ? 1.f : 0.f) + ((!d1 && !d3) ? 1.f : 0.f);
    const float s3 = (d3 ? 1.f : 0.f) + ((!d1 && !d2) ? 1.f : 0.f);
    const float cw = count * prm[kInvW2];
    if (not_psd) {
      icov.p[0] = icov.p[0] + count / (sfrac * sfrac) * s1;
      icov.p[1] = icov.p[1] + cw * s2;
      icov.p[2] = icov.p[2] + cw * s3;
      cov = inverse_parts(icov);
    }
  }
  if (!is_psd(cov)) {
    const float w0 = nmax(sfrac * sfrac, 1e-30f);
    const float w2 = prm[kWidth2];
    const float d0 = cov.p[0], d1 = cov.p[1], d2 = cov.p[2];
    cov.p[0] = (d0 > 0.f && isfinite(d0)) ? d0 : w0;
    cov.p[1] = (d1 > 0.f && isfinite(d1)) ? d1 : w2;
    cov.p[2] = (d2 > 0.f && isfinite(d2)) ? d2 : w2;
    cov.p[3] = cov.p[4] = cov.p[5] = 0.f;
  }
  const float eps = prm[kMvnEps];
  cov.p[0] += eps;
  cov.p[1] += eps;
  cov.p[2] += eps;
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

  const float* sc = scal + (size_t)b * kNScal;
  const float v0 = sc[kV0], v1 = sc[kV1], v2 = sc[kV2];
  const float pm = sc[kPm], pw = sc[kPw], pln = sc[kPln];
  const float d0 = sc[kD0], idx_s = sc[kIdx], covered = sc[kCov];
  const float umax = sc[kUmax];
  const float* dmean = dust + (size_t)b * 2 * kNl;
  const float* dstd = dmean + kNl;
  const bool use_feh = iprm[kUseFeh], use_loga = iprm[kUseLoga];
  const bool use_dust = iprm[kUseDust], use_gal = iprm[kUseGal];

  float feh_g[3] = {0.f, 0.f, 0.f}, age_g[3] = {0.f, 0.f, 0.f};
  if (use_feh) {
    const float feh = row(9);
    for (int c = 0; c < 3; ++c) {
      const float dm = prm[kFehMu + c] - feh;
      feh_g[c] = -0.5f * (dm * dm / prm[kFehSig2 + c]) - prm[kFehLn + c];
    }
  }
  if (use_loga) {
    const float age = expf(kLn10 * row(10)) * 1e-9f;
    for (int c = 0; c < 3; ++c) {
      const float xi = (age - prm[kAgeMu + c]) / prm[kAgeSig + c];
      const float ans = -kLogSqrt2Pi - 0.5f * xi * xi - prm[kAgeLden + c];
      age_g[c] = (age < prm[kAgeLo + c] || age > prm[kAgeHi + c])
                     ? BK_NEG_BIG : ans;
    }
  }

  const float* zb = z ? z + (size_t)b * 3 * nmc_pad * K + k : nullptr;
  const uint2 key = seeds ? make_uint2((uint32_t)seeds[2 * b],
                                       (uint32_t)seeds[2 * b + 1])
                          : make_uint2(0u, 0u);
  const float avmin = prm[kAvmin], avmax = prm[kAvmax];
  const float rvmin = prm[kRvmin], rvmax = prm[kRvmax];
  float m_acc = BK_NEG_BIG, s_acc = 0.f, n_acc = 0.f;
  for (int c0 = 0; c0 < nmc_pad; c0 += 8) {
    float lnps[8];
    float cmax = -INFINITY;
    for (int r8 = 0; r8 < 8; ++r8) {
      const int rr = c0 + r8;
      float z0 = 0.f, z1 = 0.f, z2 = 0.f;
      if (zb) {
        z0 = zb[(size_t)rr * K];
        z1 = zb[(size_t)(nmc_pad + rr) * K];
        z2 = zb[(size_t)(2 * nmc_pad + rr) * K];
      } else if (rr < nmc) {
        philox_normals3(make_uint4((uint32_t)k, (uint32_t)rr, 0u, 0u), key,
                        &z0, &z1, &z2);
      }
      const float s = mean_s + L00 * z0;
      const float a = mean_a + L10 * z0 + L11 * z1;
      const float r = mean_r + L20 * z0 + L21 * z1 + L22 * z2;
      const float s_pos = nmax(s, 1e-30f);
      const float par = sqrtf(s_pos);
      const float dist = 1.0f / par;
      float lnp = 0.f;
      if (use_gal) {
        const float X = dist * v0 + prm[kT0];
        const float Y = dist * v1 + prm[kT1];
        const float Zg = dist * v2 + prm[kT2];
        const float R2 = X * X + Y * Y;
        const float vol = 2.0f * logf(dist);
        const float reff_t = sqrtf(R2 + prm[kRsThin2]);
        const float lt = -((reff_t - prm[kRsolar]) / prm[kRthin]
                           + (fabsf(Zg) - prm[kZsol]) / prm[kZthin]) + vol;
        const float reff_k = sqrtf(R2 + prm[kRsThick2]);
        const float lk = -((reff_k - prm[kRsolar]) / prm[kRthick]
                           + (fabsf(Zg) - prm[kZsol]) / prm[kZthick])
                         + vol + prm[kLnFThick];
        const float r2 = R2 + Zg * Zg;
        const float rp = sqrtf(r2 + prm[kRq2]);
        const float q = prm[kQinf] - prm[kQdiff] * expf(1.0f - rp / prm[kRq]);
        const float zq = Zg / q;
        const float reff_h = sqrtf(R2 + zq * zq + prm[kRsHalo2]);
        const float lh = prm[kEta] * logf(reff_h / prm[kReffSol]) + vol
                         + prm[kLnFHalo];
        const float mx = nmax(nmax(lt, lk), lh);
        const float lnden = mx + logf(expf(lt - mx) + expf(lk - mx)
                                      + expf(lh - mx));
        lnp = lnp + lnden;
        const float lw[3] = {lt - lnden, lk - lnden, lh - lnden};
        if (use_feh) {
          const float t0 = feh_g[0] + lw[0], t1 = feh_g[1] + lw[1],
                      t2 = feh_g[2] + lw[2];
          const float mf = nmax(nmax(t0, t1), t2);
          lnp = lnp + mf + logf(expf(t0 - mf) + expf(t1 - mf)
                                + expf(t2 - mf));
        }
        if (use_loga) {
          const float t0 = age_g[0] + lw[0], t1 = age_g[1] + lw[1],
                      t2 = age_g[2] + lw[2];
          const float ma = nmax(nmax(t0, t1), t2);
          lnp = lnp + ma + logf(expf(t0 - ma) + expf(t1 - ma)
                                + expf(t2 - ma));
        }
      }
      if (use_dust) {
        const float u = nclip((dist - d0) * idx_s, 0.0f, umax);
        const int lo = min((int)floorf(u), kNl - 1);
        const float w_lo = fmaxf(0.0f, 1.0f - fabsf(u - (float)lo));
        float mean_i = w_lo * dmean[lo];
        float std_i = w_lo * dstd[lo];
        if (lo + 1 < kNl) {
          const float w_hi = fmaxf(0.0f, 1.0f - fabsf(u - (float)(lo + 1)));
          mean_i = mean_i + w_hi * dmean[lo + 1];
          std_i = std_i + w_hi * dstd[lo + 1];
        }
        const float mean_d = prm[kDustScale] * mean_i + prm[kDustOffset];
        const float sd = prm[kDustSmoothScale] * std_i;
        const float err2 = sd * sd + prm[kDustScatter2];
        const float da = a - mean_d;
        const float dchi2 = da * da / err2;
        const float dpdf = -0.5f * (dchi2 + logf(kTwoPi * err2));
        lnp = lnp + (covered > 0.5f ? dpdf : 0.0f);
      }
      const float dp = par - pm;
      lnp = lnp - 0.5f * (dp * dp * pw + pln);
      const bool inb = (s >= 1e-20f) && (a >= avmin) && (a <= avmax)
                       && (r >= rvmin) && (r <= rvmax) && (rr < nmc);
      lnp = (inb && isfinite(lnp)) ? lnp : BK_NEG_BIG;
      lnmc[dk + (size_t)rr * K] = lnp;
      dist_o[dk + (size_t)rr * K] = dist;
      red_o[dk + (size_t)rr * K] = a;
      dred_o[dk + (size_t)rr * K] = r;
      lnps[r8] = lnp;
      cmax = nmax(cmax, lnp);
      n_acc += inb ? 1.0f : 0.0f;
    }
    const float nmx = nmax(m_acc, cmax);
    float ssum = 0.f;
    for (int r8 = 0; r8 < 8; ++r8) ssum += expf(lnps[r8] - nmx);
    s_acc = s_acc * expf(m_acc - nmx) + ssum;
    m_acc = nmx;
  }
  agg[ak] = m_acc + logf(nmax(s_acc, 1e-37f));
  agg[ak + K] = n_acc;
  for (int j = 0; j < 6; ++j) agg[ak + (size_t)(2 + j) * K] = cov.p[j];
}

}  // namespace

// tab (B, n_rows, K) gathered fit pack; valid (B, K) 0/1; scal (B, 10);
// dust (B, 2, 128) ladder mean | std; either z (B, 3, nmc_pad, K)
// standard normals or seeds (B, 2) int32 Philox keys, the other null;
// flags (B, K / tile) int32 tile-active; prm / iprm constants (see enums);
// outputs lnmc, dist, red, dred (B, nmc_pad, K) and agg (B, 8, K) =
// [logsumexp, in-bounds count, 6 repaired covariance parts].
extern "C" int bk_mc(const float* tab, const float* valid, const float* scal,
                     const float* dust, const float* z, const int* seeds,
                     const int* flags, const float* prm, const int* iprm,
                     float* lnmc,
                     float* dist, float* red, float* dred, float* agg,
                     int B, int K, int n_rows, int nmc, int nmc_pad,
                     int tile, int n_prm, void* stream) {
  if (n_prm != kNPrm || nmc_pad % 8 != 0 || K % tile != 0
      || (z == nullptr) == (seeds == nullptr))
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  dim3 grid(bk_ceil_div(K, threads), B);
  mc_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      tab, valid, scal, dust, z, seeds, flags, prm, iprm, lnmc, dist, red,
      dred, agg, B, K, n_rows, nmc, nmc_pad, tile);
  return (int)cudaGetLastError();
}
