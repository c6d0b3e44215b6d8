// K1: grid fit of every (star, model), in two modes.
//
// Replaces brutus_tpu/ops/pallas_loglike.py:66 _make_kernel (launched
// from _make_call:774, pallas_call at :819) in both of its modes:
// - per-star stacked (`bk_fit`): each star fits its own gathered
//   shortlist and writes one pack (B, n_rows, P) with the Gaussian
//   constant and chi2 dimensionality prior applied, padding models
//   masked by grid index, and the aux rows and the grid index copied
//   through (:294-323).  Row order: lnlike, chi2, scale, av, rv, i00,
//   i11, i22, i01, i02, i12, aux..., gidx.
// - dense (`bk_fit_dense`, wrapper loglike_grid_fused:710): every star
//   fits every model of one shared (3, F, Mp) grid and writes the 11
//   fields as (11, B, Mp) planes, with `_post` (:666-696: models at or
//   above n_real masked, Gaussian constant, chi2 dimensionality prior)
//   applied in the same epilogue.
//
// For every (star, model): the direct 3x3 magnitude-space seed of
// (mu, Av, Av*Rv) (:176-208), 6 alternating clamped Av/Rv solves
// (:210-240), the freeze mask local to the `tile`-wide window of the
// model axis (:248-252), 6 damped flux-space updates with the MLE flux
// scale re-expanded each time (:255-273), then chi2, scale, Av, Rv and
// the 6 precision parts.
//
// Bound on this card: arithmetic (~1k f32 operations and ~100 expf per
// model at F=8 against 4 * (3F + n_aux) bytes of input).
//
// Design: one thread per model, one CUDA block per (star, tile); the
// block IS the freeze window, so its max reduction reproduces the
// tile-local freeze of the TPU kernel exactly.  The two modes differ
// only in strides: the dense grid has no star stride (every block of a
// window reads the same coefficients, through the cache).  Per-filter
// state (magnitude residuals, extinction vectors, model fluxes) lives in
// thread-local arrays of at most kMaxF filters; the star's data sits in
// shared memory.
#include "common.cuh"

namespace {

constexpr int kMaxF = 64;
constexpr float kFluxFac = (float)(-0.4 * 2.302585092994046);

struct Prm {
  float avm, avvi, rvm, rvvi, a_reg, r_reg, avmin, avmax, rvmin, rvmax,
      ln_init_thresh, scale_min, rescale, avm_avvi, rvm_rvvi;
};

__device__ __forceinline__ Prm load_prm(const float* p) {
  Prm q;
  q.avm = p[0]; q.avvi = p[1]; q.rvm = p[2]; q.rvvi = p[3];
  q.a_reg = p[4]; q.r_reg = p[5]; q.avmin = p[6]; q.avmax = p[7];
  q.rvmin = p[8]; q.rvmax = p[9]; q.ln_init_thresh = p[10];
  q.scale_min = p[11]; q.rescale = p[12]; q.avm_avvi = p[13];
  q.rvm_rvvi = p[14];
  return q;
}

// Flux-space MLE re-expansion (pallas_loglike.py `mle`): fills the
// model fluxes m[f] and returns the clamped flux scale; s_den floored.
__device__ __forceinline__ float mle_scale(
    int F, const float* flux, const float* wtf, const float* m_int,
    const float* r0, const float* dr, float av, float rv, float scale_min,
    float* m, float* s_den_out) {
  float s_num = 0.f, s_den = 0.f;
  for (int f = 0; f < F; ++f) {
    const float rvec_m = r0[f] + rv * dr[f];
    const float mf = m_int[f] * expf(kFluxFac * (av * rvec_m));
    m[f] = mf;
    s_num += mf * flux[f] * wtf[f];
    s_den += mf * mf * wtf[f];
  }
  s_den = nmax(s_den, 1e-30f);
  *s_den_out = s_den;
  return nmax(s_num / s_den, scale_min);
}

// Element strides of the coefficient operand (per star, per coefficient
// row) and of the output (per star, per row).
struct Strides {
  size_t coef_b, coef_row, out_b, out_row;
};

// gidx == nullptr selects the dense mode: the grid index is the model
// column p, and only the 11 fit rows are written.
__global__ void fit_kernel(const float* __restrict__ star,
                           const float* __restrict__ coef,
                           const int* __restrict__ gidx,
                           const float* __restrict__ srow,
                           const float* __restrict__ prm_in,
                           float* __restrict__ out, int F, int n_aux,
                           int n_rows, int n_real_mask, int mag_iters,
                           int flux_iters, int dim_prior, Strides st) {
  extern __shared__ float sh[];
  float* sflux = sh;
  float* swtf = sh + F;
  float* smags = sh + 2 * F;
  float* swtm = sh + 3 * F;
  float* red = sh + 4 * F;
  const int b = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = threadIdx.x; i < 4 * F; i += blockDim.x)
    sh[i] = star[(size_t)b * 4 * F + i];
  __syncthreads();
  const Prm q = load_prm(prm_in);
  const size_t crow = st.coef_row;
  const float* c0 = coef + (size_t)b * st.coef_b + p;

  float mag0[kMaxF], r0[kMaxF], dr[kMaxF], m_int[kMaxF];
  float resid[kMaxF], rvec[kMaxF], m[kMaxF];
  for (int f = 0; f < F; ++f) {
    mag0[f] = __ldg(c0 + f * crow);
    r0[f] = __ldg(c0 + (F + f) * crow);
    dr[f] = __ldg(c0 + (2 * F + f) * crow);
    m_int[f] = expf(kFluxFac * mag0[f]);
  }

  // ---- phase A seed: direct 3x3 WLS of (mu, Av, Av*Rv) ----
  float a00 = 0.f, a01 = 0.f, a02 = 0.f, a11 = 0.f, a12 = 0.f, a22 = 0.f,
        b0 = 0.f, b1 = 0.f, b2 = 0.f;
  for (int f = 0; f < F; ++f) {
    const float w = swtm[f];
    const float rs0 = smags[f] - mag0[f];
    a00 += w;
    a01 += r0[f] * w;
    a02 += dr[f] * w;
    a11 += r0[f] * r0[f] * w;
    a12 += r0[f] * dr[f] * w;
    a22 += dr[f] * dr[f] * w;
    b0 += rs0 * w;
    b1 += rs0 * r0[f] * w;
    b2 += rs0 * dr[f] * w;
  }
  a11 += q.avvi;
  b1 += q.avm_avvi;
  const float det = (a00 * (a11 * a22 - a12 * a12)
                     - a01 * (a01 * a22 - a12 * a02)
                     + a02 * (a01 * a12 - a11 * a02));
  const float det1 = (a00 * (b1 * a22 - a12 * b2)
                      - b0 * (a01 * a22 - a12 * a02)
                      + a02 * (a01 * b2 - b1 * a02));
  const float det2 = (a00 * (a11 * b2 - b1 * a12)
                      - a01 * (a01 * b2 - b1 * a02)
                      + b0 * (a01 * a12 - a11 * a02));
  const float safe_det = fabsf(det) > 1e-30f ? det : 1.0f;
  float av = nclip(det1 / safe_det, q.avmin, q.avmax);
  const float avrv = det2 / safe_det;
  float rv = fabsf(av) > 1e-10f ? avrv / av : q.rvm;
  rv = nclip(rv, q.rvmin, q.rvmax);

  // ---- phase A: alternating clamped (Av, Rv) solves ----
  float s_den_m = 0.f, rp_den = 0.f, srp = 0.f;
  for (int f = 0; f < F; ++f) {
    rvec[f] = r0[f] + rv * dr[f];
    resid[f] = smags[f] - (mag0[f] + av * rvec[f]);
    s_den_m += swtm[f];
    rp_den += dr[f] * dr[f] * swtm[f];
    srp += dr[f] * swtm[f];
  }
  for (int it = 0; it < mag_iters; ++it) {
    float a_den = 0.f, sa = 0.f, rs = 0.f, ra = 0.f;
    for (int f = 0; f < F; ++f) {
      const float w = swtm[f];
      a_den += rvec[f] * rvec[f] * w;
      sa += rvec[f] * w;
      rs += resid[f] * w;
      ra += resid[f] * rvec[f] * w;
    }
    a_den += q.avvi;
    ra += (q.avm - av) * q.avvi;
    float dav = (s_den_m * ra - sa * rs) / (s_den_m * a_den - sa * sa);
    dav = nclip(dav, q.avmin - av, q.avmax - av);
    av = av + dav;
    for (int f = 0; f < F; ++f) resid[f] = resid[f] - dav * rvec[f];

    const float r_den = rp_den * av * av + q.rvvi;
    const float sr = srp * av;
    float rs2 = 0.f, rd = 0.f;
    for (int f = 0; f < F; ++f) {
      rs2 += resid[f] * swtm[f];
      rd += resid[f] * dr[f] * swtm[f];
    }
    const float rr = av * rd + (q.rvm - rv) * q.rvvi;
    float drv = (s_den_m * rr - sr * rs2) / (s_den_m * r_den - sr * sr);
    drv = nclip(drv, q.rvmin - rv, q.rvmax - rv);
    rv = rv + drv;
    for (int f = 0; f < F; ++f) {
      resid[f] = resid[f] - (av * drv) * dr[f];
      rvec[f] = rvec[f] + drv * dr[f];
    }
  }

  // ---- phase B: flux-space damped polish with the tile-local freeze ----
  float s_den;
  float scale = mle_scale(F, sflux, swtf, m_int, r0, dr, av, rv,
                          q.scale_min, m, &s_den);
  // chi2 and the four update sums of the current (av, rv, scale).
  float chi2 = 0.f, an = 0.f, ad = 0.f, rn = 0.f, rdn = 0.f;
  for (int f = 0; f < F; ++f) {
    const float ms = m[f] * scale;
    const float res = sflux[f] - ms;
    const float rvs = kFluxFac * m[f] * (r0[f] + rv * dr[f]) * scale;
    const float drvs = kFluxFac * m[f] * dr[f] * scale;
    chi2 += res * res * swtf[f];
    an += rvs * res * swtf[f];
    ad += rvs * rvs * swtf[f];
    rn += drvs * res * swtf[f];
    rdn += drvs * drvs * swtf[f];
  }
  float lnl = -0.5f * chi2;
  const float best = block_max(lnl, red);
  float stepsize = (lnl < best + q.ln_init_thresh) ? 0.0f : 1.0f;
  float lnl_old = lnl;

  for (int it = 0; it < flux_iters; ++it) {
    const float a_num = an + (q.avm - av) * q.avvi;
    const float a_den = ad + q.avvi;
    float dav = stepsize * a_num / a_den;
    const float r_num = rn + (q.rvm - rv) * q.rvvi;
    const float r_den = rdn + q.rvvi;
    float drv = stepsize * r_num / r_den;
    dav = nclip(dav, q.avmin - av, q.avmax - av);
    drv = nclip(drv, q.rvmin - rv, q.rvmax - rv);
    av = av + dav;
    rv = rv + drv;
    scale = mle_scale(F, sflux, swtf, m_int, r0, dr, av, rv, q.scale_min,
                      m, &s_den);
    chi2 = 0.f; an = 0.f; ad = 0.f; rn = 0.f; rdn = 0.f;
    for (int f = 0; f < F; ++f) {
      const float ms = m[f] * scale;
      const float res = sflux[f] - ms;
      const float rvs = kFluxFac * m[f] * (r0[f] + rv * dr[f]) * scale;
      const float drvs = kFluxFac * m[f] * dr[f] * scale;
      chi2 += res * res * swtf[f];
      an += rvs * res * swtf[f];
      ad += rvs * rvs * swtf[f];
      rn += drvs * res * swtf[f];
      rdn += drvs * drvs * swtf[f];
    }
    lnl = -0.5f * chi2;
    stepsize = lnl < lnl_old ? stepsize / q.rescale : stepsize;
    lnl_old = lnl;
  }

  // ---- final MLE expansion with the precision parts ----
  scale = mle_scale(F, sflux, swtf, m_int, r0, dr, av, rv, q.scale_min, m,
                    &s_den);
  float sa = 0.f, sr = 0.f, ar = 0.f, a_den = 0.f, r_den = 0.f;
  chi2 = 0.f;
  for (int f = 0; f < F; ++f) {
    const float w = swtf[f];
    const float rvec_m = r0[f] + rv * dr[f];
    const float ms = m[f] * scale;
    const float res = sflux[f] - ms;
    const float rv_u = kFluxFac * m[f] * rvec_m;
    const float drv_u = kFluxFac * m[f] * dr[f];
    const float red_s = (m[f] - m_int[f]) * scale;
    const float t = ms - res;
    const float rvs = rv_u * scale;
    const float drvs = drv_u * scale;
    sa += rv_u * t * w;
    sr += drv_u * t * w;
    ar += drvs * (red_s - res) * w;
    a_den += rvs * rvs * w;
    r_den += drvs * drvs * w;
    chi2 += res * res * w;
  }
  a_den = a_den + q.avvi + q.a_reg;
  r_den = r_den + q.rvvi + q.r_reg;

  // ---- epilogue (`_post` in-kernel): padding mask, Gaussian constant,
  // chi2 dimensionality prior ----
  const int P = gridDim.x * blockDim.x;
  const int gi = gidx ? gidx[(size_t)b * P + p] : p;
  const float gidx_f = (float)gi;
  const bool bad = n_real_mask >= 0 && gidx_f >= (float)n_real_mask;
  if (bad) chi2 = 1e30f;
  float lnl_out = -0.5f * chi2;
  if (bad) lnl_out = -1e30f;
  const float* sc = srow + (size_t)b * 3;
  lnl_out = lnl_out + sc[0];
  if (dim_prior) {
    const float safe_y = chi2 > 0.f ? chi2 : 1.0f;
    const float ans = sc[1] + sc[2] * logf(safe_y) - safe_y / 2.0f;
    lnl_out = chi2 > 0.f ? ans : -INFINITY;
  }
  float* o = out + (size_t)b * st.out_b + p;
  const size_t R = st.out_row;
  const float vals[11] = {lnl_out, chi2, scale, av, rv, s_den, a_den,
                          r_den, sa, sr, ar};
  for (int r = 0; r < 11; ++r) o[(size_t)r * R] = vals[r];
  if (!gidx) return;
  for (int i = 0; i < n_aux; ++i)
    o[(size_t)(11 + i) * R] = __ldg(c0 + (3 * F + i) * crow);
  o[(size_t)(11 + n_aux) * R] = gidx_f;
  for (int r = 12 + n_aux; r < n_rows; ++r) o[(size_t)r * R] = 0.f;
}

}  // namespace

// star (B, 4, F) = [flux, wt_flux, mags, wt_mag]; coef (C, B, P) slab
// gather output (3F coefficient rows then n_aux aux rows); gidx (B, P)
// int32; srow (B, 3) = [Gaussian constant, cA, cB]; prm (15,)
// constants; out (B, n_rows, P).  `tile` divides P and is at most 1024;
// n_real_mask < 0 disables the padding mask.
extern "C" int bk_fit(const float* star, const float* coef, const int* gidx,
                      const float* srow, const float* prm, float* out,
                      int B, int F, int P, int n_aux, int n_rows,
                      int n_real_mask, int tile, int mag_iters,
                      int flux_iters, int dim_prior, void* stream) {
  if (F > kMaxF || gidx == nullptr) return (int)cudaErrorInvalidValue;
  dim3 grid(P / tile, B);
  size_t shmem = sizeof(float) * (4 * (size_t)F + tile);
  const Strides st{(size_t)P, (size_t)B * P, (size_t)n_rows * P,
                   (size_t)P};
  fit_kernel<<<grid, tile, shmem, (cudaStream_t)stream>>>(
      star, coef, gidx, srow, prm, out, F, n_aux, n_rows, n_real_mask,
      mag_iters, flux_iters, dim_prior, st);
  return (int)cudaGetLastError();
}

// Dense mode.  star (B, 4, F); coef (3, F, Mp) shared grid (row k*F + f
// holds coefficient k of filter f); srow (B, 3); prm (15,); out
// (11, B, Mp) planes lnlike, chi2, scale, av, rv, i00, i11, i22, i01,
// i02, i12.  `tile` divides Mp and is at most 1024; n_real_mask < 0
// disables the padding mask.
extern "C" int bk_fit_dense(const float* star, const float* coef,
                            const float* srow, const float* prm, float* out,
                            int B, int F, int Mp, int n_real_mask, int tile,
                            int mag_iters, int flux_iters, int dim_prior,
                            void* stream) {
  if (F > kMaxF) return (int)cudaErrorInvalidValue;
  dim3 grid(Mp / tile, B);
  size_t shmem = sizeof(float) * (4 * (size_t)F + tile);
  const Strides st{0, (size_t)Mp, (size_t)Mp, (size_t)B * Mp};
  fit_kernel<<<grid, tile, shmem, (cudaStream_t)stream>>>(
      star, coef, nullptr, srow, prm, out, F, 0, 11, n_real_mask,
      mag_iters, flux_iters, dim_prior, st);
  return (int)cudaGetLastError();
}
