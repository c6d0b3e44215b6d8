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
// Bound on this card: float32 issue.  The function needs ~2.3k float
// operations per (star, model) at F=8, and ~1.7k more where the freeze
// lets the model move (chip_smoke.py `fit_ops`, `moving_pairs`), against
// 4 * (3F + n_aux) bytes of input per model and 44 bytes of output per
// (star, model).  The build keeps multiply-add contraction off
// (-fmad=false, see ops/_native.py) so that every operation rounds as
// the plain version's does: each one issues alone, and the kernel
// agrees with `fit_pack_plain` / `fit_dense_plain` bit for bit.
//
// Design:
// - Per-filter state in registers.  The device code is a template on
//   the filter count: instances for F = 4..16 unroll every filter loop,
//   so the per-filter arrays (magnitudes, extinction vectors, residuals,
//   model fluxes) live in registers (128 a thread at F=8, two blocks of
//   256 threads per SM); any other F runs the run-time-F instance
//   (NF = 0), whose arrays sit in local memory.  Both are this kernel,
//   chosen by one switch at launch.
// - Threads decoupled from the freeze window.  A block of at most 256
//   threads serves one `tile`-wide window, each thread fitting
//   tile / blockDim models in turn.  Phase A (seed, magnitude-space
//   solves, first flux-space expansion) keeps each model's av, rv, lnl
//   and four update sums in shared memory; the window maximum is a
//   NaN-propagating warp-shuffle max plus one pass over the warp maxima
//   (one barrier).  So tile = 1024 launches.
// - Phase B sorted by the freeze: the models the freeze lets
//   move first, the frozen ones last, so nearly every warp takes one
//   path.  A polish step whose Av and Rv updates are both exactly zero
//   leaves the expansion, its sums and the step size as they were, so
//   it is not recomputed (bit for bit the same result): a frozen model
//   skips its six re-expansions.  Each model then writes its outputs in
//   place.
// - Dense mode reuses the grid across stars: a block fits kDenseGroup
//   stars against one window, so the grid crosses HBM once per star
//   group instead of once per star.  Where the window fits in shared
//   memory (4F x tile floats beside the state; F = 8 at tile 1024 fits)
//   its 3F rows are copied there with cp.async and exp(-0.4 ln10 mag)
//   is computed there once per model.  Stacked mode has a distinct
//   shortlist per star and keeps one star per block; it reads its
//   coefficients from global memory (a block of one star would only
//   wait for its copy).
// - The reductions keep the plain version's filter-order sums, so the
//   CUDA cores (f32) do the work: the fit is a chain of per-model
//   iterations with data-dependent clamps and no matrix product.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;      // threads per block, at most
// Two blocks of 256 threads per SM: at most 128 registers a thread.
constexpr int kBlocksPerSM = 2;
constexpr int kState = 7;          // av, rv, lnl, an, ad, rn, rdn
constexpr int kDenseGroup = 8;     // stars per block in dense mode
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

// One model's coefficients: row k*F + f at p[(k*F + f) * row], in
// shared memory (staged: rows 3F.. then hold exp(kFluxFac * mag0)) or
// in global memory.
struct Coef {
  const float* p;
  size_t row;
  bool staged;
};

// The star's data: flux, flux weights, magnitudes, magnitude weights.
struct Star {
  const float *flux, *wtf, *mags, *wtm;
};

// Phase A's result for one model, kept until the window maximum is
// known.
struct State {
  float av, rv, lnl, an, ad, rn, rdn;
};

template <int NF>
__device__ __forceinline__ void load_coef(Filters<NF> nf, const Coef& c,
                                          float* mag0, float* r0,
                                          float* dr, float* m_int) {
  const int F = nf.n();
#pragma unroll
  for (int f = 0; f < F; ++f) {
    mag0[f] = c.p[(size_t)f * c.row];
    r0[f] = c.p[(size_t)(F + f) * c.row];
    dr[f] = c.p[(size_t)(2 * F + f) * c.row];
    m_int[f] = c.staged ? c.p[(size_t)(3 * F + f) * c.row]
                        : expf(kFluxFac * mag0[f]);
  }
}

// Flux-space MLE re-expansion (pallas_loglike.py `mle`): fills the
// model fluxes m[f] and returns the clamped flux scale; s_den floored.
template <int NF>
__device__ __forceinline__ float mle_scale(
    Filters<NF> nf, const Star& s, const float* m_int, const float* r0,
    const float* dr, float av, float rv, float scale_min, float* m,
    float* s_den_out) {
  const int F = nf.n();
  float s_num = 0.f, s_den = 0.f;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float rvec_m = r0[f] + rv * dr[f];
    const float mf = m_int[f] * expf(kFluxFac * (av * rvec_m));
    m[f] = mf;
    s_num += mf * s.flux[f] * s.wtf[f];
    s_den += mf * mf * s.wtf[f];
  }
  s_den = nmax(s_den, 1e-30f);
  *s_den_out = s_den;
  return nmax(s_num / s_den, scale_min);
}

// chi2 and the four update sums of the current (av, rv, scale).
template <int NF>
__device__ __forceinline__ void flux_sums(
    Filters<NF> nf, const Star& s, const float* m, const float* r0,
    const float* dr, float rv, float scale, float* chi2, float* an,
    float* ad, float* rn, float* rdn) {
  const int F = nf.n();
  float c = 0.f, a0 = 0.f, a1 = 0.f, r0s = 0.f, r1s = 0.f;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float ms = m[f] * scale;
    const float res = s.flux[f] - ms;
    const float rvs = kFluxFac * m[f] * (r0[f] + rv * dr[f]) * scale;
    const float drvs = kFluxFac * m[f] * dr[f] * scale;
    c += res * res * s.wtf[f];
    a0 += rvs * res * s.wtf[f];
    a1 += rvs * rvs * s.wtf[f];
    r0s += drvs * res * s.wtf[f];
    r1s += drvs * drvs * s.wtf[f];
  }
  *chi2 = c; *an = a0; *ad = a1; *rn = r0s; *rdn = r1s;
}

// Phase A: direct 3x3 seed, the magnitude-space solves and the first
// flux-space expansion.
template <int NF>
__device__ __forceinline__ State phase_a(Filters<NF> nf, const Coef& c,
                                         const Star& s, const Prm& q,
                                         int mag_iters) {
  constexpr int kCap = Filters<NF>::kCap;
  const int F = nf.n();
  float mag0[kCap], r0[kCap], dr[kCap], m_int[kCap];
  float resid[kCap], rvec[kCap], m[kCap];
  load_coef(nf, c, mag0, r0, dr, m_int);

  // ---- seed: direct 3x3 WLS of (mu, Av, Av*Rv) ----
  float a00 = 0.f, a01 = 0.f, a02 = 0.f, a11 = 0.f, a12 = 0.f, a22 = 0.f,
        b0 = 0.f, b1 = 0.f, b2 = 0.f;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float w = s.wtm[f];
    const float rs0 = s.mags[f] - mag0[f];
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

  // ---- alternating clamped (Av, Rv) solves ----
  float s_den_m = 0.f, rp_den = 0.f, srp = 0.f;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    rvec[f] = r0[f] + rv * dr[f];
    resid[f] = s.mags[f] - (mag0[f] + av * rvec[f]);
    s_den_m += s.wtm[f];
    rp_den += dr[f] * dr[f] * s.wtm[f];
    srp += dr[f] * s.wtm[f];
  }
  for (int it = 0; it < mag_iters; ++it) {
    float a_den = 0.f, sa = 0.f, rs = 0.f, ra = 0.f;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float w = s.wtm[f];
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
#pragma unroll
    for (int f = 0; f < F; ++f) resid[f] = resid[f] - dav * rvec[f];

    const float r_den = rp_den * av * av + q.rvvi;
    const float sr = srp * av;
    float rs2 = 0.f, rd = 0.f;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      rs2 += resid[f] * s.wtm[f];
      rd += resid[f] * dr[f] * s.wtm[f];
    }
    const float rr = av * rd + (q.rvm - rv) * q.rvvi;
    float drv = (s_den_m * rr - sr * rs2) / (s_den_m * r_den - sr * sr);
    drv = nclip(drv, q.rvmin - rv, q.rvmax - rv);
    rv = rv + drv;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      resid[f] = resid[f] - (av * drv) * dr[f];
      rvec[f] = rvec[f] + drv * dr[f];
    }
  }

  // ---- first flux-space expansion ----
  float s_den;
  const float scale = mle_scale(nf, s, m_int, r0, dr, av, rv, q.scale_min,
                                m, &s_den);
  State st;
  float chi2;
  flux_sums(nf, s, m, r0, dr, rv, scale, &chi2, &st.an, &st.ad, &st.rn,
            &st.rdn);
  st.av = av;
  st.rv = rv;
  st.lnl = -0.5f * chi2;
  return st;
}

// One model's coefficients for phase B, in registers (NF > 0).
template <int NF>
struct Model {
  static constexpr int kCap = Filters<NF>::kCap;
  float mag0[kCap], r0[kCap], dr[kCap], m_int[kCap];
  __device__ __forceinline__ Model(Filters<NF> nf, const Coef& c) {
    load_coef(nf, c, mag0, r0, dr, m_int);
  }
};

// Phase B, first part: the damped flux-space polish of one model from
// its phase-A state `st` with its freeze-window step size; leaves the
// final (av, rv) in `st`.  An update of exactly zero in both Av and Rv
// leaves the expansion, the sums and the step size as they were, so it
// is not recomputed: the result is the same bit for bit.  A frozen
// model (step size 0) takes that path in every iteration unless a clamp
// moves it.
template <int NF>
__device__ __forceinline__ void polish(Filters<NF> nf, const Model<NF>& k,
                                       const Star& s, const Prm& q,
                                       int flux_iters, State& st,
                                       float stepsize) {
  float m[Filters<NF>::kCap];
  float av = st.av, rv = st.rv, an = st.an, ad = st.ad, rn = st.rn,
        rdn = st.rdn;
  float lnl_old = st.lnl;
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
    if (dav == 0.f && drv == 0.f) continue;
    float s_den, chi2;
    const float scale = mle_scale(nf, s, k.m_int, k.r0, k.dr, av, rv,
                                  q.scale_min, m, &s_den);
    flux_sums(nf, s, m, k.r0, k.dr, rv, scale, &chi2, &an, &ad, &rn, &rdn);
    const float lnl = -0.5f * chi2;
    stepsize = lnl < lnl_old ? stepsize / q.rescale : stepsize;
    lnl_old = lnl;
  }
  st.av = av;
  st.rv = rv;
}

// Phase B, second part: the final MLE expansion at (av, rv) with the
// precision parts.  out: chi2, scale, av, rv, s_den, a_den, r_den, sa,
// sr, ar.
template <int NF>
__device__ __forceinline__ void finish(Filters<NF> nf, const Model<NF>& k,
                                       const Star& s, const Prm& q,
                                       float av, float rv, float* out) {
  const int F = nf.n();
  const float *r0 = k.r0, *dr = k.dr, *m_int = k.m_int;
  float m[Filters<NF>::kCap];
  float s_den;
  const float scale = mle_scale(nf, s, m_int, r0, dr, av, rv, q.scale_min,
                                m, &s_den);
  float sa = 0.f, sr = 0.f, ar = 0.f, a_den = 0.f, r_den = 0.f;
  float chi2 = 0.f;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float w = s.wtf[f];
    const float rvec_m = r0[f] + rv * dr[f];
    const float ms = m[f] * scale;
    const float res = s.flux[f] - ms;
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
  out[0] = chi2; out[1] = scale; out[2] = av; out[3] = rv;
  out[4] = s_den;
  out[5] = a_den + q.avvi + q.a_reg;
  out[6] = r_den + q.rvvi + q.r_reg;
  out[7] = sa; out[8] = sr; out[9] = ar;
}

// Element strides of the coefficient operand (per star, per coefficient
// row) and of the output (per star, per row).
struct Strides {
  size_t coef_b, coef_row, out_b, out_row;
};

struct FitArgs {
  int F, n_aux, n_rows, n_real_mask, mag_iters, flux_iters, dim_prior;
  int B;         // stars
  int P;         // models per star (the gidx row length)
  int tile;      // freeze window = models per block
  int group;     // stars per block: kDenseGroup in dense mode, else 1
  int staged;    // coefficients staged in shared memory (fit_shape)
  Strides st;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// One block: the `tile`-wide window blockIdx.x of the model axis, for
// the stars blockIdx.y * group ... + group - 1.  gidx == nullptr
// selects the dense mode: the grid index is the model column, and only
// the 11 fit rows are written.
template <int NF>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fit_kernel(const float* __restrict__ star, const float* __restrict__ coef,
           const int* __restrict__ gidx, const float* __restrict__ srow,
           const float* __restrict__ prm_in, float* __restrict__ out,
           FitArgs a) {
  extern __shared__ float sh[];
  const Filters<NF> nf(a.F);
  const int F = nf.n();
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const int tile = a.tile;
  const int w0 = blockIdx.x * tile;
  const int b0 = blockIdx.y * a.group;
  const int nstar = min(a.group, a.B - b0);
  float* sstar = sh;                                  // group x 4F
  float* red = sstar + (size_t)a.group * 4 * F;       // 32
  int* count = reinterpret_cast<int*>(red + 32);      // 2 (+ 30 spare)
  float* state = red + 64;                            // kState x tile
  int* order = reinterpret_cast<int*>(state + (size_t)kState * tile);
  float* stage = reinterpret_cast<float*>(order + tile);   // 4F x tile

  for (int i = tid; i < nstar * 4 * F; i += T)
    sstar[i] = star[(size_t)b0 * 4 * F + i];
  if (a.staged) {                    // dense mode: one grid, coef_b == 0
    const float* src = coef + w0;
    for (int i = tid; i < 3 * F * tile; i += T) {
      const int r = i / tile;
      cp_async4(stage + i, src + (size_t)r * a.st.coef_row + (i - r * tile));
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    for (int i = tid; i < F * tile; i += T)
      stage[(size_t)3 * F * tile + i] = expf(kFluxFac * stage[i]);
  }
  __syncthreads();
  const Prm q = load_prm(prm_in);
  const float* cwin = a.staged ? stage : coef + w0;
  const size_t crow = a.staged ? (size_t)tile : a.st.coef_row;

  for (int g = 0; g < nstar; ++g) {
    const int b = b0 + g;
    const float* sg = sstar + (size_t)g * 4 * F;
    const Star s{sg, sg + F, sg + 2 * F, sg + 3 * F};
    const float* cb = a.staged ? cwin : cwin + (size_t)b * a.st.coef_b;
    const auto coef_of = [&](int j) {
      return Coef{cb + j, crow, a.staged != 0};
    };

    // ---- phase A for every model of the window; its maximum ----
    float tmax = -INFINITY;
    for (int j = tid; j < tile; j += T) {
      const State st = phase_a(nf, coef_of(j), s, q, a.mag_iters);
      state[0 * tile + j] = st.av;
      state[1 * tile + j] = st.rv;
      state[2 * tile + j] = st.lnl;
      state[3 * tile + j] = st.an;
      state[4 * tile + j] = st.ad;
      state[5 * tile + j] = st.rn;
      state[6 * tile + j] = st.rdn;
      tmax = nmax(tmax, st.lnl);
    }
    tmax = warp_max(tmax);
    if (lane == 0) red[warp] = tmax;
    if (tid == 0) count[0] = count[1] = 0;
    __syncthreads();
    float best = red[0];
    for (int i = 1; i < nwarps; ++i) best = nmax(best, red[i]);

    // ---- phase B ----
    const float* sc = srow + (size_t)b * 3;
    // The final expansion and the epilogue (`_post` in-kernel): padding
    // mask, Gaussian constant, chi2 dimensionality prior.
    const auto emit = [&](int j, const Model<NF>& k, float av, float rv) {
      float v[10];
      finish(nf, k, s, q, av, rv, v);
      const int p = w0 + j;
      float chi2 = v[0];
      const int gi = gidx ? gidx[(size_t)b * a.P + p] : p;
      // integers compared as integers: past 2**24 a float32 rounds a
      // real model just below n_real up to it
      const bool bad = a.n_real_mask >= 0 && gi >= a.n_real_mask;
      if (bad) chi2 = 1e30f;
      float lnl_out = -0.5f * chi2;
      if (bad) lnl_out = -1e30f;
      lnl_out = lnl_out + sc[0];
      if (a.dim_prior) {
        const float safe_y = chi2 > 0.f ? chi2 : 1.0f;
        const float ans = sc[1] + sc[2] * logf(safe_y) - safe_y / 2.0f;
        lnl_out = chi2 > 0.f ? ans : -INFINITY;
      }
      float* o = out + (size_t)b * a.st.out_b + p;
      const size_t R = a.st.out_row;
      o[0] = lnl_out;
      o[R] = chi2;
#pragma unroll
      for (int r = 1; r < 10; ++r) o[(size_t)(r + 1) * R] = v[r];
      if (!gidx) return;
      const float* caux = coef + (size_t)b * a.st.coef_b + p;
      for (int i = 0; i < a.n_aux; ++i)
        o[(size_t)(11 + i) * R] = caux[(size_t)(3 * F + i) * a.st.coef_row];
      o[(size_t)(11 + a.n_aux) * R] = (float)gi;
      for (int r = 12 + a.n_aux; r < a.n_rows; ++r) o[(size_t)r * R] = 0.f;
    };
    const auto load_state = [&](int j) {
      return State{state[0 * tile + j], state[1 * tile + j],
                   state[2 * tile + j], state[3 * tile + j],
                   state[4 * tile + j], state[5 * tile + j],
                   state[6 * tile + j]};
    };
    // Sorted by the freeze: models that move first, frozen ones last,
    // so nearly every warp's models take the same path through the
    // polish.  Each model then writes its outputs where they belong.
    for (int j = tid; j < tile; j += T) {
      const bool moves = !(state[2 * tile + j] < best + q.ln_init_thresh);
      const int k = atomicAdd(&count[moves ? 0 : 1], 1);
      order[moves ? k : tile - 1 - k] = j;
    }
    __syncthreads();
    for (int i = tid; i < tile; i += T) {
      const int j = order[i];
      State st = load_state(j);
      const Model<NF> k(nf, coef_of(j));
      polish(nf, k, s, q, a.flux_iters, st,
             (st.lnl < best + q.ln_init_thresh) ? 0.0f : 1.0f);
      emit(j, k, st.av, st.rv);
    }
    // The next star's phase A rewrites `state`, `red` and `count`.
    __syncthreads();
  }
}

using FitFn = void (*)(const float*, const float*, const int*, const float*,
                       const float*, float*, FitArgs);

FitFn fit_instance(int F) { BK_FILTER_INSTANCE(fit_kernel, F) }

// Threads per block, shared memory and staging of a window of `tile`
// models for `group` stars (staged in dense mode, group > 1, where the
// stage fits); false if no launch fits.
bool fit_shape(int F, int tile, int group, int* threads, size_t* shmem,
               int* staged) {
  if (F < 1 || F > kMaxFilters || tile < 1 || tile > 1024 || group < 1)
    return false;
  const int warps32 = (tile + 31) / 32 * 32;
  *threads = warps32 < kThreads ? warps32 : kThreads;
  const size_t base = sizeof(float) * ((size_t)group * 4 * F + 64
                                       + (size_t)(kState + 1) * tile);
  const size_t bytes = sizeof(float) * 4 * (size_t)F * tile;
  *staged = group > 1 && base + bytes <= kMaxShared;
  *shmem = base + (*staged ? bytes : 0);
  return *shmem <= kMaxShared;
}

int launch_fit(const float* star, const float* coef, const int* gidx,
               const float* srow, const float* prm, float* out, FitArgs a,
               int n_windows, void* stream) {
  int threads;
  size_t shmem;
  if (!fit_shape(a.F, a.tile, a.group, &threads, &shmem, &a.staged))
    return (int)cudaErrorInvalidValue;
  const FitFn fn = fit_instance(a.F);
  const cudaError_t e = bk_allow_shared((const void*)fn, shmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_windows, bk_ceil_div(a.B, a.group));
  fn<<<grid, threads, shmem, (cudaStream_t)stream>>>(star, coef, gidx, srow,
                                                     prm, out, a);
  return (int)cudaGetLastError();
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
  if (gidx == nullptr || tile < 1 || P % tile)
    return (int)cudaErrorInvalidValue;
  const FitArgs a{F, n_aux, n_rows, n_real_mask, mag_iters, flux_iters,
                  dim_prior, B, P, tile, 1, 0,
                  Strides{(size_t)P, (size_t)B * P, (size_t)n_rows * P,
                          (size_t)P}};
  return launch_fit(star, coef, gidx, srow, prm, out, a, P / tile, stream);
}

// Dense mode.  star (B, 4, F); coef (3, F, Mp) shared grid (row k*F + f
// holds coefficient k of filter f); srow (B, 3); prm (15,); out
// (11, B, Mp) planes lnlike, chi2, scale, av, rv, i00, i11, i22, i01,
// i02, i12.  `tile` divides Mp and is at most 1024; each block fits
// kDenseGroup stars against one window; n_real_mask < 0 disables the
// padding mask.
extern "C" int bk_fit_dense(const float* star, const float* coef,
                            const float* srow, const float* prm, float* out,
                            int B, int F, int Mp, int n_real_mask, int tile,
                            int mag_iters, int flux_iters, int dim_prior,
                            void* stream) {
  if (tile < 1 || Mp % tile) return (int)cudaErrorInvalidValue;
  const FitArgs a{F, 0, 11, n_real_mask, mag_iters, flux_iters, dim_prior,
                  B, Mp, tile, kDenseGroup, 0,
                  Strides{0, (size_t)Mp, (size_t)Mp, (size_t)B * Mp}};
  return launch_fit(star, coef, nullptr, srow, prm, out, a, Mp / tile,
                    stream);
}

// Registers and local-memory bytes per thread, whether the window's
// coefficients are staged, and the shared memory per block, of the
// instance that runs F filters at `tile` in dense mode (`dense` != 0)
// or stacked mode: out[0..3].
extern "C" int bk_fit_attrs(int F, int tile, int dense, int* out) {
  int threads, staged;
  size_t shmem;
  if (!fit_shape(F, tile, dense ? kDenseGroup : 1, &threads, &shmem,
                 &staged))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes at;
  const cudaError_t e =
      cudaFuncGetAttributes(&at, (const void*)fit_instance(F));
  if (e != cudaSuccess) return (int)e;
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  out[2] = staged;
  out[3] = (int)shmem;
  return 0;
}
