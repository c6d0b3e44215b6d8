// K2: funnel screening kernel.
//
// Replaces brutus_tpu/ops/pallas_loglike.py:452 _make_screen_kernel
// (launched from _make_screen_call:564, pallas_call at :592).
//
// For every (star, model): the nine weighted bilinear sums over the F
// filters, the clamped direct 3x3 WLS solve of (mu offset, Av, Av*Rv)
// through the Schur complement of a00 = sum w, the explicit-residual
// chi2 plus the parallax chi2 at the implied flux scale
// (screen_score_from_sums, pallas_loglike.py:339-420), plus the mask row
// (-1e30 on tile padding).  Only the maximum over each `sblock`-wide
// block of models is written: (B, Mp / sblock).
//
// Bound on this card: arithmetic.  Per (star, model) ~9 FMAs per filter
// plus ~70 operations of score; the grid table (3F x Mp floats) is read
// once per group of G stars and stays in L2 across groups.  The TPU
// needed an exact 3-way bf16 split to get true-f32 products out of its
// matrix unit; here every product is a plain f32 FMA, so no split.
//
// Design: one thread per model, one CUDA block per `sblock`-wide model
// block (blockDim == sblock) and group of G stars held in shared
// memory; the block maximum is a shared-memory tree reduction.
#include "common.cuh"

namespace {

constexpr float kMagCenter = 12.0f;       // SCREEN_MAG_CENTER
constexpr int kG = 16;                    // stars per CUDA block

// prm: avvi, rvm, avmin, avmax, rvmin, rvmax, avm*avvi
__global__ void screen_kernel(const float* __restrict__ tab,
                              const float* __restrict__ maskrow,
                              const float* __restrict__ star,
                              const float* __restrict__ srow,
                              const float* __restrict__ prm,
                              float* __restrict__ bscore,
                              int B, int F, int Mp) {
  extern __shared__ float sh[];
  float* sstar = sh;                      // kG * 2F: w | m*w
  float* red = sh + kG * 2 * F;           // blockDim.x
  const int nblk = Mp / blockDim.x;
  const int blk = blockIdx.x;
  const int m = blk * blockDim.x + threadIdx.x;
  const int b0 = blockIdx.y * kG;
  const int nstar = min(kG, B - b0);
  for (int i = threadIdx.x; i < nstar * 2 * F; i += blockDim.x)
    sstar[i] = star[(size_t)b0 * 2 * F + i];
  __syncthreads();

  const float avvi = prm[0], rvm = prm[1];
  const float avmin = prm[2], avmax = prm[3];
  const float rvmin = prm[4], rvmax = prm[5], avm_avvi = prm[6];
  const float mask = maskrow[m];

  for (int g = 0; g < nstar; ++g) {
    const float* w = sstar + g * 2 * F;
    const float* mw = w + F;
    float A01 = 0.f, A02 = 0.f, Bm0 = 0.f, A11 = 0.f, A12 = 0.f,
          A22 = 0.f, RS = 0.f, b1r = 0.f, b2 = 0.f;
    for (int f = 0; f < F; ++f) {
      const float m0 = __ldg(tab + (size_t)f * Mp + m) - kMagCenter;
      const float r0 = __ldg(tab + (size_t)(F + f) * Mp + m);
      const float dr = __ldg(tab + (size_t)(2 * F + f) * Mp + m);
      const float wf = w[f], mwf = mw[f];
      // Explicit FMAs: the build turns contraction off (-fmad=false).
      A01 = fmaf(wf, r0, A01);
      A02 = fmaf(wf, dr, A02);
      Bm0 = fmaf(wf, m0, Bm0);
      A11 = fmaf(wf, r0 * r0, A11);
      A12 = fmaf(wf, r0 * dr, A12);
      A22 = fmaf(wf, dr * dr, A22);
      RS = fmaf(mwf, -2.0f * m0, fmaf(wf, m0 * m0, RS));
      b1r = fmaf(mwf, r0, fmaf(wf, -(m0 * r0), b1r));
      b2 = fmaf(mwf, dr, fmaf(wf, -(m0 * dr), b2));
    }
    const float* sr = srow + (size_t)(b0 + g) * 5;
    const float a00 = fmaxf(sr[0], 1e-30f);
    const float C0 = sr[1], q0 = sr[2], plx = sr[3], plxw = sr[4];

    // screen_score_from_sums (pallas_loglike.py:339-420).
    const float b0v = C0 - Bm0;
    const float b1 = b1r + avm_avvi;
    const float ra00 = 1.0f / a00;
    const float k1 = A01 * ra00;
    const float k2 = A02 * ra00;
    const float s11 = (A11 + avvi) - k1 * A01;
    const float s12 = A12 - k1 * A02;
    const float s22 = A22 - k2 * A02;
    const float c1 = b1 - k1 * b0v;
    const float c2 = b2 - k2 * b0v;
    const float det = s11 * s22 - s12 * s12;
    const float rdet = 1.0f / (fabsf(det) > 1e-30f ? det : 1.0f);
    const float av = nclip((c1 * s22 - s12 * c2) * rdet, avmin, avmax);
    float avrv = (s11 * c2 - s12 * c1) * rdet;
    const bool av_ok = fabsf(av) > 1e-10f;
    float rv = av_ok ? avrv / av : rvm;
    rv = nclip(rv, rvmin, rvmax);
    avrv = av * rv;
    const float s0 = b0v - av * A01 - avrv * A02;
    const float u = s0 * ra00;
    const float rss0 = q0 + RS;
    float chi2 = (rss0 - u * s0 + av * (av * A11 - 2.0f * b1r)
                  + avrv * (avrv * A22 - 2.0f * b2)
                  + 2.0f * (av * avrv) * A12);
    const float par = expf((float)(-0.2 * 2.302585092994046) * u);
    chi2 = chi2 + (par - plx) * (par - plx) * plxw;
    const float score = -0.5f * chi2 + mask;
    const float best = block_max(score, red);
    if (threadIdx.x == 0) bscore[(size_t)(b0 + g) * nblk + blk] = best;
  }
}

}  // namespace

// tab (C, Mp) coefficient table, rows k*F + f (k = mag, r0, dr);
// maskrow (Mp,); star (B, 2, F) = [w, m*w] with m the centered
// magnitudes (zero where w == 0); srow (B, 5) = [a00, C0, q0, plx,
// plxw]; prm (7,) constants; bscore (B, Mp / sblock).  sblock is a
// power of two in [32, 1024] dividing Mp.
extern "C" int bk_screen(const float* tab, const float* maskrow,
                         const float* star, const float* srow,
                         const float* prm, float* bscore,
                         int B, int F, int Mp, int sblock,
                         void* stream) {
  dim3 grid(Mp / sblock, bk_ceil_div(B, kG));
  size_t shmem = sizeof(float) * ((size_t)kG * 2 * F + sblock);
  screen_kernel<<<grid, sblock, shmem, (cudaStream_t)stream>>>(
      tab, maskrow, star, srow, prm, bscore, B, F, Mp);
  return (int)cudaGetLastError();
}
