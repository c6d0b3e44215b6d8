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
// Bound on this card: float32 issue.  Per (star, model) 12 FMAs per
// filter and ~70 operations of solve and score; per model 3F loads and
// 6F products; the grid table (3F x Mp floats) is read once per group
// of stars, from L2 after the first.
//
// Design:
// - One model per thread, its coefficients and their star-independent
//   products (r0^2, r0 dr, dr^2, m0^2, m0 r0, m0 dr) held in registers
//   (a template on the filter count; F = 4..16 unrolled, other F read
//   the table per star), reused across a group of kGroup = 64 stars
//   whose w, m w, -2 m w and scalars sit in shared memory and are read
//   as broadcasts.  Per (star, model) that leaves the 12 FMAs per
//   filter of the sums (the products equal the plain version's, since
//   x * (-2 y) == (-2 x) * y and x * -y == -x * y exactly).
// - The plain version's summation order: each of the twelve products
//   is summed in filter order with FMAs in an accumulator of its own,
//   and the solve and score round operation by operation as
//   `screen_score_from_sums` does.  Both are float32, and on poorly
//   fitting blocks (scores of -10^3 to -10^4, av at its clamp) the
//   score's terms of ~10^6-10^7 cancel, so two summation orders differ
//   there by more than max(1, 2e-6 S) (each also differs from float64
//   by that much); summed in the same order they do not differ.
// - Block maxima without a barrier per star: each warp reduces its 32
//   models for 8 stars at a time with a NaN-propagating transposed
//   shuffle max (9 shuffles for 8 stars) and keeps the results in
//   shared memory; after the star group, one barrier, then a second
//   pass writes the group's block maxima.  A block of 256
//   threads covers max(sblock, 256) models, a thread taking
//   sblock / 256 models in turn when sblock is wider, so sblock from
//   32 to 1024 runs with the same block.
// - Why not the tensor cores: the nine sums are (B, F) @ (F, M)
//   products of depth F = 8, which TF32 mma.sync.m16n8k8 could take,
//   but the score cancels sums of size ~SNR^2 mag^2 F down to a chi2 of
//   1-10 (pallas_loglike.py:466-475).  TF32 (10 mantissa bits) is far
//   too coarse for that, and a 3-term TF32 split keeps ~21 bits, about
//   8x the rounding of f32, at the edge of the score's tolerance against
//   the plain version (max(1, 2e-6 S) per star); the f32 FMAs here keep
//   every product exact before its one rounding.
#include "common.cuh"

namespace {

constexpr float kMagCenter = 12.0f;       // SCREEN_MAG_CENTER
constexpr int kChunk = 8;                 // stars per warp reduction
constexpr int kThreads = 256;             // threads per block
constexpr int kScalars = 5;               // 1/a00, C0, q0, plx, plxw
constexpr int kGroup = 64;                // stars per block

// Per-star row in shared memory: w[F], mw[F], -2 mw[F], the scalars;
// padded to whole float4s.
__host__ __device__ constexpr int star_stride(int F) {
  return (3 * F + kScalars + 3) / 4 * 4;
}

struct ScreenPrm {
  float avvi, rvm, avmin, avmax, rvmin, rvmax, avm_avvi;
};

// The nine bilinear sums of one (star, model).  RS, b1r and b2 are
// each the sum of two products over the filters; each product keeps
// its own accumulator (RS + RSw, ...), added once at the end, as the
// plain version's two matrix products are.
struct Sums {
  float A01 = 0.f, A02 = 0.f, Bm0 = 0.f, A11 = 0.f, A12 = 0.f, A22 = 0.f,
        RS = 0.f, b1r = 0.f, b2 = 0.f, RSw = 0.f, b1w = 0.f, b2w = 0.f;
  // One filter: w, m w and -2 m w of the star; the model's centered
  // magnitude m0, r0, dr and their products.  Explicit FMAs, in filter
  // order: the build turns contraction off (-fmad=false).
  __device__ __forceinline__ void add(float wf, float mwf, float n2mwf,
                                      float m0, float r0, float dr,
                                      float rr, float rd, float dd,
                                      float mm, float mr, float md) {
    A01 = fmaf(wf, r0, A01);
    A02 = fmaf(wf, dr, A02);
    Bm0 = fmaf(wf, m0, Bm0);
    A11 = fmaf(wf, rr, A11);
    A12 = fmaf(wf, rd, A12);
    A22 = fmaf(wf, dd, A22);
    RS = fmaf(n2mwf, m0, RS);
    RSw = fmaf(wf, mm, RSw);
    b1r = fmaf(mwf, r0, b1r);
    b1w = fmaf(-wf, mr, b1w);
    b2 = fmaf(mwf, dr, b2);
    b2w = fmaf(-wf, md, b2w);
  }
};

// screen_score_from_sums (pallas_loglike.py:339-420): -chi2/2 plus the
// model's mask; sc = the star's scalars.
__device__ __forceinline__ float score_of(const Sums& u, const float* sc,
                                          const ScreenPrm& q, float mask) {
  const float ra00 = sc[0];
  const float C0 = sc[1], q0 = sc[2], plx = sc[3], plxw = sc[4];
  const float RS = u.RS + u.RSw, b1r = u.b1r + u.b1w, b2 = u.b2 + u.b2w;
  const float b0v = C0 - u.Bm0;
  const float b1 = b1r + q.avm_avvi;
  const float k1 = u.A01 * ra00;
  const float k2 = u.A02 * ra00;
  const float s11 = (u.A11 + q.avvi) - k1 * u.A01;
  const float s12 = u.A12 - k1 * u.A02;
  const float s22 = u.A22 - k2 * u.A02;
  const float c1 = b1 - k1 * b0v;
  const float c2 = b2 - k2 * b0v;
  const float det = s11 * s22 - s12 * s12;
  const float rdet = 1.0f / (fabsf(det) > 1e-30f ? det : 1.0f);
  const float av = nclip((c1 * s22 - s12 * c2) * rdet, q.avmin, q.avmax);
  float avrv = (s11 * c2 - s12 * c1) * rdet;
  const bool av_ok = fabsf(av) > 1e-10f;
  float rv = av_ok ? avrv / av : q.rvm;
  rv = nclip(rv, q.rvmin, q.rvmax);
  avrv = av * rv;
  const float s0 = b0v - av * u.A01 - avrv * u.A02;
  const float uu = s0 * ra00;
  const float rss0 = q0 + RS;
  float chi2 = (rss0 - uu * s0 + av * (av * u.A11 - 2.0f * b1r)
                + avrv * (avrv * u.A22 - 2.0f * b2)
                + 2.0f * (av * avrv) * u.A12);
  const float par = expf((float)(-0.2 * 2.302585092994046) * uu);
  chi2 = chi2 + (par - plx) * (par - plx) * plxw;
  return -0.5f * chi2 + mask;
}

// One model's side of the sums.  NF > 0: its coefficients and their six
// star-independent products in registers, the star's row read as
// float4s; NF == 0: both read per star.
template <int NF>
struct Model {
  float m0[NF], r0[NF], dr[NF], rr[NF], rd[NF], dd[NF], mm[NF], mr[NF],
      md[NF];
  __device__ __forceinline__ Model(const float* tab, int m, int Mp, int) {
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      m0[f] = __ldg(tab + (size_t)f * Mp + m) - kMagCenter;
      r0[f] = __ldg(tab + (size_t)(NF + f) * Mp + m);
      dr[f] = __ldg(tab + (size_t)(2 * NF + f) * Mp + m);
      rr[f] = r0[f] * r0[f];
      rd[f] = r0[f] * dr[f];
      dd[f] = dr[f] * dr[f];
      mm[f] = m0[f] * m0[f];
      mr[f] = m0[f] * r0[f];
      md[f] = m0[f] * dr[f];
    }
  }
  __device__ __forceinline__ Sums sums(const float* row) const {
    constexpr int kStride = star_stride(NF);
    float s[kStride];
    const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int i = 0; i < kStride / 4; ++i) {
      const float4 t = r4[i];
      s[4 * i] = t.x; s[4 * i + 1] = t.y; s[4 * i + 2] = t.z;
      s[4 * i + 3] = t.w;
    }
    Sums u;
#pragma unroll
    for (int f = 0; f < NF; ++f)
      u.add(s[f], s[NF + f], s[2 * NF + f], m0[f], r0[f], dr[f], rr[f],
            rd[f], dd[f], mm[f], mr[f], md[f]);
    return u;
  }
};

template <>
struct Model<0> {
  const float* tab;
  int m, Mp, F;
  __device__ __forceinline__ Model(const float* t, int m_, int Mp_, int F_)
      : tab(t), m(m_), Mp(Mp_), F(F_) {}
  __device__ __forceinline__ Sums sums(const float* row) const {
    Sums u;
    for (int f = 0; f < F; ++f) {
      const float m0 = __ldg(tab + (size_t)f * Mp + m) - kMagCenter;
      const float r0 = __ldg(tab + (size_t)(F + f) * Mp + m);
      const float dr = __ldg(tab + (size_t)(2 * F + f) * Mp + m);
      u.add(row[f], row[F + f], row[2 * F + f], m0, r0, dr, r0 * r0,
            r0 * dr, dr * dr, m0 * m0, m0 * r0, m0 * dr);
    }
    return u;
  }
};

// NaN-propagating max over the warp of each of eight values, by a
// transposed butterfly: each exchange halves the values a lane holds,
// 9 shuffles in all instead of 8 x 5.  Lane L returns the maximum of
// v[(L >> 2) & 7] over the 32 lanes.
__device__ __forceinline__ float warp_max8(float* v, int lane) {
#pragma unroll
  for (int half = 4, bit = 16; half >= 1; half >>= 1, bit >>= 1) {
    const bool hi = lane & bit;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = hi ? v[i] : v[i + half];
      const float keep = hi ? v[i + half] : v[i];
      v[i] = nmax(keep, __shfl_xor_sync(0xffffffffu, send, bit));
    }
  }
  float r = v[0];
  r = nmax(r, __shfl_xor_sync(0xffffffffu, r, 2));
  return nmax(r, __shfl_xor_sync(0xffffffffu, r, 1));
}

// One block: `span` = max(sblock, blockDim) models from blockIdx.x *
// span, for the stars blockIdx.y * kGroup ... + kGroup - 1.
template <int NF>
__global__ void __launch_bounds__(kThreads)
screen_kernel(const float* __restrict__ tab,
              const float* __restrict__ maskrow,
              const float* __restrict__ star,
              const float* __restrict__ srow,
              const float* __restrict__ prm, float* __restrict__ bscore,
              int B, int F_rt, int Mp, int sblock, int span) {
  extern __shared__ float4 sh4[];
  float* sstar = reinterpret_cast<float*>(sh4);
  const Filters<NF> nf(F_rt);
  const int F = nf.n();
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int stride = star_stride(F);
  const int wspan = span / 32;                 // warps of models in span
  float* wmax = sstar + (size_t)kGroup * stride;  // kGroup x wspan
  const int b0 = blockIdx.y * kGroup;
  const int nstar = min(kGroup, B - b0);
  const int m_base = blockIdx.x * span;

  for (int i = tid; i < nstar * F; i += T) {
    const int g = i / F, f = i - g * F;
    const float* st = star + (size_t)(b0 + g) * 2 * F;
    float* row = sstar + (size_t)g * stride;
    row[f] = st[f];
    row[F + f] = st[F + f];
    row[2 * F + f] = -2.0f * st[F + f];
  }
  for (int g = tid; g < nstar; g += T) {
    const float* sr = srow + (size_t)(b0 + g) * 5;
    float* sc = sstar + (size_t)g * stride + 3 * F;
    sc[0] = 1.0f / fmaxf(sr[0], 1e-30f);
    sc[1] = sr[1];
    sc[2] = sr[2];
    sc[3] = sr[3];
    sc[4] = sr[4];
  }
  __syncthreads();

  const ScreenPrm q{prm[0], prm[1], prm[2], prm[3], prm[4], prm[5], prm[6]};
  for (int c0 = 0; c0 < span; c0 += T) {
    // Models past Mp (a last span wider than what is left) compute on
    // the last model; their blocks are not written.
    const int m = min(m_base + c0 + tid, Mp - 1);
    const float mask = maskrow[m];
    float* wm = wmax + c0 / 32 + warp;
    const Model<NF> model(tab, m, Mp, F);
    for (int g0 = 0; g0 < nstar; g0 += kChunk) {
      float v[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        // A ragged last chunk repeats the group's last star.
        const float* row = sstar + (size_t)min(g0 + i, nstar - 1) * stride;
        v[i] = score_of(model.sums(row), row + 3 * F, q, mask);
      }
      const float best = warp_max8(v, lane);
      const int g = g0 + (lane >> 2);
      if ((lane & 3) == 0 && g < nstar) wm[(size_t)g * wspan] = best;
    }
  }
  __syncthreads();

  // Second pass: the maximum of each sblock-wide block over its warps.
  const int nblk = Mp / sblock;
  const int per = span / sblock, wps = sblock / 32;
  for (int i = tid; i < nstar * per; i += T) {
    const int g = i / per, s = i - g * per;
    const int blk = blockIdx.x * per + s;
    if (blk >= nblk) continue;
    const float* w = wmax + (size_t)g * wspan + s * wps;
    float v = w[0];
    for (int k = 1; k < wps; ++k) v = nmax(v, w[k]);
    bscore[(size_t)(b0 + g) * nblk + blk] = v;
  }
}

using ScreenFn = void (*)(const float*, const float*, const float*,
                          const float*, const float*, float*, int, int, int,
                          int, int);

ScreenFn screen_instance(int F) { BK_FILTER_INSTANCE(screen_kernel, F) }

}  // namespace

// tab (C, Mp) coefficient table, rows k*F + f (k = mag, r0, dr);
// maskrow (Mp,); star (B, 2, F) = [w, m*w] with m the centered
// magnitudes (zero where w == 0); srow (B, 5) = [a00, C0, q0, plx,
// plxw]; prm (7,) constants; bscore (B, Mp / sblock).  sblock is a
// power of two in [32, 1024] dividing Mp; each block screens kGroup
// stars.
extern "C" int bk_screen(const float* tab, const float* maskrow,
                         const float* star, const float* srow,
                         const float* prm, float* bscore,
                         int B, int F, int Mp, int sblock, void* stream) {
  if (F < 1 || F > kMaxFilters || sblock < 32 || sblock > 1024
      || (sblock & (sblock - 1)) || Mp % sblock)
    return (int)cudaErrorInvalidValue;
  const int span = sblock > kThreads ? sblock : kThreads;
  const size_t shmem = sizeof(float) * (size_t)kGroup * (star_stride(F)
                                                         + span / 32);
  if (shmem > kMaxShared) return (int)cudaErrorInvalidValue;
  const ScreenFn fn = screen_instance(F);
  const cudaError_t e = bk_allow_shared((const void*)fn, shmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(bk_ceil_div(Mp, span), bk_ceil_div(B, kGroup));
  fn<<<grid, kThreads, shmem, (cudaStream_t)stream>>>(
      tab, maskrow, star, srow, prm, bscore, B, F, Mp, sblock, span);
  return (int)cudaGetLastError();
}

// Registers and local-memory bytes per thread of the instance that
// screens F filters: out[0..1].
extern "C" int bk_screen_attrs(int F, int* out) {
  cudaFuncAttributes at;
  const cudaError_t e =
      cudaFuncGetAttributes(&at, (const void*)screen_instance(F));
  if (e != cudaSuccess) return (int)e;
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  return 0;
}
