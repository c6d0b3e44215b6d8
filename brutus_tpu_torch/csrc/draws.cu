// The posterior's random draws of a batch in one launch.
//
// Replaces no TPU kernel: the JAX package draws with `jax.random` in
// XLA (brutus_tpu/fitting.py:994, 1017).  The port's plain version is
// `ops/rng.py` (`star_keys` then `posterior_draws`), Philox4x32-10 on
// int64 tensors masked to 32 bits: some 300 elementwise launches an
// evaluation, two evaluations a batch, which left the card idle behind
// the host.  This kernel writes the same bits, at the counters of
// rng.py's table, in one launch:
//
//   seeds  (B, 2) int32           the star keys, STREAM_KEY of (seed, row)
//   u      (B, n_draws)           uniforms, STREAM_U
//   gumbel (B, n_draws, n_mc)     -log(-log(max(u, 1e-7))), STREAM_GUMBEL
//   z, by mode: none (K4 makes its own normals from the seeds);
//       kMc   (B, 3, nmc_pad, K)  K4's fed normals, STREAM_MC, rows from
//                                 n_mc on zero;
//       kGrid (B, K, 3, n_mc)     lnpost_grid's normals, STREAM_GRID_Z.
//
// Bound on this card: its stores, ~1.28 MB a star with the dense
// engine's (2048, 3, 50) normals, ~51 KB a star without normals (the
// funnel's 250 draws x 50 MC rows); there the ten Philox rounds of each
// of those 12,750 values, whose 32-bit integer multiplies run at half the
// float32 rate, take longer than the stores (chip_smoke.py
// `draws_bound`).
//
// Design: a star's outputs are one run of items (u, then gumbel, then
// z), cut into chunks of kThreads * kItems; one block takes one chunk
// of one star, so a star spreads over many blocks and the grid fills the
// card at any batch.  The block's first thread makes the star's key once
// and shares it through shared memory.  Item i of a chunk goes to thread
// i % kThreads, so neighbouring threads store to neighbouring addresses
// of each output (one Philox call makes the three planes of a normal
// item, each stored coalesced).  The uniforms and normals use the same
// libm functions as the plain version (common.cuh), built without
// multiply-add contraction, so the bits are the plain version's.
#include "common.cuh"

namespace {

enum { kNone = 0, kMc = 1, kGrid = 2 };
enum { kStreamMc = 0, kStreamU, kStreamGumbel, kStreamGridZ, kStreamKey };

constexpr int kThreads = 256;
constexpr int kItems = 4;                 // items per thread
constexpr int kChunk = kThreads * kItems;

struct DrawsArgs {
  const long long* rows;
  int* seeds;
  float* u;
  float* gumbel;
  float* z;
  unsigned int seed_lo, seed_hi;
  int n_draws, n_mc, K, nmc_pad;
  int n_items;                            // items per star
  int chunks;                             // blocks per star
};

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    mc_kernel_draws(const DrawsArgs a) {
  __shared__ uint2 key_sh;
  const int b = blockIdx.x / a.chunks;
  const int base = (blockIdx.x % a.chunks) * kChunk;
  if (threadIdx.x == 0) {
    const unsigned long long row = (unsigned long long)a.rows[b];
    const uint4 w = philox4x32_10(
        make_uint4((uint32_t)row, (uint32_t)(row >> 32), 0u, kStreamKey),
        make_uint2(a.seed_lo, a.seed_hi));
    key_sh = make_uint2(w.x, w.y);
    if (base == 0) {
      a.seeds[2 * b] = (int)w.x;
      a.seeds[2 * b + 1] = (int)w.y;
    }
  }
  __syncthreads();
  const uint2 key = key_sh;
  // Indices inside a star fit 32 bits (the entry point checks n_items).
  const int n_u = a.n_draws;
  const int n_g = n_u * a.n_mc;
  for (int j = 0; j < kItems; ++j) {
    const int i = base + j * kThreads + threadIdx.x;
    if (i >= a.n_items) break;
    if (i < n_u) {
      const uint4 w = philox4x32_10(
          make_uint4((uint32_t)i, 0u, 0u, kStreamU), key);
      a.u[(long long)b * n_u + i] = bits_to_uniform(w.x);
    } else if (i < n_u + n_g) {
      const int g = i - n_u;              // d * n_mc + m
      const int d = g / a.n_mc;
      const int m = g - d * a.n_mc;
      const uint4 w = philox4x32_10(
          make_uint4((uint32_t)m, (uint32_t)d, 0u, kStreamGumbel), key);
      const float x = fmaxf(bits_to_uniform(w.x), 1e-7f);
      a.gumbel[(long long)b * n_g + g] = -logf(-logf(x));
    } else if (kMode == kMc) {
      const int q = i - n_u - n_g;        // r * K + k
      const int r = q / a.K;
      const int k = q - r * a.K;
      float z0 = 0.0f, z1 = 0.0f, z2 = 0.0f;
      if (r < a.n_mc)
        philox_normals3(make_uint4((uint32_t)k, (uint32_t)r, 0u, kStreamMc),
                        key, &z0, &z1, &z2);
      const long long plane = (long long)a.nmc_pad * a.K;
      float* out = a.z + (long long)b * 3 * plane + q;
      out[0] = z0;
      out[plane] = z1;
      out[2 * plane] = z2;
    } else if (kMode == kGrid) {
      const int q = i - n_u - n_g;        // k * n_mc + m
      const int k = q / a.n_mc;
      const int m = q - k * a.n_mc;
      float z0, z1, z2;
      philox_normals3(make_uint4((uint32_t)k, (uint32_t)m, 0u, kStreamGridZ),
                      key, &z0, &z1, &z2);
      float* out = a.z + ((long long)b * a.K + k) * 3 * a.n_mc + m;
      out[0] = z0;
      out[a.n_mc] = z1;
      out[2 * a.n_mc] = z2;
    }
  }
}

using DrawsFn = void (*)(DrawsArgs);

DrawsFn draws_instance(int mode) {
  return mode == kMc ? mc_kernel_draws<kMc>
         : mode == kGrid ? mc_kernel_draws<kGrid>
                         : mc_kernel_draws<kNone>;
}

}  // namespace

// rows (B,) int64 global star rows; the fit's 64-bit seed as two 32-bit
// words; outputs seeds (B, 2) int32, u (B, n_draws), gumbel (B, n_draws,
// n_mc) and, by `mode` (0 none, 1 K4's layout, 2 lnpost_grid's), z
// (B, 3, nmc_pad, K) or (B, K, 3, n_mc), null for mode 0.
extern "C" int bk_draws(const long long* rows, int* seeds, float* u,
                        float* gumbel, float* z, unsigned int seed_lo,
                        unsigned int seed_hi, int B, int n_draws, int n_mc,
                        int K, int nmc_pad, int mode, void* stream) {
  if (mode < kNone || mode > kGrid || (mode == kNone) != (z == nullptr)
      || B < 0 || n_draws < 0 || n_mc < 0 || K < 0
      || (mode == kMc && nmc_pad < n_mc))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  long long n_z = 0;
  if (mode == kMc) n_z = (long long)nmc_pad * K;
  if (mode == kGrid) n_z = (long long)K * n_mc;
  const long long n_items = (long long)n_draws * (1 + n_mc) + n_z;
  // A star with nothing to draw still gets its key: one block.
  const long long chunks = n_items > 0 ? (n_items + kChunk - 1) / kChunk : 1;
  if (chunks * kChunk > 0x7FFFFFFFLL || chunks * B > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const DrawsArgs a{rows, seeds, u, gumbel, z, seed_lo, seed_hi, n_draws,
                    n_mc, K, nmc_pad, (int)n_items, (int)chunks};
  draws_instance(mode)<<<(unsigned)(chunks * B), kThreads, 0,
                         (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Registers and local bytes per thread of the instance for `mode`.
extern "C" int bk_draws_attrs(int mode, int* out) {
  cudaFuncAttributes at;
  const cudaError_t e = cudaFuncGetAttributes(
      &at, (const void*)draws_instance(mode));
  if (e != cudaSuccess) return (int)e;
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  return 0;
}
