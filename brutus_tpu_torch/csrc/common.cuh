// Shared device helpers of the port's CUDA kernels.
//
// The kernels mirror JAX's elementwise semantics where a NaN must not be
// swallowed: jnp.maximum / jnp.minimum / jnp.clip / jnp.max propagate
// NaN, while fmaxf / fminf return the other operand.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BK_NEG_BIG (-1e30f)

__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// jnp.clip(x, lo, hi) == minimum(maximum(x, lo), hi).
__device__ __forceinline__ float nclip(float x, float lo, float hi) {
  return nmin(nmax(x, lo), hi);
}

// NaN-propagating max over the 32 lanes of a warp; every lane of the
// warp must call it; all of them get the result.
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Filters a kernel instance handles: a count fixed at compile time
// (NF > 0: loops over the filters unroll and per-filter arrays stay in
// registers) or read at run time (NF == 0: arrays of kMaxFilters, in
// local memory).
constexpr int kMaxFilters = 64;

template <int NF>
struct Filters {
  static constexpr int kCap = NF;
  __device__ __forceinline__ explicit Filters(int) {}
  __device__ __forceinline__ int n() const { return NF; }
};

template <>
struct Filters<0> {
  static constexpr int kCap = kMaxFilters;
  int F;
  __device__ __forceinline__ explicit Filters(int f) : F(f) {}
  __device__ __forceinline__ int n() const { return F; }
};

// Instances of a kernel template for F = 4..16 filters (a star needs
// four bands), and the run-time instance for any other F: one switch.
#define BK_FILTER_INSTANCE(KERNEL, F)                       \
  switch (F) {                                              \
    case 4: return KERNEL<4>;                               \
    case 5: return KERNEL<5>;                               \
    case 6: return KERNEL<6>;                               \
    case 7: return KERNEL<7>;                               \
    case 8: return KERNEL<8>;                               \
    case 9: return KERNEL<9>;                               \
    case 10: return KERNEL<10>;                             \
    case 11: return KERNEL<11>;                             \
    case 12: return KERNEL<12>;                             \
    case 13: return KERNEL<13>;                             \
    case 14: return KERNEL<14>;                             \
    case 15: return KERNEL<15>;                             \
    case 16: return KERNEL<16>;                             \
    default: return KERNEL<0>;                              \
  }

// A block may use 227 KB of shared memory, above 48 KB only as dynamic
// shared memory after this attribute is set for the kernel.
constexpr size_t kMaxShared = 232448;

static inline cudaError_t bk_allow_shared(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

static inline int bk_ceil_div(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

// Philox4x32-10 (Salmon et al., SC'11), with the constants and round
// order of PyTorch's ATen/core/PhiloxRNGEngine.h: one 128-bit counter
// and a 64-bit key give four 32-bit words.  ops/rng.py holds the same
// function in PyTorch.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// 23 random mantissa bits under exponent 127 -> [1, 2), minus 1: a
// uniform in [0, 1) (brutus_tpu/ops/pallas_mc.py:91-98).
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// Three standard normals from one Philox call by Box-Muller, as the TPU
// kernel makes them (pallas_mc.py:241-257): u1 and u3 floored at 1e-7,
// z0 = r1 cos a1, z1 = r1 sin a1, z2 = r2 cos a2.
__device__ __forceinline__ void philox_normals3(uint4 ctr, uint2 key,
                                                float* z0, float* z1,
                                                float* z2) {
  const uint4 w = philox4x32_10(ctr, key);
  const float two_pi = 6.283185307179586f;
  const float u1 = fmaxf(bits_to_uniform(w.x), 1e-7f);
  const float u2 = bits_to_uniform(w.y);
  const float u3 = fmaxf(bits_to_uniform(w.z), 1e-7f);
  const float u4 = bits_to_uniform(w.w);
  const float r1 = sqrtf(-2.0f * logf(u1));
  const float a1 = two_pi * u2;
  const float r2 = sqrtf(-2.0f * logf(u3));
  const float a2 = two_pi * u4;
  *z0 = r1 * cosf(a1);
  *z1 = r1 * sinf(a1);
  *z2 = r2 * cosf(a2);
}
