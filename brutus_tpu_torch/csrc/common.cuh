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

// NaN-propagating max over the whole thread block; `red` holds
// blockDim.x floats of shared memory.  Every thread of the block must
// call it; all of them get the result.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int t = threadIdx.x;
  __syncthreads();
  red[t] = v;
  __syncthreads();
  for (int s = (blockDim.x + 1) / 2, n = blockDim.x; n > 1;
       n = s, s = (s + 1) / 2) {
    if (t < n - s) red[t] = nmax(red[t], red[t + s]);
    __syncthreads();
  }
  return red[0];
}

static inline int bk_ceil_div(long long a, long long b) {
  return (int)((a + b - 1) / b);
}
