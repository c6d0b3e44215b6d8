// K3: funnel slab gather.
//
// Replaces brutus_tpu/ops/pallas_loglike.py:1049 _make_gather_call
// (pallas_call at :1139): out[:, b, j*block : (j+1)*block] =
// table[:, bidx[b, j]*block : +block] for every selected block j of
// every star b, over all C rows (3F coefficient rows, then aux rows).
//
// Bound on this card: bytes.  Each output float is read once and
// written once (2 * 4 * C * B * P bytes); no arithmetic.  The TPU
// issued a ring of HBM->HBM DMAs per star; here one thread copies one
// float, neighbouring threads copy neighbouring floats of a slab, so
// reads and writes are coalesced 128-byte transactions.
#include "common.cuh"

namespace {

// grid.x enumerates the C * B (row, star) pairs; grid.y covers the P
// shortlist slots of one pair, blockDim.x slots per block.
__global__ void gather_kernel(const float* __restrict__ table,
                              const int* __restrict__ bidx,
                              float* __restrict__ out, int Mp, int B,
                              int nb, int block) {
  const int P = nb * block;
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int b = blockIdx.x % B;
  const int c = blockIdx.x / B;
  const int j = p / block;
  const long long src = (long long)bidx[b * nb + j] * block + (p - j * block);
  out[(size_t)blockIdx.x * P + p] = __ldg(table + (size_t)c * Mp + src);
}

}  // namespace

// table (C, Mp); bidx (B, nb) int32 block ids; out (C, B, nb * block).
extern "C" int bk_gather(const float* table, const int* bidx, float* out,
                         int C, int Mp, int B, int nb, int block,
                         void* stream) {
  const int P = nb * block;
  if (P == 0 || C == 0 || B == 0) return 0;
  const int threads = 256;
  if ((P + threads - 1) / threads > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(C * B, (P + threads - 1) / threads);
  gather_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      table, bidx, out, Mp, B, nb, block);
  return (int)cudaGetLastError();
}
