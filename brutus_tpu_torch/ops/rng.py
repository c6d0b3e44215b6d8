"""
The counter-based generator of K4's random-number mode, in PyTorch.

The TPU kernel (`brutus_tpu/ops/pallas_mc.py:166-175, 241-257`) seeds
the TPU's hardware generator per (star, model tile) and turns its bits
into normals by Box-Muller.  A GPU has no such generator, so the CUDA
kernel (`csrc/mc.cu`, with `philox4x32_10` in `csrc/common.cuh`) runs
Philox4x32-10 in registers; this module is the same function in plain
PyTorch, on int64 tensors masked to 32 bits.

Each (star b, draw row r, model k) is one Philox call with key
`seeds[b]` and counter `(k, r, 0, 0)`; its four words are u1..u4 of
one Box-Muller step.  So a draw depends on neither the tile size nor on
which tiles the kernel skips.  The draws follow the TPU kernel's
distribution, not its bits.
"""

import math

import torch

MASK32 = 0xFFFFFFFF
# PyTorch's ATen/core/PhiloxRNGEngine.h:233-236
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)


def _mulhilo(a, b):
    """`(hi, lo)` 32-bit halves of the 64-bit product of the 32-bit
    constant `a` and the int64 tensor `b` (< 2**32), without
    overflowing int64."""
    t = a * (b & 0xFFFF)
    u = a * (b >> 16) + (t >> 16)
    return u >> 16, ((u & 0xFFFF) << 16) | (t & 0xFFFF)


def philox4x32_10(ctr, key):
    """Philox4x32-10: `ctr` a tuple of four int64 tensors and `key` a
    tuple of two (each value in [0, 2**32)); returns the four output
    words, broadcast together, as int64 tensors."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & MASK32
            k1 = (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_to_uniform(bits):
    """int64 words in [0, 2**32) -> float32 uniforms in [0, 1): 23
    mantissa bits under exponent 127, minus 1 (`pallas_mc.py:91-98`)."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def normals(seeds, K, n_mc, nmc_pad):
    """The standard normals K4's random-number mode draws:
    `(B, 3, nmc_pad, K)` float32 from `seeds (B, 2)` int32, rows from
    `n_mc` on zero (they are masked out of every sum)."""
    dev = seeds.device
    s = seeds.to(torch.int64) & MASK32
    k0, k1 = s[:, 0, None, None], s[:, 1, None, None]         # (B, 1, 1)
    r = torch.arange(n_mc, dtype=torch.int64, device=dev)[None, :, None]
    k = torch.arange(K, dtype=torch.int64, device=dev)[None, None, :]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    w = philox4x32_10((k, r, zero, zero), (k0, k1))
    u1 = torch.clamp(bits_to_uniform(w[0]), min=1e-7)
    u2 = bits_to_uniform(w[1])
    u3 = torch.clamp(bits_to_uniform(w[2]), min=1e-7)
    u4 = bits_to_uniform(w[3])
    r1 = torch.sqrt(-2.0 * torch.log(u1))
    a1 = (2.0 * math.pi) * u2
    r2 = torch.sqrt(-2.0 * torch.log(u3))
    a2 = (2.0 * math.pi) * u4
    B = seeds.shape[0]
    z = torch.zeros((B, 3, nmc_pad, K), dtype=torch.float32, device=dev)
    z[:, 0, :n_mc] = r1 * torch.cos(a1)
    z[:, 1, :n_mc] = r1 * torch.sin(a1)
    z[:, 2, :n_mc] = r2 * torch.cos(a2)
    return z


__all__ = ["philox4x32_10", "bits_to_uniform", "normals"]
