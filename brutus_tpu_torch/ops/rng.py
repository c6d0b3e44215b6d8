"""
Counter-based random numbers of the posterior: one Philox stream per
star, keyed by the fit's seed and the star's global row.

The JAX package keys each star by `fold_in(PRNGKey(seed), row)`
(`brutus_tpu/fitting.py:994, 1017`), so a row's draws depend on
`(seed, row)` alone, whatever the batch it sits in.  The port keeps
that property with Philox4x32-10 (the generator K4's random-number
mode runs in registers, `philox4x32_10` in `csrc/common.cuh`), here in
plain PyTorch on int64 tensors masked to 32 bits.  On the card, `draws`
makes a batch's keys and draws in one launch of `csrc/draws.cu`, whose
bits are those of `star_keys` and `posterior_draws`, its plain version.

Counter layout.  A Philox call maps a 128-bit counter `(c0, c1, c2, c3)`
and a 64-bit key to four 32-bit words.  Word `c3` names the stream, so
no two kinds of draw ever share a counter; `c0` and `c1` index the draw
inside its stream; `c2` is 0.

| stream | key | counter | words used | draws |
| --- | --- | --- | --- | --- |
| `STREAM_KEY` 4 | `(seed lo, seed hi)` | `(row lo, row hi, 0, 4)` | 0, 1 | the star's key (the `seeds` of K4) |
| `STREAM_MC` 0 | star key | `(k, r, 0, 0)` | 0-3 | K4's normals of model `k`, MC row `r` (in-kernel and fed) |
| `STREAM_U` 1 | star key | `(d, 0, 0, 1)` | 0 | uniform of model draw `d` |
| `STREAM_GUMBEL` 2 | star key | `(m, d, 0, 2)` | 0 | Gumbel noise of draw `d`, MC row `m` |
| `STREAM_GRID_Z` 3 | star key | `(k, m, 0, 3)` | 0-3 | `lnpost_grid`'s normals of model `k`, MC row `m` |

`k` is the position of a model in the star's selection, `r` and `m` the
MC row, `d` the posterior draw: none depends on the batch size, the
grid's padding, or the tiling of the model axis.  Four words make three
normals by Box-Muller as the TPU kernel makes them
(`brutus_tpu/ops/pallas_mc.py:241-257`).  The draws follow the JAX
package's distributions, not its (threefry) bits.
"""

import math

import torch

from ._native import KERNELS

MASK32 = 0xFFFFFFFF
# PyTorch's ATen/core/PhiloxRNGEngine.h:233-236
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)

STREAM_MC, STREAM_U, STREAM_GUMBEL, STREAM_GRID_Z, STREAM_KEY = range(5)
# Floor of the uniforms under a logarithm (as K4's Box-Muller floors).
U_MIN = 1e-7


def _mulhilo(a, b):
    """`(hi, lo)` 32-bit halves of the 64-bit product of the 32-bit
    constant `a` and the int64 tensor `b` (< 2**32), without
    overflowing int64."""
    t = a * (b & 0xFFFF)
    u = a * (b >> 16) + (t >> 16)
    return u >> 16, ((u & 0xFFFF) << 16) | (t & 0xFFFF)


def philox4x32_10(ctr, key):
    """Philox4x32-10: `ctr` a tuple of four int64 tensors and `key` a
    tuple of two (int64 tensors or ints, each value in [0, 2**32));
    returns the four output words, broadcast together, as int64
    tensors."""
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


def _to_int32(w):
    """int64 words in [0, 2**32) -> int32 of the same bits."""
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def star_keys(seed, rows):
    """`(B, 2)` int32 Philox keys of the stars at global `rows` (B,) of a
    fit seeded with `seed` (the port's `fold_in(PRNGKey(seed), row)`)."""
    seed = int(seed) & ((1 << 64) - 1)
    rows = torch.as_tensor(rows).to(torch.int64)
    zero = torch.zeros_like(rows)
    w = philox4x32_10((rows & MASK32, (rows >> 32) & MASK32, zero,
                       zero + STREAM_KEY), (seed & MASK32, seed >> 32))
    return _to_int32(torch.stack([w[0], w[1]], dim=1))


def words(keys, parts):
    """Philox words of each star's key for several streams in one
    evaluation (one set of elementwise launches): `keys` (B, 2) int32;
    `parts` a list of `(c0, c1, stream)`, c0 and c1 int64 index tensors
    broadcasting to the part's shape.  Returns, per part, its four words
    as int64 tensors of shape (B, *shape)."""
    grids = [torch.broadcast_tensors(c0, c1) for c0, c1, _ in parts]
    c0 = torch.cat([g[0].reshape(-1) for g in grids])
    c1 = torch.cat([g[1].reshape(-1) for g in grids])
    c3 = torch.cat([torch.full((g[0].numel(),), stream, dtype=torch.int64,
                               device=keys.device)
                    for g, (_, _, stream) in zip(grids, parts)])
    s = keys.to(torch.int64) & MASK32
    zero = torch.zeros((), dtype=torch.int64, device=keys.device)
    w = philox4x32_10((c0[None], c1[None], zero, c3[None]),
                      (s[:, :1], s[:, 1:]))
    B, out, at = keys.shape[0], [], 0
    for g in grids:
        n = g[0].numel()
        out.append(tuple(x[:, at:at + n].reshape(B, *g[0].shape)
                         for x in w))
        at += n
    return out


def _box_muller(w):
    """Three standard normals from four Philox words (`pallas_mc.py:
    241-257`): u1 and u3 floored at 1e-7."""
    u1 = torch.clamp(bits_to_uniform(w[0]), min=U_MIN)
    u2 = bits_to_uniform(w[1])
    u3 = torch.clamp(bits_to_uniform(w[2]), min=U_MIN)
    u4 = bits_to_uniform(w[3])
    r1 = torch.sqrt(-2.0 * torch.log(u1))
    a1 = (2.0 * math.pi) * u2
    r2 = torch.sqrt(-2.0 * torch.log(u3))
    a2 = (2.0 * math.pi) * u4
    return r1 * torch.cos(a1), r1 * torch.sin(a1), r2 * torch.cos(a2)


def _arange(n, dev):
    return torch.arange(n, dtype=torch.int64, device=dev)


def _mc_part(K, n_mc, dev):
    """K4's normals: model k along the last axis, MC row r before it."""
    return (_arange(K, dev)[None, :], _arange(n_mc, dev)[:, None], STREAM_MC)


def _mc_normals(w, n_mc, nmc_pad):
    """`(B, 3, nmc_pad, K)` from the words of `_mc_part`, rows from n_mc
    on zero."""
    B, _, K = w[0].shape
    z = torch.zeros((B, 3, nmc_pad, K), dtype=torch.float32,
                    device=w[0].device)
    for i, zi in enumerate(_box_muller(w)):
        z[:, i, :n_mc] = zi
    return z


def normals(seeds, K, n_mc, nmc_pad):
    """The standard normals of K4 (`STREAM_MC`), made inside the kernel
    in its random-number mode and fed to it otherwise: `(B, 3, nmc_pad,
    K)` float32 from the star keys `seeds (B, 2)` int32, rows from
    `n_mc` on zero (they are masked out of every sum)."""
    (w,) = words(seeds, [_mc_part(K, n_mc, seeds.device)])
    return _mc_normals(w, n_mc, nmc_pad)


def posterior_draws(keys, K, n_mc, n_draws, z=None, nmc_pad=None):
    """The posterior's draws of a batch from one Philox evaluation:
    `(z, u, gumbel)` with `u` (B, n_draws) uniforms in [0, 1)
    (`STREAM_U`), `gumbel` (B, n_draws, n_mc) standard Gumbel noise
    -log(-log(u)), u floored at 1e-7 (`STREAM_GUMBEL`), and `z` None,
    K4's normals `(B, 3, nmc_pad, K)` (`z="mc"`, as `normals`) or
    `lnpost_grid`'s `(B, K, 3, n_mc)` (`z="grid"`, `STREAM_GRID_Z`)."""
    dev = keys.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    parts = [(_arange(n_draws, dev), zero, STREAM_U),
             (_arange(n_mc, dev)[None, :], _arange(n_draws, dev)[:, None],
              STREAM_GUMBEL)]
    if z == "mc":
        parts.append(_mc_part(K, n_mc, dev))
    elif z == "grid":
        parts.append((_arange(K, dev)[:, None], _arange(n_mc, dev)[None, :],
                      STREAM_GRID_Z))
    w = words(keys, parts)
    u = bits_to_uniform(w[0][0])
    gumbel = -torch.log(-torch.log(torch.clamp(bits_to_uniform(w[1][0]),
                                               min=U_MIN)))
    if z == "mc":
        z = _mc_normals(w[2], n_mc, nmc_pad)
    elif z == "grid":
        z = torch.stack(_box_muller(w[2]), dim=2)
    return z, u, gumbel


_Z_MODES = {None: 0, "mc": 1, "grid": 2}


def draws(seed, rows, K, n_mc, n_draws, z=None, nmc_pad=None):
    """`(keys, z, u, gumbel)` of the stars at global `rows` (B,) of a fit
    seeded with `seed`: `star_keys` then `posterior_draws`, in one
    kernel launch for CUDA `rows` (`csrc/draws.cu`, the same bits)."""
    rows = torch.as_tensor(rows)
    if rows.device.type != "cuda":
        keys = star_keys(seed, rows)
        return (keys, *posterior_draws(keys, K, n_mc, n_draws, z=z,
                                       nmc_pad=nmc_pad))
    dev = rows.device
    rows = rows.to(torch.int64).contiguous()
    seed = int(seed) & ((1 << 64) - 1)
    B = rows.shape[0]
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    keys = torch.empty((B, 2), dtype=torch.int32, device=dev)
    u, gumbel = f32(B, n_draws), f32(B, n_draws, n_mc)
    zt = (None if z is None else f32(B, 3, nmc_pad, K) if z == "mc"
          else f32(B, K, 3, n_mc))
    KERNELS["draws"](rows, keys, u, gumbel, zt, seed & MASK32, seed >> 32,
                     B, n_draws, n_mc, K, nmc_pad or 0, _Z_MODES[z])
    return keys, zt, u, gumbel


__all__ = ["philox4x32_10", "bits_to_uniform", "star_keys", "words",
           "normals", "posterior_draws", "draws"]
