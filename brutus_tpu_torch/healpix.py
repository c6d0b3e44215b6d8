"""
Minimal nested-order HEALPix angular indexing (vectorized numpy).

The reference depends on `healpy.pixelfunc.ang2pix` (reference
`brutus/dust.py:22-68`) only to locate the sky pixel of each star in
the Bayestar 3-D dust map.  healpy is a heavyweight C extension; this
module implements the standard ang2pix(nested) algorithm of the HEALPix
paper (Gorski et al. 2005) directly, host-side, since dust-map lookup
happens once per star at setup time.  The port's own copy, numpy
only.
"""

import numpy as np


def _interleave_bits(x):
    """Spread the bits of x (uint64, < 2^29) into even positions."""
    x = x.astype(np.uint64)
    x = (x | (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
    x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
    return x


def xy2pix(ix, iy):
    """Interleave (ix, iy) into a nested within-face pixel index."""
    return _interleave_bits(ix) | (_interleave_bits(iy) << np.uint64(1))


def ang2pix_nest(nside, theta, phi):
    """Nested-order pixel index for colatitude `theta`, longitude `phi`.

    Vectorized re-implementation of the classic HEALPix C routine; valid
    for power-of-two `nside` up to 2^29.
    """
    theta = np.atleast_1d(np.asarray(theta, dtype=np.float64))
    phi = np.atleast_1d(np.asarray(phi, dtype=np.float64))
    nside = int(nside)
    z = np.cos(theta)
    za = np.abs(z)
    tt = np.mod(phi, 2.0 * np.pi) * (2.0 / np.pi)       # in [0, 4)

    ix = np.zeros(z.shape, dtype=np.int64)
    iy = np.zeros(z.shape, dtype=np.int64)
    face = np.zeros(z.shape, dtype=np.int64)

    eq = za <= 2.0 / 3.0
    # --- equatorial belt ---
    if np.any(eq):
        t1 = nside * (0.5 + tt[eq])
        t2 = nside * (z[eq] * 0.75)
        jp = np.floor(t1 - t2).astype(np.int64)   # ascending edge line
        jm = np.floor(t1 + t2).astype(np.int64)   # descending edge line
        ifp = jp // nside
        ifm = jm // nside
        f = np.where(ifp == ifm, (ifp & 3) + 4,
                     np.where(ifp < ifm, ifp & 3, (ifm & 3) + 8))
        face[eq] = f
        ix[eq] = jm & (nside - 1)
        iy[eq] = nside - (jp & (nside - 1)) - 1

    # --- polar caps ---
    po = ~eq
    if np.any(po):
        ntt = np.minimum(tt[po].astype(np.int64), 3)
        tp = tt[po] - ntt
        tmp = nside * np.sqrt(3.0 * (1.0 - za[po]))
        jp = np.minimum(np.floor(tp * tmp).astype(np.int64), nside - 1)
        jm = np.minimum(np.floor((1.0 - tp) * tmp).astype(np.int64),
                        nside - 1)
        north = z[po] >= 0
        face[po] = np.where(north, ntt, ntt + 8)
        ix[po] = np.where(north, nside - jm - 1, jp)
        iy[po] = np.where(north, nside - jp - 1, jm)

    pix = face * nside * nside + xy2pix(ix.astype(np.uint64),
                                        iy.astype(np.uint64)).astype(np.int64)
    return pix


def lb2pix(nside, l, b, nest=True, use_native=True):
    """Galactic `(l, b)` degrees -> HEALPix pixel index.

    Parity: reference `brutus/dust.py:22-68` (invalid latitudes map to -1).
    `use_native` is the JAX package's switch to its C++ tier; the port
    has none, so both values take this numpy path.
    """
    if not nest:
        raise NotImplementedError("only nested ordering is supported")
    l = np.atleast_1d(np.asarray(l, dtype=np.float64))
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    valid = (b >= -90.0) & (b <= 90.0)
    theta = np.radians(90.0 - np.clip(b, -90.0, 90.0))
    phi = np.radians(l)
    pix = ang2pix_nest(nside, theta, phi)
    return np.where(valid, pix, -1)


__all__ = ["ang2pix_nest", "lb2pix", "xy2pix"]
