"""Inputs of a cell, made from its seed: the grid, the dust map, the
star catalogues of its calls and the order of the calls.

One general generator reads a configuration's grid and dust-map
sections and a traffic mix's parameters (`traffic/<name>.json`); a new
mix is a new data file.  Frozen copies: `correlated_grid` and `stars`
come from the repository's `chip_smoke.py` (`correlated_grid`,
`stars`, `smoke_dustmap`), the stars extended to the mixes' parameters
and the one-profile dust map to a seeded map of one line-of-sight
profile per HEALPix pixel on Bayestar19's distance ladder.  Nothing
here imports the program.
"""

import math

import numpy as np


def correlated_grid(n_model, n_filt, seed=2):
    """Label-ordered correlated grid (copy of `chip_smoke.correlated_grid`):
    a (mini, eep, feh) lattice with smooth coefficient surfaces, so
    neighbouring models are nearly degenerate and good fits cluster into
    contiguous bands.  Returns the `(M, F, 3)` float32 coefficients and
    the `(mini, feh, loga)` labels."""
    rng = np.random.default_rng(seed)
    n_feh, n_eep = 10, 320
    n_mini = -(-n_model // (n_feh * n_eep))
    mini = np.linspace(0.5, 2.0, n_mini)
    eep = np.linspace(202.0, 600.0, n_eep)
    feh = np.linspace(-1.0, 0.5, n_feh)
    mm, ee, ff = [a.ravel()[:n_model] for a in
                  np.meshgrid(mini, eep, feh, indexing="ij")]
    x = (ee - 202.0) / 398.0
    logt = 3.75 - 0.12 * (mm - 1.0) + 0.25 * np.sin(np.pi * x) - 0.04 * ff
    logl = 0.2 + 3.2 * np.log10(mm) + 1.8 * x ** 2
    lam = np.linspace(0.0, 1.0, n_filt)
    a1 = 2.0 - 3.5 * lam
    a2 = rng.uniform(-1.5, 1.5, n_filt)
    zp = rng.uniform(8.0, 10.0, n_filt)
    t = (logt - 3.75)[:, None]
    mags = zp[None] - 2.5 * logl[:, None] + a1[None] * t + a2[None] * t ** 2
    r0 = 1.15 * np.exp(-0.9 * lam)[None] * (1.0 + 0.08 * t)
    dr = 0.16 * r0 * (lam - 0.45)[None]
    mc = np.stack([mags, r0, dr], axis=-1).astype(np.float32)
    labels = np.zeros(n_model, [("mini", float), ("feh", float),
                                ("loga", float)])
    labels["mini"], labels["feh"], labels["loga"] = mm, ff, 8.0 + 2.0 * x
    return mc, labels


def ang2pix_ring(nside, theta, phi):
    """HEALPix RING pixel of colatitude `theta` and longitude `phi`
    (radians), the published algorithm (Gorski et al. 2005, as healpy's
    `ang2pix` computes it)."""
    z = np.cos(theta)
    za = np.abs(z)
    tt = np.mod(phi, 2.0 * np.pi) / (0.5 * np.pi)          # [0, 4)
    pix = np.empty(np.shape(z), dtype=np.int64)
    eq = za <= 2.0 / 3.0
    # equatorial belt
    t1 = nside * (0.5 + tt[eq])
    t2 = nside * z[eq] * 0.75
    jp = np.floor(t1 - t2).astype(np.int64)
    jm = np.floor(t1 + t2).astype(np.int64)
    ir = nside + 1 + jp - jm
    kshift = 1 - (ir & 1)
    ip = (jp + jm - nside + kshift + 1) // 2
    ip = np.mod(ip, 4 * nside)
    pix[eq] = 2 * nside * (nside - 1) + (ir - 1) * 4 * nside + ip
    # polar caps
    pc = ~eq
    tp = tt[pc] - np.floor(tt[pc])
    tmp = nside * np.sqrt(3.0 * (1.0 - za[pc]))
    jp = np.floor(tp * tmp).astype(np.int64)
    jm = np.floor((1.0 - tp) * tmp).astype(np.int64)
    ir = jp + jm + 1
    ip = np.mod(np.floor(tt[pc] * ir).astype(np.int64), 4 * ir)
    north = z[pc] > 0
    pix[pc] = np.where(north, 2 * ir * (ir - 1) + ip,
                       12 * nside * nside - 2 * ir * (ir + 1) + ip)
    return pix


class DustMap:
    """A seeded 3-D dust map of Bayestar19's layout: one line-of-sight
    profile of mean and scatter A(V) per HEALPix pixel (RING, `nside`),
    on `n_dist` distances uniform in distance modulus.  `query` has the
    program's dust-map interface: `(l, b)` degrees to `(dists (n,),
    av_mean (N, n), av_std (N, n))`.

    Each profile is cumulative: `A_inf (1 - exp(-d / h))` plus one
    cloud, a logistic step in distance modulus, with `A_inf` larger
    toward the plane; the scatter grows with the extinction."""

    def __init__(self, seed, nside=16, n_dist=120, dm_min=4.0, dm_max=19.0):
        rng = np.random.default_rng(seed)
        self.nside = nside
        n_pix = 12 * nside * nside
        dm = np.linspace(dm_min, dm_max, n_dist)
        self.dists = 10.0 ** (dm / 5.0 - 2.0)                  # kpc
        theta, _ = pix_centres(nside)
        sinb = np.abs(np.cos(theta))
        a_inf = np.minimum(np.exp(rng.normal(np.log(
            0.25 / np.maximum(sinb, 0.1)), 0.5)), 8.0)
        h = rng.uniform(0.3, 2.0, n_pix)
        cloud = rng.uniform(0.0, 0.5, n_pix) * a_inf
        dm_cloud = rng.uniform(7.0, 12.0, n_pix)
        d = self.dists[None]
        mean = (a_inf[:, None] * (1.0 - np.exp(-d / h[:, None]))
                + cloud[:, None] / (1.0 + np.exp(-(dm[None]
                                                   - dm_cloud[:, None])
                                                 / 0.1)))
        self.av_mean = mean.astype(np.float32)
        self.av_std = (0.05 + 0.15 * mean).astype(np.float32)

    def pixel(self, l, b):
        l = np.atleast_1d(np.asarray(l, dtype=float))
        b = np.atleast_1d(np.asarray(b, dtype=float))
        return ang2pix_ring(self.nside, np.deg2rad(90.0 - b),
                            np.deg2rad(l))

    def query(self, coord):
        pix = self.pixel(coord[0], coord[1])
        return (self.dists, self.av_mean[pix].astype(float),
                self.av_std[pix].astype(float))

    def at(self, pix, dist):
        """Each star's profile at its distance, interpolated linearly on
        the ladder: `(mean, std)`."""
        i = np.clip(np.searchsorted(self.dists, dist) - 1, 0,
                    len(self.dists) - 2)
        w = np.clip((dist - self.dists[i])
                    / (self.dists[i + 1] - self.dists[i]), 0.0, 1.0)
        take = lambda a: (1 - w) * a[pix, i] + w * a[pix, i + 1]
        return take(self.av_mean), take(self.av_std)


def pix_centres(nside):
    """`(theta, phi)` of every RING pixel's centre (the published
    formulas)."""
    npix = 12 * nside * nside
    p = np.arange(npix)
    ncap = 2 * nside * (nside - 1)
    theta = np.empty(npix)
    phi = np.empty(npix)
    north = p < ncap
    south = p >= npix - ncap
    belt = ~(north | south)
    ph = (p[north] + 1) / 2.0
    i = np.floor(np.sqrt(ph - np.sqrt(np.floor(ph)))) + 1
    j = p[north] + 1 - 2 * i * (i - 1)
    theta[north] = np.arccos(1.0 - i * i / (3.0 * nside * nside))
    phi[north] = (j - 0.5) * np.pi / (2.0 * i)
    q = p[belt] - ncap
    i = q // (4 * nside) + nside
    j = q % (4 * nside) + 1
    fodd = 0.5 * (1 + (i + nside) % 2)
    theta[belt] = np.arccos((2 * nside - i) * 2.0 / (3.0 * nside))
    phi[belt] = (j - fodd) * np.pi / (2.0 * nside)
    ip = npix - p[south]
    i = np.floor(0.5 * (1 + np.sqrt(2.0 * ip - 1)))
    j = 4 * i + 1 - (ip - 2 * i * (i - 1))
    theta[south] = np.arccos(-1.0 + i * i / (3.0 * nside * nside))
    phi[south] = (j - 0.5) * np.pi / (2.0 * i)
    return theta, phi


def log_uniform(rng, lo, hi, n):
    return np.exp(rng.uniform(math.log(lo), math.log(hi), n))


def stars(mc, dmap, n, rng, mix, coord=None):
    """A catalogue of `n` stars (extension of `chip_smoke.stars`): grid
    models drawn uniformly, distances log-uniform over `mix["dist_kpc"]`,
    A(V) from the star's sightline profile at its distance with its
    scatter (at least 0), R(V) uniform over `mix["rv"]`, one SNR per
    star log-uniform over `mix["snr"]` in every band, parallaxes with
    errors log-uniform over `mix["plx_err_mas"]`, and a share
    `mix["missing_share"]` of the stars without the bands
    `mix["missing_bands"]` (NaN, masked).  Stars lie uniformly on the
    sky, or all at `coord` `(l, b)`."""
    M, F, _ = mc.shape
    idx = rng.integers(0, M, n)
    dist = log_uniform(rng, *mix["dist_kpc"], n)
    if coord is None:
        l = rng.uniform(0.0, 360.0, n)
        b = np.rad2deg(np.arcsin(rng.uniform(-1.0, 1.0, n)))
    else:
        l, b = np.full(n, coord[0]), np.full(n, coord[1])
    pix = dmap.pixel(l, b)
    av_m, av_s = dmap.at(pix, dist)
    av = np.maximum(av_m + av_s * rng.normal(size=n), 0.0)
    rv = rng.uniform(*mix["rv"], n)
    c = mc[idx].astype(float)
    sed = c[..., 0] + av[:, None] * (c[..., 1] + rv[:, None] * c[..., 2])
    flux = 10 ** (-0.4 * sed) / dist[:, None] ** 2
    snr = log_uniform(rng, *mix["snr"], n)
    err = flux / snr[:, None]
    flux = flux + rng.normal(size=flux.shape) * err
    plxe = log_uniform(rng, *mix["plx_err_mas"], n)
    plx = 1.0 / dist + rng.normal(size=n) * plxe
    mask = np.ones((n, F), bool)
    lack = rng.random(n) < mix["missing_share"]
    for band in mix["missing_bands"]:
        mask[lack, band] = False
    flux[~mask] = np.nan
    err[~mask] = np.nan
    return dict(flux=flux.astype(np.float32), err=err.astype(np.float32),
                mask=mask, plx=plx, plxe=plxe,
                coords=np.stack([l, b], axis=1), idx=idx, dist=dist,
                av=av, rv=rv)


def call_sizes(mix, rng):
    """The star counts of one cycle of calls, in the order the seed
    gives: a fixed size, or `distinct` sizes at the quantiles
    `(k + 0.5) / distinct` of a log-uniform law (the same set for every
    seed, so seeds change the order and not the work)."""
    size = mix["call_stars"]
    if "fixed" in size:
        return [int(size["fixed"])] * int(mix["pool_calls"])
    lo, hi = size["log_uniform"]
    k = int(size["distinct"])
    q = (np.arange(k) + 0.5) / k
    sizes = np.rint(np.exp(math.log(lo) + q * math.log(hi / lo)))
    return [int(x) for x in rng.permutation(sizes.astype(int))]


def calls(mc, dmap, mix, seed):
    """The cycle of catalogues a cell's calls take in turn: one per
    `call_sizes` entry."""
    rng = np.random.default_rng([seed, 1])
    out = []
    for i, n in enumerate(call_sizes(mix, rng)):
        coord = None
        if mix["sky"] == "one_sightline_per_call":
            coord = (rng.uniform(0.0, 360.0),
                     float(np.rad2deg(np.arcsin(rng.uniform(-1.0, 1.0)))))
        out.append(stars(mc, dmap, n, rng, mix, coord))
    return out


def make(config, mix, seed):
    """Grid, labels, dust map and call cycle of a cell."""
    g = config["grid"]
    mc, labels = correlated_grid(g["n_model"], g["n_band"],
                                 seed=int(np.random.default_rng(
                                     [seed, 0]).integers(2 ** 31)))
    dmap = DustMap(np.random.default_rng([seed, 2]).integers(2 ** 31),
                   **config["dust_map"])
    return mc, labels, dmap, calls(mc, dmap, mix, seed)
