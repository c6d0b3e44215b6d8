"""
Binned 2-D distance-reddening posteriors (and prior re-exports), mirrors
`brutus_tpu/pdf.py`.

Parity: reference `brutus/pdf.py:843-1113` (`bin_pdfs_distred`):
histogram each star's posterior draws onto a (distance-like x Av-like)
grid, with optional regeneration of draws from the saved
`(scale, av, rv, cov_sar)` Gaussians, parallax-aware Gaussian
smoothing, and optional CDF accumulation for LOS MAP evaluation.

The JAX package bins and smooths star by star on the host
(`np.histogram2d`, `scipy.ndimage.gaussian_filter`); the port does both
for blocks of stars on the card, in float64:

* binning: the edges come from `np.linspace` in float64 and are copied
  to the card (`torch.linspace` may differ in the last bit); a draw's
  bin is `torch.bucketize(..., right=True)` less one, numpy's
  `searchsorted(side="right")`, with numpy's rule that a draw on the
  last edge falls in the last bin; draws outside the edges are dropped;
* smoothing: `gaussian_filter(H, (sx, sy))` (mode "reflect", truncate
  4) is linear in `H`, so it is `Sx @ H @ Sy.T`: row `i` of the per-star
  `(xbin, xbin)` matrix `Sx` holds the normalised weights of offsets
  `-r..r` folded back into the axis as scipy reflects them (again and
  again where `r` exceeds the axis); `Sy` is shared by every star.
  Float64 products never use TF32.
"""

import sys
import warnings

import numpy as np
import torch

from .priors import (imf_lnprior, ps1_MrLF_lnprior, parallax_lnprior,  # noqa: F401
                     scale_parallax_lnprior, parallax_to_scale,
                     logn_disk, logn_halo, logp_feh, logp_age_from_feh,
                     gal_lnprior, dust_lnprior)
from .utils import draw_sar, resolve_device

DIST_TYPES = ["parallax", "scale", "distance", "distance_modulus"]

# The largest float64 temporary of one block of stars: 2**26 values
# (512 MiB), which sets how many stars go through the card at once.
BLOCK_ELEMENTS = 1 << 26


def _to_dist_type(ddraws, dist_type):
    pdraws = 1.0 / ddraws
    if dist_type == "scale":
        return pdraws ** 2
    if dist_type == "parallax":
        return pdraws
    if dist_type == "distance":
        return ddraws
    return 5.0 * torch.log10(ddraws) + 10.0


def _histogram(x, y, w, xedges, yedges):
    """Per-star 2-D histograms `(B, xbin, ybin)` of draws `x, y (B, n)`
    with weights `w` (None: counts), with `np.histogram2d`'s bins."""
    B = x.shape[0]
    nx, ny = len(xedges) - 1, len(yedges) - 1
    ix = torch.bucketize(x, xedges, right=True)
    iy = torch.bucketize(y, yedges, right=True)
    ix = torch.where(x == xedges[-1], ix - 1, ix)
    iy = torch.where(y == yedges[-1], iy - 1, iy)
    ok = (ix >= 1) & (ix <= nx) & (iy >= 1) & (iy <= ny)
    star = torch.arange(B, device=x.device)[:, None]
    flat = (star * nx + ix - 1) * ny + iy - 1
    vals = torch.ones_like(x) if w is None else w
    H = torch.zeros(B * nx * ny, dtype=torch.float64, device=x.device)
    H.index_add_(0, flat[ok], vals[ok].to(torch.float64))
    return H.view(B, nx, ny)


def _smoothing_matrices(sigma, n, device):
    """`(B, n, n)` matrices of `scipy.ndimage.gaussian_filter1d` along an
    axis of `n` bins (mode "reflect", truncate 4), one per standard
    deviation in `sigma (B,)` (bins, float64); an axis whose sigma is at
    most 1e-15 is left as it is, as scipy skips it."""
    sigma = np.asarray(sigma, np.float64)
    skip = sigma <= 1e-15
    radius = np.where(skip, 0, (4.0 * np.where(skip, 0.0, sigma)
                                + 0.5).astype(np.int64))
    R = int(radius.max())
    k = np.arange(-R, R + 1)
    with np.errstate(divide="ignore"):
        phi = np.exp(-0.5 / np.where(skip, 1.0, sigma * sigma)[:, None]
                     * k[None] ** 2)
    phi = np.where(np.abs(k)[None] <= radius[:, None], phi, 0.0)
    phi = phi / phi.sum(axis=1, keepdims=True)
    # The bin each offset of each row reads, reflected (d c b a | a b c d
    # | d c b a, repeated with period 2n).
    m = (np.arange(n)[:, None] + k[None]) % (2 * n)
    m = np.where(m >= n, 2 * n - 1 - m, m)
    B = len(sigma)
    idx = torch.as_tensor(m, device=device).expand(B, n, 2 * R + 1)
    w = torch.as_tensor(phi, device=device)[:, None, :].expand(B, n,
                                                               2 * R + 1)
    S = torch.zeros((B, n, n), dtype=torch.float64, device=device)
    return S.scatter_add_(2, idx, w)


def _x_smoothing(xsmooth, parallaxes, parallax_errors, dist_type):
    """Per-star x smoothing: the smaller of `xsmooth` and half the 1-sigma
    parallax interval in the `dist_type` units, where that is finite
    (reference `pdf.py:1080-1106`)."""
    hi = parallaxes + parallax_errors
    lo = np.maximum(parallaxes - parallax_errors, 1e-10)
    with warnings.catch_warnings(), np.errstate(all="ignore"):
        warnings.simplefilter("ignore")
        if dist_type == "scale":
            xmin = np.abs(lo ** 2 - hi ** 2) / 2.0
        elif dist_type == "parallax":
            xmin = np.abs(lo - hi) / 2.0
        elif dist_type == "distance":
            xmin = np.abs(1.0 / lo - 1.0 / hi) / 2.0
        else:
            xmin = np.abs(5.0 * np.log10(1.0 / lo)
                          - 5.0 * np.log10(1.0 / hi)) / 2.0
        return np.where(np.isfinite(xmin), np.minimum(xmin, xsmooth),
                        xsmooth)


def bin_pdfs_distred(data, cdf=False, ebv=False,
                     dist_type="distance_modulus", lndistprior=None,
                     coord=None, avlim=(0.0, 6.0), rvlim=(1.0, 8.0),
                     parallaxes=None, parallax_errors=None, Nr=100,
                     bins=(750, 300), span=None, smooth=0.01, seed=0,
                     verbose=False, device=None):
    """Binned 2-D (distance x reddening) PDFs/CDFs per star (mirrors
    `brutus_tpu.pdf.bin_pdfs_distred`; reference `brutus/pdf.py:
    843-1113`).

    `data` is either `(dists, reds, dreds)` saved draws or `(scales,
    avs, rvs, covs_sar)` to regenerate `Nr` draws per model with
    `utils.draw_sar` (from a `torch.Generator` seeded with `seed`, so
    they match the JAX package's as a distribution) and reweight them
    by `lndistprior` (default `gal_lnprior` at `coord`; a custom
    per-star `lndistprior(dists (nsel, Nr), coord (2,))` on tensors is
    called star by star, as the JAX package calls it) and the
    parallaxes.
    Draws are binned in float64 whatever their dtype.

    Returns `(pdfs (nobj, xbin, ybin) float32, xedges, yedges)` as numpy
    arrays; with `cdf=True` the PDFs are accumulated along the distance
    axis.
    """
    dev = resolve_device(device)
    nobjs, nsamps = np.shape(data[0])[:2]
    if dist_type not in DIST_TYPES:
        raise ValueError("The provided `dist_type` is not valid.")
    if parallaxes is None:
        parallaxes = np.full(nobjs, np.nan)
    if parallax_errors is None:
        parallax_errors = np.full(nobjs, np.nan)
    parallaxes = np.asarray(parallaxes, np.float64)
    parallax_errors = np.asarray(parallax_errors, np.float64)

    # Bin layout (reference pdf.py:949-976).
    if span is None:
        avlims = avlim
        dlims = 10 ** (np.array([4.0, 19.0]) / 5.0 - 2.0)
    else:
        avlims, dlims = span
    try:
        xbin, ybin = bins
    except TypeError:
        xbin = ybin = bins
    ylims = avlims
    if dist_type == "scale":
        xlims = (1.0 / dlims[::-1]) ** 2
    elif dist_type == "parallax":
        xlims = 1.0 / dlims[::-1]
    elif dist_type == "distance":
        xlims = dlims
    else:
        xlims = 5.0 * np.log10(dlims) + 10.0
    xedges = np.linspace(xlims[0], xlims[1], xbin + 1)
    yedges = np.linspace(ylims[0], ylims[1], ybin + 1)
    dx, dy = xedges[1] - xedges[0], yedges[1] - yedges[0]
    xspan, yspan = xlims[1] - xlims[0], ylims[1] - ylims[0]

    # Smoothing scales (reference pdf.py:978-992).
    try:
        xsmooth = smooth[0] * (xspan if smooth[0] < 1 else dx)
        ysmooth = smooth[1] * (yspan if smooth[1] < 1 else dy)
    except TypeError:
        xsmooth = smooth * (xspan if smooth < 1 else dx)
        ysmooth = smooth * (yspan if smooth < 1 else dy)
    xsig = _x_smoothing(xsmooth, parallaxes, parallax_errors,
                        dist_type) / dx
    Sy = _smoothing_matrices([ysmooth / dy], ybin, dev)[0]

    regen = len(data) != 3
    if regen:
        if coord is None:
            raise ValueError("`coord` must be passed when regenerating "
                             "draws with the default distance prior")
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        n_draw = nsamps * Nr
    else:
        n_draw = nsamps
    t = lambda x, sl: torch.as_tensor(np.asarray(x)[sl], device=dev,
                                      dtype=torch.float64)
    xe, ye = t(xedges, slice(None)), t(yedges, slice(None))
    binned = np.empty((nobjs, xbin, ybin), dtype=np.float32)
    per_star = xbin * max(xbin, ybin, 1) + n_draw
    nb = max(1, BLOCK_ELEMENTS // per_star)
    for b0 in range(0, nobjs, nb):
        sl = slice(b0, min(b0 + nb, nobjs))
        if verbose:
            sys.stderr.write(f"\rBinning objects {sl.stop}/{nobjs}")
        if not regen:
            ddr, adr, rdr = (t(d, sl) for d in data)
            wts = None
        else:
            _, ddr, adr, rdr, wts = _regenerate(
                gen, *(t(d, sl) for d in data), Nr, avlim, rvlim,
                lndistprior, t(coord, sl), t(parallaxes, sl),
                t(parallax_errors, sl))
            wts = wts.reshape(len(wts), -1)
        B = sl.stop - sl.start
        ydr = (adr / rdr if ebv else adr).reshape(B, -1)
        xdr = _to_dist_type(ddr, dist_type).reshape(B, -1)
        H = _histogram(xdr, ydr, wts, xe, ye) / nsamps
        # The JAX package stores H / nsamps as float32 before smoothing.
        H = H.to(torch.float32).to(torch.float64)
        out = _smoothing_matrices(xsig[sl], xbin, dev) @ H @ Sy.T
        if cdf:
            out = out.to(torch.float32).to(torch.float64).cumsum(dim=1)
        torch.from_numpy(binned[sl]).copy_(out.to(torch.float32))
    if verbose:
        sys.stderr.write("\n")
    return binned, xedges, yedges


def _regenerate(gen, scales, avs, rvs, covs, Nr, avlim, rvlim, lndistprior,
                coord, plx, plxe):
    """`Nr` draws of `(parallax, dist, Av, Rv)` per saved model of a block
    of `B` stars from their `(scale, av, rv, cov_sar)` Gaussians
    (`draw_sar`), and each draw's weight under the distance prior and
    the parallax, normalised over the model's draws (reference
    `pdf.py:1024-1078`; the draws of `plotting.cornerplot_fit` too).

    scales, avs, rvs : (B, nsel); covs : (B, nsel, 3, 3); coord :
    (B, 2) or None; plx, plxe : (B,), NaN where there is no parallax.
    The distance prior is `gal_lnprior` at each star's `coord`, or a
    custom `lndistprior(dists (nsel, Nr), coord (2,))` on tensors called
    star by star.  A scale draw of 0 (`draw_sar`'s clipped mean where no
    draw is in bounds) is floored at 1e-300 before its square root: its
    distance lies outside every bin either way.  Returns five
    `(B, nsel, Nr)` tensors."""
    B, nsel = scales.shape
    sdr, adr, rdr = (v.view(B, nsel, Nr) for v in draw_sar(
        gen, scales.reshape(-1), avs.reshape(-1), rvs.reshape(-1),
        covs.reshape(-1, 3, 3), ndraws=Nr, avlim=avlim, rvlim=rvlim))
    pdr = torch.sqrt(torch.clamp(sdr, min=1e-300))
    ddr = 1.0 / pdr
    if lndistprior is None:
        lnp = gal_lnprior(ddr.reshape(B, -1), coord).view(B, nsel, Nr)
    else:
        lnp = torch.stack([torch.as_tensor(
            lndistprior(ddr[i], None if coord is None else coord[i]),
            dtype=ddr.dtype, device=ddr.device) for i in range(B)])
    lnp = lnp + parallax_lnprior(pdr, plx[:, None, None],
                                 plxe[:, None, None])
    wts = torch.exp(lnp - torch.logsumexp(lnp, dim=2, keepdim=True))
    wts = wts / wts.sum(dim=2, keepdim=True)
    return pdr, ddr, adr, rdr, wts


__all__ = ["bin_pdfs_distred",
           "imf_lnprior", "ps1_MrLF_lnprior", "parallax_lnprior",
           "scale_parallax_lnprior", "parallax_to_scale",
           "logn_disk", "logn_halo", "logp_feh", "logp_age_from_feh",
           "gal_lnprior", "dust_lnprior"]
