"""
Photometric zero-point self-calibration (mirrors `brutus_tpu/offsets.py`).

Parity: reference `brutus/utils.py:1218-1400` (`photometric_offsets`):
for each band, compare the posterior-predicted model fluxes of fitted
stars against their observed fluxes, reweighting the posterior samples
by a leave-that-band-out likelihood, and bootstrap the median
model/data ratio over objects and samples.

On the card, in float64: the model fluxes of every draw, the
leave-one-band-out weights (one batched `phot_loglike` over objects x
samples) and all `Nmc` bootstrap realisations of a band at once.  The
JAX package draws each realisation's samples from the gathered
`log(wt)[ridx]`, an `(Nmc, n, n_samps)` array; the port draws them by
the inverse CDF of each object's weights, never materialising it, and
never picks a sample of zero weight.  Medians average the two middle
values of an even count, as `jnp.median` does (`torch.median` takes the
lower one).
"""

import sys

import numpy as np
import torch

from .ops.sed import get_seds
from .utils import phot_loglike, resolve_device


def _median(x, dim):
    """Median along `dim` with `jnp.median`'s rule: the mean of the two
    middle values of an even count."""
    s = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    lo = s.narrow(dim, (n - 1) // 2, 1)
    hi = s.narrow(dim, n // 2, 1)
    return ((lo + hi) * 0.5).squeeze(dim)


def _model_fluxes(models, idxs, reds, dreds, dists, dev, flux=True):
    """Posterior-predicted model fluxes of every draw, scaled to its
    distance, `(n_obj, n_samps, n_filt)` float64 on `dev` (reference
    `utils.py:1330-1334`); with `flux=False` apparent magnitudes
    (reference `plotting.py:1073-1077`)."""
    idxs = np.asarray(idxs)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64).ravel(),
                                  device=dev)
    mc = torch.as_tensor(np.asarray(models)[idxs.ravel()],
                         dtype=torch.float64, device=dev)
    seds = get_seds(mc, av=t(reds), rv=t(dreds), return_flux=flux)
    if flux:
        seds = seds / t(dists)[:, None] ** 2
    else:
        seds = seds + 5.0 * torch.log10(t(dists))[:, None]
    return seds.view(*idxs.shape, -1)


def _band_weights(phot, err, mask, seds, band, dim_prior):
    """Leave-`band`-out posterior weights `(n, n_samps)` of the draws'
    model fluxes `seds (n, n_samps, F)` (mirrors
    `offsets._band_weights`; reference `brutus/utils.py:1358-1368`)."""
    m = mask.clone()
    m[:, band] = False
    lnl = torch.func.vmap(lambda p, e, mm, sed: phot_loglike(
        p, e, mm, sed, dim_prior=dim_prior))(phot, err, m, seds)
    return torch.exp(lnl - torch.logsumexp(lnl, dim=1, keepdim=True))


def _draw_samples(wt, ridx, gen):
    """One sample index per entry of `ridx`, drawn from the weights of
    the object it names (`wt (n, n_samps)`, rows summing to 1), by the
    inverse CDF: row `j`'s cumulative weights are laid end to end at
    offset `2 j` and searched once.  A sample of zero weight adds
    nothing to its row's CDF, so it is never the first value past a
    draw; a draw past a row's last rounded value takes that row's last
    sample of positive weight."""
    n, S = wt.shape
    cdf = torch.cumsum(wt, dim=1)
    off = 2.0 * torch.arange(n, dtype=wt.dtype, device=wt.device)
    flat = (cdf + off[:, None]).reshape(-1)
    u = torch.rand(ridx.shape, generator=gen, dtype=wt.dtype,
                   device=wt.device)
    q = off[ridx] + u * cdf[ridx, -1]
    midx = torch.searchsorted(flat, q, right=True) - ridx * S
    pos = wt > 0
    last = S - 1 - torch.argmax(pos.flip(1).to(torch.int8), dim=1)
    return torch.minimum(midx, last[ridx])


def photometric_offsets(phot, err, mask, models, idxs, reds, dreds, dists,
                        sel=None, weights=None, mask_fit=None, Nmc=150,
                        old_offsets=None, dim_prior=True,
                        prior_mean=None, prior_std=None, verbose=True,
                        seed=0, device=None):
    """Multiplicative per-band offsets between data and posterior models
    (mirrors `brutus_tpu.offsets.photometric_offsets`; reference
    `brutus/utils.py:1218-1400`).  The bootstrap draws from a
    `torch.Generator` on the card seeded with `seed`, so it matches the
    JAX package's as a distribution.

    Returns
    -------
    ratios, ratios_err : (Nfilt,) median model/data ratios + bootstrap
        errors; nratio : (Nfilt,) object counts used per band.
    """
    dev = resolve_device(device)
    phot, err = np.asarray(phot), np.asarray(err)
    mask = np.asarray(mask, bool)
    n_obj, n_filt = phot.shape
    n_samps = np.shape(idxs)[1]
    if sel is None:
        sel = np.ones(n_obj, dtype=bool)
    if weights is None:
        weights = np.ones((n_obj, n_samps))
    if mask_fit is None:
        mask_fit = np.ones(n_filt, dtype=bool)
    if old_offsets is None:
        old_offsets = np.ones(n_filt)
    weights = np.asarray(weights, np.float64)

    seds = _model_fluxes(models, idxs, reds, dreds, dists, dev)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    ratios = np.ones(n_filt)
    ratios_err = np.zeros(n_filt)
    nratio = np.zeros(n_filt, dtype=int)

    for i in range(n_filt):
        extra = 1 if mask_fit[i] else 0
        s = np.flatnonzero(mask[:, i] & sel
                           & (mask.sum(axis=1) > 3 + extra)
                           & (weights.sum(axis=1) > 0))
        nratio[i] = len(s)
        if len(s) == 0:
            continue
        s_t = torch.as_tensor(s, device=dev)
        ratio = seds[s_t, :, i] / t(phot[s, i])[:, None]
        if mask_fit[i]:
            wt = _band_weights(t(phot[s] * old_offsets),
                               t(err[s] * old_offsets),
                               torch.as_tensor(mask[s], device=dev),
                               seds[s_t], i, dim_prior)
        else:
            wt = torch.ones((len(s), n_samps), dtype=torch.float64,
                            device=dev)
        wt = wt * t(weights[s])
        wt = wt / wt.sum(dim=1, keepdim=True)
        wt_obj = t(weights[s].sum(axis=1) > 0)
        wt_obj = wt_obj / wt_obj.sum()

        # Bootstrap all Nmc realisations at once.
        n = len(s)
        ridx = torch.multinomial(wt_obj, Nmc * n, replacement=True,
                                 generator=gen).view(Nmc, n)
        midx = _draw_samples(wt, ridx, gen)
        boot = _median(ratio[ridx, midx], dim=1)
        ratios[i] = float(_median(boot, dim=0))
        ratios_err[i] = float(boot.std(unbiased=False))
        if verbose:
            sys.stderr.write(f"\rBand {i + 1}/{n_filt} "
                             f"({ratios[i]:.4f} +/- {ratios_err[i]:.4f}) ")
            sys.stderr.flush()
    if verbose:
        sys.stderr.write("\n")

    # Gaussian prior combination (reference utils.py:1394-1398).
    if prior_mean is not None and prior_std is not None:
        var_tot = ratios_err ** 2 + prior_std ** 2
        ratios = (ratios * prior_std ** 2
                  + prior_mean * ratios_err ** 2) / var_tot
        ratios_err = ratios_err * prior_std / np.sqrt(var_tot)

    return ratios, ratios_err, nratio


__all__ = ["photometric_offsets"]
