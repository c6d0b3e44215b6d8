"""
Star-side data hygiene shared by the port's likelihood stages
(mirrors `brutus_tpu/ops/optimize.py:44-70`).
"""

import math

import torch

from ..config import FitConfig


def prepare_star_data(flux, fluxerr, mask, cfg: FitConfig):
    """Data hygiene + magnitude conversion (reference
    `brutus/fitting.py:706-725`).  Masked or unclean bands get zero
    weight; negative-flux bands keep their flux-space weight but get a
    ~zero magnitude-space weight (the reference's 1e50 variance flag).

    Returns `(flux, wt_flux, mags, wt_mag, mask, ndim, tot_var)`.
    """
    clean = torch.isfinite(flux) & torch.isfinite(fluxerr) & (fluxerr > 0.0)
    mask = (mask > 0) & clean
    zero = torch.zeros_like(flux)
    one = torch.ones_like(flux)
    flux = torch.where(mask, flux, zero)
    fluxerr = torch.where(mask, fluxerr, one)
    ndim = mask.sum(dim=-1)
    tot_var = fluxerr * fluxerr
    wt_flux = torch.where(mask, 1.0 / tot_var, zero)
    pos = mask & (flux > 0.0)
    safe_flux = torch.where(pos, flux, one)
    mags = torch.where(pos, -2.5 * torch.log10(safe_flux), zero)
    mags_var = (2.5 / math.log(10.0)) ** 2 * tot_var / (safe_flux
                                                         * safe_flux)
    wt_mag = torch.where(mask, torch.where(pos, 1.0 / mags_var,
                                           one / cfg.big_var), zero)
    return flux, wt_flux, mags, wt_mag, mask, ndim, tot_var


__all__ = ["prepare_star_data"]
