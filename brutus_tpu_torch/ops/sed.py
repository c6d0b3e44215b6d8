"""
Reddened SEDs from per-band magnitude coefficients (mirrors
`brutus_tpu/ops/sed.py`; reference `brutus/utils.py:286-347`).

The grid stores, per (model, band), three coefficients `(mag, r0, dr)`:
the unreddened magnitude, the A(V) reddening vector at R(V) = 0 and its
derivative in R(V).  The reddened magnitude is the bilinear form

    sed_mag = mag + av * (r0 + rv * dr)

evaluated elementwise over any leading dimensions.
"""

import math

import torch

FLUX_FAC = -0.4 * math.log(10.0)


def get_seds_mag(mag_coeffs, av, rv):
    """Reddened SEDs in magnitudes (mirrors `sed.get_seds_mag`).

    mag_coeffs : (..., Nbands, 3); av, rv : (...,) broadcastable against
    the model axes.  Returns `seds, rvecs, drvecs`, each (..., Nbands)
    (`drvecs` unbroadcast: the `dr` coefficients).
    """
    mags = mag_coeffs[..., 0]
    r0 = mag_coeffs[..., 1]
    dr = mag_coeffs[..., 2]
    rvecs = r0 + rv[..., None] * dr
    seds = mags + av[..., None] * rvecs
    return seds, rvecs, dr


def get_seds_flux(mag_coeffs, av, rv):
    """Reddened SEDs in flux densities with flux-space reddening vectors
    (mirrors `sed.get_seds_flux`; the reference kernel's
    `return_flux=True` path, `brutus/utils.py:341-345`)."""
    seds, rvecs, drvecs = get_seds_mag(mag_coeffs, av, rv)
    flux = torch.pow(10.0, -0.4 * seds)
    rvecs_f = FLUX_FAC * flux * rvecs
    drvecs_f = FLUX_FAC * flux * drvecs.expand(flux.shape)
    return flux, rvecs_f, drvecs_f


def get_seds(mag_coeffs, av=None, rv=None, return_flux=False,
             return_rvec=False, return_drvec=False):
    """API-compatible wrapper (mirrors `sed.get_seds`; reference
    `brutus/utils.py:1089-1159`): `av` defaults to 0 and `rv` to 3.3."""
    lead = mag_coeffs.shape[:-2]
    kw = dict(dtype=mag_coeffs.dtype, device=mag_coeffs.device)
    av = (torch.zeros(lead, **kw) if av is None
          else torch.as_tensor(av, **kw).expand(lead))
    rv = (torch.full(lead, 3.3, **kw) if rv is None
          else torch.as_tensor(rv, **kw).expand(lead))
    if return_flux:
        seds, rvecs, drvecs = get_seds_flux(mag_coeffs, av, rv)
    else:
        seds, rvecs, drvecs = get_seds_mag(mag_coeffs, av, rv)
        drvecs = drvecs.expand(seds.shape)
    if return_rvec and return_drvec:
        return seds, rvecs, drvecs
    if return_rvec:
        return seds, rvecs
    if return_drvec:
        return seds, drvecs
    return seds


__all__ = ["get_seds", "get_seds_mag", "get_seds_flux", "FLUX_FAC"]
