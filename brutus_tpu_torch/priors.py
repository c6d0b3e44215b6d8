"""
Prior log-probabilities of the PyTorch port (mirrors
`brutus_tpu/priors.py`; reference `brutus/pdf.py:30-840`).

Elementwise over leading dimensions: the same functions serve the
per-model pass of the posterior's select stage and host-side grid
priors.  The Monte-Carlo pass runs the same formulas inside the MC
kernel (`ops/mc.py`).
"""

import math
import os

import numpy as np
import torch

from .config import GalPriorConfig, DustPriorConfig
from .coords import galactic_to_cylindrical
from .utils import _interp, truncnorm_logpdf


def imf_lnprior(mgrid, alpha_low=1.3, alpha_high=2.3, mass_break=0.5,
                mgrid2=None):
    """Kroupa-like broken-power-law IMF log-prior over initial mass
    (reference `brutus/pdf.py:38-108`)."""
    def single(m):
        m = torch.as_tensor(m)
        lnm = torch.log(torch.where(m > 0, m, torch.ones_like(m)))
        low = -alpha_low * lnm
        high = (-alpha_high * lnm
                + (alpha_high - alpha_low) * math.log(mass_break))
        return torch.where(m > mass_break, high,
                           torch.where(m > 0.08, low,
                                       torch.full_like(m, -math.inf)))

    lnprior = single(mgrid)
    norm_low = mass_break ** (1.0 - alpha_low) / (alpha_high - 1.0)
    norm_high = (0.08 ** (1.0 - alpha_low) / (alpha_low - 1.0)
                 - mass_break ** (1.0 - alpha_low) / (alpha_low - 1.0))
    norm = norm_low + norm_high
    if mgrid2 is not None:
        lnprior = lnprior + single(mgrid2)
        norm = norm ** 2
    return lnprior - math.log(norm)


def _ps1_table():
    path = os.path.join(os.path.dirname(os.path.realpath(__file__)),
                        "data", "PSMrLF_lnprior.dat")
    return np.loadtxt(path).T


def ps1_MrLF_lnprior(Mr):
    """PanSTARRS r-band luminosity-function log-prior over absolute M_r
    (reference `brutus/pdf.py:111-141`), linearly extrapolated."""
    grid_Mr, grid_lnp = _ps1_table()
    Mr = torch.as_tensor(Mr)
    x = Mr.detach().cpu().numpy()
    lnp = np.interp(x, grid_Mr, grid_lnp)
    slope_lo = (grid_lnp[1] - grid_lnp[0]) / (grid_Mr[1] - grid_Mr[0])
    slope_hi = (grid_lnp[-1] - grid_lnp[-2]) / (grid_Mr[-1] - grid_Mr[-2])
    lnp = np.where(x < grid_Mr[0],
                   grid_lnp[0] + slope_lo * (x - grid_Mr[0]), lnp)
    lnp = np.where(x > grid_Mr[-1],
                   grid_lnp[-1] + slope_hi * (x - grid_Mr[-1]), lnp)
    return torch.as_tensor(lnp, dtype=Mr.dtype, device=Mr.device)


def parallax_lnprior(parallaxes, p_meas, p_err):
    """Gaussian parallax log-prior; uniform when the measurement is
    missing (reference `brutus/pdf.py:144-175`)."""
    have = torch.isfinite(p_meas) & torch.isfinite(p_err)
    err = torch.where(have, p_err, torch.ones_like(p_err))
    chi2 = (parallaxes - torch.where(have, p_meas,
                                     torch.zeros_like(p_meas))) ** 2 \
        / err ** 2
    lnorm = torch.log(2.0 * math.pi * err ** 2)
    return torch.where(have, -0.5 * (chi2 + lnorm),
                       torch.zeros_like(parallaxes))


def parallax_to_scale(p_meas, p_err, snr_lim=4.0):
    """Gaussian approximation of the parallax in scale space `s = p**2`,
    `s_mean = p^2 + sig^2`, `s_std = sqrt(2 sig^4 + 4 p^2 sig^2)`, above
    the SNR gate `snr_lim` (mirrors `priors.parallax_to_scale`;
    reference `brutus/pdf.py:225-260`); 1e-20 and 1e20 below it."""
    ok = torch.isfinite(p_meas) & torch.isfinite(p_err) & \
        (p_meas / p_err > snr_lim)
    pm = torch.clamp(p_meas, min=0.0)
    s_mean = torch.where(ok, pm ** 2 + p_err ** 2,
                         torch.full_like(pm, 1e-20))
    s_std = torch.where(ok, torch.sqrt(2 * p_err ** 4
                                       + 4 * pm ** 2 * p_err ** 2),
                        torch.full_like(pm, 1e20))
    return s_mean, s_std


def scale_parallax_lnprior(scales, scale_errs, p_meas, p_err,
                           snr_lim=4.0):
    """Parallax prior on flux scales `s ~ p**2` (reference
    `brutus/pdf.py:178-260`); uniform below the SNR gate."""
    okerr = torch.isfinite(p_err) & (p_err > 0)
    snr = torch.where(okerr, p_meas / torch.where(okerr, p_err,
                                                  torch.ones_like(p_err)),
                      torch.full_like(p_meas, -math.inf))
    ok = torch.isfinite(p_meas) & torch.isfinite(p_err) & (snr > snr_lim)
    pm = torch.clamp(torch.where(ok, p_meas, torch.ones_like(p_meas)),
                     min=0.0)
    pe = torch.where(ok, p_err, torch.ones_like(p_err))
    s_mean = pm ** 2 + pe ** 2
    s_std = torch.sqrt(2 * pe ** 4 + 4 * pm ** 2 * pe ** 2)
    svar_tot = s_std ** 2 + scale_errs ** 2
    chi2 = (scales - s_mean) ** 2 / svar_tot
    lnorm = torch.log(2.0 * math.pi * svar_tot)
    return torch.where(ok, -0.5 * (chi2 + lnorm), torch.zeros_like(scales))


def logn_disk(R, Z, R_solar=8.2, Z_solar=0.025, R_scale=2.6, Z_scale=0.3,
              R_smooth=2.0):
    """Exponential disk log-number-density, normalized at the Sun
    (reference `brutus/pdf.py:263-307`)."""
    Reff = torch.sqrt(R ** 2 + R_smooth ** 2)
    return -((Reff - R_solar) / R_scale
             + (torch.abs(Z) - abs(Z_solar)) / Z_scale)


def logn_halo(R, Z, R_solar=8.2, Z_solar=0.025, R_smooth=2.0,
              eta=4.2, q_ctr=0.2, q_inf=0.8, r_q=6.0):
    """Oblate power-law halo log-number-density, normalized at the Sun
    (reference `brutus/pdf.py:310-377`)."""
    r = torch.sqrt(R ** 2 + Z ** 2)
    rp = torch.sqrt(r ** 2 + r_q ** 2)
    q = q_inf - (q_inf - q_ctr) * torch.exp(1.0 - rp / r_q)
    Reff = torch.sqrt(R ** 2 + (Z / q) ** 2 + R_smooth ** 2)
    rp_solar = math.sqrt(R_solar ** 2 + Z_solar ** 2 + r_q ** 2)
    q_solar = q_inf - (q_inf - q_ctr) * math.exp(1.0 - rp_solar / r_q)
    Reff_solar = math.sqrt(R_solar ** 2 + (Z_solar / q_solar) ** 2
                           + R_smooth ** 2)
    return -eta * torch.log(Reff / Reff_solar)


def logp_feh(feh, feh_mean=-0.2, feh_sigma=0.3):
    """Gaussian metallicity log-prior (reference `brutus/pdf.py:380-407`)."""
    chi2 = (feh_mean - feh) ** 2 / feh_sigma ** 2
    return -0.5 * (chi2 + math.log(2.0 * math.pi * feh_sigma ** 2))


def age_prior_consts(feh_mean, max_age=13.8, min_age=0.0,
                     feh_age_ctr=-0.5, feh_age_scale=0.5,
                     nsigma_from_max_age=2.0, max_sigma=4.0,
                     min_sigma=1.0):
    """`(age_mean, age_sigma, a, b)` of the truncated-normal age prior
    of one Galactic component (reference `brutus/pdf.py:410-473`)."""
    age_mean = ((max_age - min_age)
                / (1.0 + math.exp((feh_mean - feh_age_ctr)
                                  / feh_age_scale)) + min_age)
    age_sigma = (max_age - age_mean) / nsigma_from_max_age
    age_sigma = min(max(age_sigma, min_sigma), max_sigma)
    a = (min_age - age_mean) / age_sigma
    b = (max_age - age_mean) / age_sigma
    return age_mean, age_sigma, a, b


def logp_age_from_feh(age, feh_mean=-0.2, **kw):
    """Truncated-normal age log-prior whose mean tracks metallicity
    (reference `brutus/pdf.py:410-473`)."""
    mu, sig, a, b = age_prior_consts(feh_mean, **kw)
    return truncnorm_logpdf(age, a, b, loc=mu, scale=sig)


def gal_lnprior(dists, coord, feh=None, loga=None,
                cfg: GalPriorConfig = GalPriorConfig(),
                return_components=False):
    """Galactic 3-D prior (thin + thick disk + halo) with optional
    metallicity and age mixtures (reference `brutus/pdf.py:476-749`).

    dists : (...,) or (B, K) kpc; coord : (2,) or per-star (B, 2)
    galactic `(l, b)` degrees; feh, loga : optional model labels
    broadcastable to `dists`.  With `return_components` it returns
    `(lnprior, components)` as `brutus_tpu.priors.gal_lnprior` does:
    `number_density` the thin, thick and halo terms, and `feh` and
    `age` the mixtures when those labels are given.
    """
    vol_factor = 2.0 * torch.log(dists + 1e-300)
    coord = torch.as_tensor(coord, dtype=dists.dtype, device=dists.device)
    l, b = coord[..., 0], coord[..., 1]
    if l.dim():                  # per-star coords (B, 2) vs dists (B, K)
        l, b = l[..., None], b[..., None]
    R, Z = galactic_to_cylindrical(l, b, dists)
    logp_thin = logn_disk(R, Z, cfg.R_solar, cfg.Z_solar, cfg.R_thin,
                          cfg.Z_thin, cfg.Rs_thin) + vol_factor
    logp_thick = (logn_disk(R, Z, cfg.R_solar, cfg.Z_solar, cfg.R_thick,
                            cfg.Z_thick, cfg.Rs_thick)
                  + vol_factor + math.log(cfg.f_thick))
    logp_halo = (logn_halo(R, Z, cfg.R_solar, cfg.Z_solar, cfg.Rs_halo,
                           cfg.eta_halo, cfg.q_halo_ctr, cfg.q_halo_inf,
                           cfg.r_q_halo)
                 + vol_factor + math.log(cfg.f_halo))
    lnprior = torch.logsumexp(
        torch.stack([logp_thin, logp_thick, logp_halo]), dim=0)
    components = {"number_density": [logp_thin, logp_thick, logp_halo]}
    lnp = [logp_thin - lnprior, logp_thick - lnprior, logp_halo - lnprior]
    comps = [(cfg.feh_thin, cfg.feh_thin_sigma),
             (cfg.feh_thick, cfg.feh_thick_sigma),
             (cfg.feh_halo, cfg.feh_halo_sigma)]
    if feh is not None:
        feh_mix = torch.logsumexp(torch.stack(
            [logp_feh(feh, mu, sig) + w
             for (mu, sig), w in zip(comps, lnp)]), dim=0)
        lnprior = lnprior + feh_mix
        components["feh"] = feh_mix
    if loga is not None:
        age = 10 ** loga / 1e9
        kw = dict(max_age=cfg.max_age, min_age=cfg.min_age,
                  feh_age_ctr=cfg.feh_age_ctr,
                  feh_age_scale=cfg.feh_age_scale,
                  nsigma_from_max_age=cfg.nsigma_from_max_age,
                  max_sigma=cfg.max_sigma, min_sigma=cfg.min_sigma)
        age_mix = torch.logsumexp(torch.stack(
            [logp_age_from_feh(age, feh_mean=mu, **kw) + w
             for (mu, _), w in zip(comps, lnp)]), dim=0)
        lnprior = lnprior + age_mix
        components["age"] = age_mix
    if return_components:
        return lnprior, components
    return lnprior


def dust_lnprior(dists, avs, av_dist, av_mean, av_std,
                 cfg: DustPriorConfig = DustPriorConfig()):
    """Gaussian A(V) log-prior from a line-of-sight profile on a
    UNIFORM distance ladder (reference `brutus/pdf.py:752-840`).

    The profile is linearly interpolated at `dists` (clamped to the
    ladder's ends, as `np.interp`); an uncovered sightline (NaN profile)
    gives a flat prior.  av_dist : (Ndist,); av_mean, av_std :
    (Ndist,), or per-star (B, Ndist) against (B, K) `dists`.
    """
    covered = torch.all(torch.isfinite(av_mean) & torch.isfinite(av_std),
                        dim=-1, keepdim=True)
    safe_mean = torch.where(torch.isfinite(av_mean), av_mean,
                            torch.zeros_like(av_mean))
    safe_std = torch.where(torch.isfinite(av_std), av_std,
                           torch.ones_like(av_std))
    n = av_dist.shape[0]
    d0 = av_dist[0]
    dx = av_dist[1] - av_dist[0]
    u = torch.clamp((dists - d0) / dx, 0.0, n - 1.0)
    lo = torch.clamp(torch.floor(u), max=n - 1).long()
    hi = torch.clamp(lo + 1, max=n - 1)
    # The two hat weights max(0, 1 - |u - l|) that can be non-zero.
    w_lo = torch.clamp(1.0 - torch.abs(u - lo.to(u.dtype)), min=0.0)
    w_hi = torch.where(hi > lo,
                       torch.clamp(1.0 - torch.abs(u - hi.to(u.dtype)),
                                   min=0.0), torch.zeros_like(u))
    take = ((lambda t, i: t[i]) if av_mean.dim() == 1
            else (lambda t, i: torch.gather(t, -1, i)))
    mean_i = w_lo * take(safe_mean, lo) + w_hi * take(safe_mean, hi)
    std_i = w_lo * take(safe_std, lo) + w_hi * take(safe_std, hi)
    mean_d = cfg.scale * mean_i + cfg.offset
    err_d = cfg.smooth * cfg.scale * std_i
    err_d = torch.sqrt(err_d ** 2 + cfg.scatter ** 2)
    chi2 = (avs - mean_d) ** 2 / err_d ** 2
    lnorm = torch.log(2.0 * math.pi * err_d ** 2)
    return torch.where(covered, -0.5 * (chi2 + lnorm),
                       torch.zeros_like(avs))


def dust_lnprior_interp(dists, avs, av_dist, av_mean, av_std,
                        cfg: DustPriorConfig = DustPriorConfig()):
    """`dust_lnprior` on any ascending distance ladder, by `np.interp`'s
    piecewise-linear interpolation (mirrors `priors.dust_lnprior_interp`).
    av_dist, av_mean, av_std : (Ndist,)."""
    covered = torch.all(torch.isfinite(av_mean) & torch.isfinite(av_std))
    safe_mean = torch.where(torch.isfinite(av_mean), av_mean,
                            torch.zeros_like(av_mean))
    safe_std = torch.where(torch.isfinite(av_std), av_std,
                           torch.ones_like(av_std))
    mean_d = cfg.scale * _interp(dists, av_dist, safe_mean) + cfg.offset
    err_d = cfg.smooth * cfg.scale * _interp(dists, av_dist, safe_std)
    err_d = torch.sqrt(err_d ** 2 + cfg.scatter ** 2)
    chi2 = (avs - mean_d) ** 2 / err_d ** 2
    lnorm = torch.log(2.0 * math.pi * err_d ** 2)
    return torch.where(covered, -0.5 * (chi2 + lnorm),
                       torch.zeros_like(avs))


__all__ = [
    "imf_lnprior", "ps1_MrLF_lnprior", "parallax_lnprior",
    "parallax_to_scale", "scale_parallax_lnprior", "logn_disk",
    "logn_halo", "logp_feh", "logp_age_from_feh", "gal_lnprior",
    "dust_lnprior", "dust_lnprior_interp",
]
