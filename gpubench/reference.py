"""Plain reference of what `BruteForce.fit` returns for a star, in
PyTorch, independent of the program (it imports nothing of it).

The semantics are brutus's (Speagle et al. 2025; `brutus/fitting.py`,
`brutus/pdf.py`) as the repository's JAX package states them:

- the fit of one grid model to one star: flux-space chi-square over
  the usable bands, the flux scale `s` (1 / d**2, d in kpc) in closed
  form at each `(Av, Rv)`, a Gaussian prior on Rv (and an all but flat
  one on Av), `Av` and `Rv` held in their limits;
- the covariance of `(s, Av, Rv)`: the inverse of the fit's precision
  parts (with the regularisation of the MLE re-expansion), repaired
  toward positive definiteness by brutus's escalating diagonal prior;
- the log-likelihood with the chi-square dimensionality prior
  (`ndim - 3` degrees of freedom);
- the grid prior (Kroupa IMF over `mini`, grid-spacing weights of the
  grid's input labels), the Galactic prior (thin and thick disk and
  halo, metallicity and age mixtures; astropy's Galactocentric frame),
  the dust prior on the map's profile resampled to a uniform ladder of
  128 distances (as the JAX package resamples it), and the parallax
  prior;
- a drawn model's log-posterior: its log-likelihood and grid prior plus
  the log of the mean of exp(priors) over draws of `(s, Av, Rv)` from
  its Gaussian within the limits.

`Fit` and `rnd` take a `prec`: `"f64"` computes in float64 (the
reference), `"tf32"` in float32 with every input rounded to TF32's
10-bit mantissa (the control, the step below the float32 the
configurations state).
"""

import math

import numpy as np
import torch

LN10 = math.log(10.0)
FLUXFAC = -0.4 * LN10
NEG_BIG = -1e30

# brutus's fit defaults that `BruteForce.fit` does not take as keywords
# (`brutus/fitting.py`): the MLE re-expansion's regularisation and the
# PSD repair.
AV_REG, RV_REG = 0.05, 0.1
PSD_WIDTH, PSD_PASSES, MVN_EPS = 0.02, 8, 1e-30
SCALE_MIN = 1e-20
DUST_RUNGS = 128

# astropy v4+ Galactocentric frame (J2000 pole and node, Sgr A*,
# R_sun 8.122 kpc, z_sun 20.8 pc, roll 58.5986320306 deg).
_NGP_RA, _NGP_DEC, _LON0 = 192.8594812065348, 27.12825118085622, \
    122.9319185680026
_GC_RA, _GC_DEC, _GC_DIST, _Z_SUN, _ROLL = 266.4051, -28.936175, 8.122, \
    20.8e-3, 58.5986320306

# brutus's Galactic prior (`brutus/pdf.py:476-749` defaults).
GAL = dict(R_solar=8.2, Z_solar=0.025, R_thin=2.6, Z_thin=0.3,
           Rs_thin=2.0, R_thick=2.0, Z_thick=0.9, f_thick=0.04,
           Rs_thick=2.0, Rs_halo=2.0, q_halo_ctr=0.2, q_halo_inf=0.8,
           r_q_halo=6.0, eta_halo=4.2, f_halo=0.005,
           feh=((-0.2, 0.3), (-0.7, 0.4), (-1.6, 0.5)), max_age=13.8,
           min_age=0.0, feh_age_ctr=-0.5, feh_age_scale=0.5,
           nsigma_from_max_age=2.0, max_sigma=4.0, min_sigma=1.0)
DUST_SCATTER = 0.2


def _f64(x, device=None):
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, float), device=device)


def rnd(x, prec, device=None):
    """`x` as a tensor of the precision's type; TF32 keeps 10 mantissa
    bits (rounded to nearest, ties to even)."""
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                        device=device)
    if prec == "f64":
        return t.to(torch.float64)
    t = t.to(torch.float32).contiguous()
    bits = t.view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


# --------------------------------------------------------------------------
# The fit of one model to one star
# --------------------------------------------------------------------------

class Fit:
    """Per (star, model) pair: coefficients `coef (n, F, 3)`, fluxes,
    errors and mask `(n, F)`, in precision `prec`.  `fit` is a dict of
    the fit settings (`avlim`, `rvlim`, `rv_gauss`, `av_gauss`)."""

    def __init__(self, coef, flux, err, mask, fit, prec="f64",
                 device=None):
        self.prec = prec
        self.dt = torch.float64 if prec == "f64" else torch.float32
        self.dev = device
        mask = torch.as_tensor(mask, device=device)
        self.c0, self.c1, self.c2 = (rnd(coef[..., k], prec, device)
                                     for k in range(3))
        f = rnd(torch.nan_to_num(_f64(flux, device)), prec, device)
        e = rnd(torch.nan_to_num(_f64(err, device), nan=1.0), prec,
                device)
        self.flux = torch.where(mask, f, torch.zeros_like(f))
        self.w = torch.where(mask, 1.0 / (e * e), torch.zeros_like(e))
        self.var = torch.where(mask, e * e, torch.ones_like(e))
        self.mask = mask
        self.ndim = mask.sum(-1)
        self.avlim, self.rvlim = fit["avlim"], fit["rvlim"]
        av_g = fit.get("av_gauss") or (0.0, 1e6)
        self.avm, self.avvi = av_g[0], 1.0 / av_g[1] ** 2
        self.rvm, self.rvvi = fit["rv_gauss"][0], \
            1.0 / fit["rv_gauss"][1] ** 2

    def chi2(self, s, av, rv):
        """Flux-space chi-square of the model at `(s, av, rv)`."""
        m = torch.exp(FLUXFAC * (self.c0 + av[:, None] * (
            self.c1 + rv[:, None] * self.c2)))
        r = self.flux - s[:, None] * m
        return (r * r * self.w).sum(-1)

    def brutus_fit(self, mag_iters=6, flux_iters=6):
        """brutus's fit with the fused engines' fixed budgets (the JAX
        package's fit kernel, `kernel_mag_iters`, `kernel_flux_iters`):
        a direct weighted least-squares seed of `(mu, Av, Av Rv)` in
        magnitudes, `mag_iters` alternating clamped Av and Rv solves in
        magnitude space, then `flux_iters` damped flux-space steps along
        the reddening vectors (Av, and Rv x Av), the step shrunk by 1.2
        after a step that lowers the likelihood (a model the initial
        threshold does not freeze).  Returns `(s, av, rv)`."""
        fl, var, mask = self.flux, self.var, self.mask
        pos = mask & (fl > 0)
        one = torch.ones_like(fl)
        sf = torch.where(pos, fl, one)
        mags = torch.where(pos, -2.5 * torch.log10(sf), torch.zeros_like(fl))
        wtm = torch.where(mask, torch.where(
            pos, 1.0 / ((2.5 / LN10) ** 2 * var / (sf * sf)), one / 1e30),
            torch.zeros_like(fl))
        c0, r0, dr = self.c0, self.c1, self.c2
        avm, avvi, rvm, rvvi = self.avm, self.avvi, self.rvm, self.rvvi
        (avmin, avmax), (rvmin, rvmax) = self.avlim, self.rvlim
        S = lambda x: x.sum(-1)
        res0 = mags - c0
        a00, a01, a02 = S(wtm), S(r0 * wtm), S(dr * wtm)
        a11, a12, a22 = S(r0 * r0 * wtm) + avvi, S(r0 * dr * wtm), \
            S(dr * dr * wtm)
        b0, b1, b2 = S(res0 * wtm), S(res0 * r0 * wtm) + avm * avvi, \
            S(res0 * dr * wtm)
        det = (a00 * (a11 * a22 - a12 * a12) - a01 * (a01 * a22 - a12 * a02)
               + a02 * (a01 * a12 - a11 * a02))
        det1 = (a00 * (b1 * a22 - a12 * b2) - b0 * (a01 * a22 - a12 * a02)
                + a02 * (a01 * b2 - b1 * a02))
        det2 = (a00 * (a11 * b2 - b1 * a12) - a01 * (a01 * b2 - b1 * a02)
                + b0 * (a01 * a12 - a11 * a02))
        det = torch.where(det.abs() > 1e-30, det, torch.ones_like(det))
        av = torch.clamp(det1 / det, avmin, avmax)
        ok = av.abs() > 1e-10
        rv = torch.where(ok, det2 / det / torch.where(ok, av, torch.ones_like(
            av)), torch.full_like(av, rvm)).clamp(rvmin, rvmax)
        rvec = r0 + rv[:, None] * dr
        res = mags - (c0 + av[:, None] * rvec)
        sm, rp_den, srp = S(wtm), S(dr * dr * wtm), S(dr * wtm)
        for _ in range(mag_iters):
            a_den = S(rvec * rvec * wtm) + avvi
            sa, rs = S(rvec * wtm), S(res * wtm)
            ra = S(res * rvec * wtm) + (avm - av) * avvi
            dav = ((sm * ra - sa * rs) / (sm * a_den - sa * sa))
            dav = torch.minimum(torch.maximum(dav, avmin - av), avmax - av)
            av = av + dav
            res = res - dav[:, None] * rvec
            r_den = rp_den * av * av + rvvi
            sr, rs = srp * av, S(res * wtm)
            rr = av * S(res * dr * wtm) + (rvm - rv) * rvvi
            drv = (sm * rr - sr * rs) / (sm * r_den - sr * sr)
            drv = torch.minimum(torch.maximum(drv, rvmin - rv), rvmax - rv)
            rv = rv + drv
            res = res - (av * drv)[:, None] * dr
            rvec = rvec + drv[:, None] * dr
        w = self.w

        def mle(av, rv):
            rvm_ = r0 + rv[:, None] * dr
            m = torch.exp(FLUXFAC * c0) * torch.exp(FLUXFAC * av[:, None]
                                                    * rvm_)
            s = torch.clamp(S(m * fl * w) / torch.clamp(S(m * m * w),
                                                        min=1e-30),
                            min=SCALE_MIN)
            return (FLUXFAC * m * rvm_ * s[:, None],
                    FLUXFAC * m * dr * s[:, None], s, fl - m * s[:, None])

        rvecs, drvecs, s, resf = mle(av, rv)
        lnl_old = -0.5 * S(resf * resf * w)
        step = torch.ones_like(av)
        for _ in range(flux_iters):
            dav = step * (S(rvecs * resf * w) + (avm - av) * avvi) / (
                S(rvecs * rvecs * w) + avvi)
            drv = step * (S(drvecs * resf * w) + (rvm - rv) * rvvi) / (
                S(drvecs * drvecs * w) + rvvi)
            av = av + torch.minimum(torch.maximum(dav, avmin - av),
                                    avmax - av)
            rv = rv + torch.minimum(torch.maximum(drv, rvmin - rv),
                                    rvmax - rv)
            rvecs, drvecs, s, resf = mle(av, rv)
            lnl = -0.5 * S(resf * resf * w)
            step = torch.where(lnl < lnl_old, step / 1.2, step)
            lnl_old = lnl
        return s, av, rv

    def precision(self, av, rv):
        """The fit's precision parts `(i00, i11, i22, i01, i02, i12)` of
        `(s, Av, Rv)` at `(av, rv)`, the scale profiled (brutus's MLE
        re-expansion, with its regularisation)."""
        m_int = torch.exp(FLUXFAC * self.c0)
        rvec_m = self.c1 + rv[:, None] * self.c2
        m = m_int * torch.exp(FLUXFAC * av[:, None] * rvec_m)
        rvec = FLUXFAC * m * rvec_m
        drvec = FLUXFAC * m * self.c2
        w, fl = self.w, self.flux
        s_den = torch.clamp((m * m * w).sum(-1), min=1e-30)
        s = torch.clamp((m * fl * w).sum(-1) / s_den, min=SCALE_MIN)
        ms = m * s[:, None]
        resid = fl - ms
        red_s = (m - m_int) * s[:, None]
        t = ms - resid
        sa = (rvec * t * w).sum(-1)
        sr = (drvec * t * w).sum(-1)
        rvec_s, drvec_s = rvec * s[:, None], drvec * s[:, None]
        ar = (drvec_s * (red_s - resid) * w).sum(-1)
        a_den = (rvec_s * rvec_s * w).sum(-1) + self.avvi + 1.0 / AV_REG ** 2
        r_den = (drvec_s * drvec_s * w).sum(-1) + self.rvvi \
            + 1.0 / RV_REG ** 2
        return s_den, a_den, r_den, sa, sr, ar

    def lnlike(self, chi2):
        """Log-likelihood with the chi-square dimensionality prior."""
        half = (self.ndim.to(self.dt) - 3.0) / 2.0
        return (-(half * math.log(2.0) + torch.lgamma(half))
                + (half - 1.0) * torch.log(chi2) - chi2 / 2.0)


def _sym(p):
    p00, p11, p22, p01, p02, p12 = p
    return torch.stack([torch.stack([p00, p01, p02], -1),
                        torch.stack([p01, p11, p12], -1),
                        torch.stack([p02, p12, p22], -1)], -2)


def _pd(C):
    """Positive definite, by Sylvester's minors of the matrix scaled to
    a unit diagonal."""
    d = torch.sqrt(torch.clamp(C.diagonal(dim1=-2, dim2=-1).abs(),
                               min=1e-300 if C.dtype == torch.float64
                               else 1e-30))
    A = C / d[..., :, None] / d[..., None, :]
    m2 = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] ** 2
    return (A[..., 0, 0] > 0) & (m2 > 0) & (torch.linalg.det(A) > 0)


def covariance(parts, scale):
    """Covariance of `(s, Av, Rv)` from precision parts: the inverse,
    and where it is not positive definite brutus's escalating diagonal
    prior on the precision (width 0.02 of the scale and of Av, Rv),
    then a positive diagonal; plus the Cholesky jitter."""
    P = _sym(parts)
    C = torch.linalg.inv(P)
    sfrac = scale * PSD_WIDTH
    eye = torch.eye(3, dtype=P.dtype, device=P.device)
    for i in range(PSD_PASSES):
        bad = ~_pd(C)
        if not bool(bad.any()):
            break
        d = C.diagonal(dim1=-2, dim2=-1) <= 0
        f = lambda x: x.to(P.dtype)
        s = torch.stack([f(d[:, 0]) + f(~(d[:, 1] | d[:, 2])),
                         f(d[:, 1]) + f(~(d[:, 0] | d[:, 2])),
                         f(d[:, 2]) + f(~(d[:, 0] | d[:, 1]))], -1)
        add = 2.0 ** i * s / torch.stack(
            [sfrac ** 2, torch.full_like(sfrac, PSD_WIDTH ** 2),
             torch.full_like(sfrac, PSD_WIDTH ** 2)], -1)
        P = torch.where(bad[:, None, None], P + eye * add[:, None, :], P)
        C = torch.where(bad[:, None, None], torch.linalg.inv(P), C)
    bad = ~_pd(C)
    if bool(bad.any()):
        diag = C.diagonal(dim1=-2, dim2=-1)
        floor = torch.stack([torch.clamp(sfrac ** 2, min=1e-30),
                             torch.full_like(sfrac, PSD_WIDTH ** 2),
                             torch.full_like(sfrac, PSD_WIDTH ** 2)], -1)
        diag = torch.where((diag > 0) & torch.isfinite(diag), diag, floor)
        C = torch.where(bad[:, None, None], torch.diag_embed(diag), C)
    return C + eye * MVN_EPS


# --------------------------------------------------------------------------
# Priors
# --------------------------------------------------------------------------

def _rot(a, axis):
    a = math.radians(a)
    c, s = math.cos(a), math.sin(a)
    return {"x": np.array([[1, 0, 0], [0, c, s], [0, -s, c]]),
            "y": np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]]),
            "z": np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])}[axis]


def galactocentric_affine():
    """`(M, t)`: Galactic cartesian (kpc) to Galactocentric, `M x + t`,
    in astropy's frame."""
    icrs_to_gal = (_rot(180.0 - _LON0, "z") @ _rot(90.0 - _NGP_DEC, "y")
                   @ _rot(_NGP_RA, "z"))
    R = _rot(_ROLL, "x") @ _rot(-_GC_DEC, "y") @ _rot(_GC_RA, "z")
    H = _rot(math.degrees(-math.asin(_Z_SUN / _GC_DIST)), "y")
    return H @ R @ icrs_to_gal.T, -H @ np.array([_GC_DIST, 0.0, 0.0])


def gal_lnprior(dist, l, b, feh, loga):
    """brutus's Galactic prior at distances `dist` (kpc) toward `(l, b)`
    (degrees) of models with labels `feh`, `loga` (all broadcast)."""
    g = GAL
    M, t = galactocentric_affine()
    dt = dist.dtype
    M = torch.as_tensor(M, dtype=dt, device=dist.device)
    lr, br = torch.deg2rad(l), torch.deg2rad(b)
    u = torch.stack([torch.cos(br) * torch.cos(lr),
                     torch.cos(br) * torch.sin(lr), torch.sin(br)], -1)
    x = [dist * (u * M[i]).sum(-1) + float(t[i]) for i in range(3)]
    R = torch.sqrt(x[0] ** 2 + x[1] ** 2)
    Z = x[2]
    vol = 2.0 * torch.log(dist)

    def disk(Rs, Zs, Rsm):
        return -((torch.sqrt(R ** 2 + Rsm ** 2) - g["R_solar"]) / Rs
                 + (torch.abs(Z) - abs(g["Z_solar"])) / Zs)

    r = torch.sqrt(R ** 2 + Z ** 2)
    rp = torch.sqrt(r ** 2 + g["r_q_halo"] ** 2)
    q = g["q_halo_inf"] - (g["q_halo_inf"] - g["q_halo_ctr"]) * torch.exp(
        1.0 - rp / g["r_q_halo"])
    reff = torch.sqrt(R ** 2 + (Z / q) ** 2 + g["Rs_halo"] ** 2)
    rp_sol = math.sqrt(g["R_solar"] ** 2 + g["Z_solar"] ** 2
                       + g["r_q_halo"] ** 2)
    q_sol = g["q_halo_inf"] - (g["q_halo_inf"] - g["q_halo_ctr"]) * math.exp(
        1.0 - rp_sol / g["r_q_halo"])
    reff_sol = math.sqrt(g["R_solar"] ** 2 + (g["Z_solar"] / q_sol) ** 2
                         + g["Rs_halo"] ** 2)
    comp = torch.stack([
        disk(g["R_thin"], g["Z_thin"], g["Rs_thin"]) + vol,
        disk(g["R_thick"], g["Z_thick"], g["Rs_thick"]) + vol
        + math.log(g["f_thick"]),
        -g["eta_halo"] * torch.log(reff / reff_sol) + vol
        + math.log(g["f_halo"])])
    lnp = torch.logsumexp(comp, 0)
    w = comp - lnp
    feh_t = torch.stack([-0.5 * ((mu - feh) ** 2 / sig ** 2
                                 + math.log(2 * math.pi * sig ** 2))
                         for mu, sig in g["feh"]])
    lnp = lnp + torch.logsumexp(feh_t + w, 0)
    age = 10.0 ** loga / 1e9
    age_t = []
    for mu_f, _ in g["feh"]:
        mu = ((g["max_age"] - g["min_age"])
              / (1.0 + math.exp((mu_f - g["feh_age_ctr"])
                                / g["feh_age_scale"])) + g["min_age"])
        sig = min(max((g["max_age"] - mu) / g["nsigma_from_max_age"],
                      g["min_sigma"]), g["max_sigma"])
        a, bb = (g["min_age"] - mu) / sig, (g["max_age"] - mu) / sig
        norm = math.log(sig / 2.0) + math.log(
            math.erf(bb / math.sqrt(2)) - math.erf(a / math.sqrt(2)))
        xi = (age - mu) / sig
        v = -0.5 * math.log(2 * math.pi) - 0.5 * xi * xi - norm
        age_t.append(torch.where((age < g["min_age"]) | (age > g["max_age"]),
                                 torch.full_like(v, NEG_BIG), v))
    return lnp + torch.logsumexp(torch.stack(age_t) + w, 0)


def uniform_ladder(dists, av_mean, av_std):
    """The map's profiles resampled on `DUST_RUNGS` distances uniform
    between its first and last distance, by linear interpolation."""
    du = np.linspace(dists[0], dists[-1], DUST_RUNGS)
    interp = lambda a: np.stack([np.interp(du, dists, r) for r in
                                 np.atleast_2d(a)])
    return du, interp(av_mean), interp(av_std)


def dust_lnprior(dist, av, ladder, mean, std):
    """Gaussian A(V) prior at `(dist, av)` `(n, k)` on each star's
    uniform ladder `mean`, `std` `(n, R)` (linear interpolation, held at
    the ends), with brutus's scatter 0.2 added in quadrature."""
    d0, dx = float(ladder[0]), float(ladder[1] - ladder[0])
    R = mean.shape[-1]
    u = torch.clamp((dist - d0) / dx, 0.0, R - 1.0)
    lo = torch.clamp(torch.floor(u), max=R - 2).long()
    f = u - lo.to(u.dtype)
    at = lambda a: (1 - f) * torch.gather(a, 1, lo) + f * torch.gather(
        a, 1, lo + 1)
    m, s = at(mean), at(std)
    var = s * s + DUST_SCATTER ** 2
    return -0.5 * ((av - m) ** 2 / var + torch.log(2 * math.pi * var))


def parallax_lnprior(par, plx, plxe):
    return -0.5 * ((par - plx) ** 2 / plxe ** 2
                   + torch.log(2 * math.pi * plxe ** 2))


def grid_lnprior(labels):
    """brutus's default grid prior: the Kroupa IMF over `mini` and the
    log grid spacing of each of the grid's input labels (`mini`, `feh`)."""
    mini = np.asarray(labels["mini"], float)
    low = -1.3 * np.log(mini)
    high = -2.3 * np.log(mini) + (2.3 - 1.3) * math.log(0.5)
    lnp = np.where(mini > 0.5, high, np.where(mini > 0.08, low, -np.inf))
    norm = (0.5 ** (1 - 1.3) / (2.3 - 1.0)
            + 0.08 ** (1 - 1.3) / (1.3 - 1.0) - 0.5 ** (1 - 1.3) / (1.3 - 1.0))
    lnp = lnp - math.log(norm)
    for name in ("mini", "feh"):
        u = np.unique(labels[name])
        if len(u) > 1:
            lnp = lnp + np.interp(labels[name], u, np.log(np.gradient(u)))
    return lnp


def star_priors(dist, av, rv, s_k, star, model):
    """Log of the priors a draw `(dist, av, rv)` `(n, k)` meets (the
    draws' `logwt`): Galactic, dust and parallax; `NEG_BIG` outside the
    limits.  `star` and `model` hold per-row `(n,)` tensors."""
    lnp = gal_lnprior(dist, star["l"][:, None], star["b"][:, None],
                      model["feh"][:, None], model["loga"][:, None])
    lnp = lnp + dust_lnprior(dist, av, star["ladder"], star["mean"],
                             star["std"])
    lnp = lnp + parallax_lnprior(1.0 / dist, star["plx"][:, None],
                                 star["plxe"][:, None])
    inb = ((s_k >= SCALE_MIN) & (av >= star["avlim"][0])
           & (av <= star["avlim"][1]) & (rv >= star["rvlim"][0])
           & (rv <= star["rvlim"][1]))
    return torch.where(inb & torch.isfinite(lnp), lnp,
                       torch.full_like(lnp, NEG_BIG)), inb


def scale_parallax_lnprior(s, s_err, plx, plxe, snr_lim=4.0):
    """brutus's parallax prior on flux scales `s ~ p**2`, uniform where
    the parallax's SNR is at most `snr_lim` (`brutus/pdf.py:178-260`)."""
    ok = (plxe > 0) & (plx / plxe > snr_lim)
    pm = torch.clamp(torch.where(ok, plx, torch.ones_like(plx)), min=0.0)
    pe = torch.where(ok, plxe, torch.ones_like(plxe))
    var = 2 * pe ** 4 + 4 * pm ** 2 * pe ** 2 + s_err ** 2
    lnp = -0.5 * ((s - pm ** 2 - pe ** 2) ** 2 / var
                  + torch.log(2 * math.pi * var))
    return torch.where(ok, lnp, torch.zeros_like(lnp))


# --------------------------------------------------------------------------
# The fit's objective and its converged minimum
# --------------------------------------------------------------------------

def objective(F, s, av, rv):
    """What brutus's fit minimises: the flux chi-square plus the Gaussian
    Av and Rv priors' terms."""
    return (F.chi2(s, av, rv) + (av - F.avm) ** 2 * F.avvi
            + (rv - F.rvm) ** 2 * F.rvvi)


def converged(F, starts, iters=60):
    """The least `objective` over `(s, Av, Rv)` within the limits, by
    Levenberg-Marquardt steps from each `(s, av, rv)` of `starts` (only
    steps that lower it are taken, so it never exceeds a start's)."""
    (avmin, avmax), (rvmin, rvmax) = F.avlim, F.rvlim
    best = None
    for s, av, rv in starts:
        s, av, rv = s.clone(), av.clone(), rv.clone()
        J = objective(F, s, av, rv)
        lam = torch.full_like(J, 1e-3)
        for _ in range(iters):
            rvec = F.c1 + rv[:, None] * F.c2
            m = torch.exp(FLUXFAC * (F.c0 + av[:, None] * rvec))
            r = F.flux - s[:, None] * m
            g = torch.stack([m, FLUXFAC * s[:, None] * m * rvec,
                             FLUXFAC * s[:, None] * m * av[:, None] * F.c2],
                            -1)
            H = torch.einsum("nf,nfi,nfj->nij", F.w, g, g)
            b = torch.einsum("nf,nfi,nf->ni", F.w, g, r)
            H[:, 1, 1] += F.avvi
            H[:, 2, 2] += F.rvvi
            b[:, 1] -= (av - F.avm) * F.avvi
            b[:, 2] -= (rv - F.rvm) * F.rvvi
            d = torch.diagonal(H, dim1=-2, dim2=-1)
            Hl = H + torch.diag_embed(lam[:, None] * d + 1e-300)
            step = torch.linalg.solve(Hl, b[..., None])[..., 0]
            step = torch.nan_to_num(step)
            s1 = torch.clamp(s + step[:, 0], min=SCALE_MIN)
            av1 = torch.clamp(av + step[:, 1], avmin, avmax)
            rv1 = torch.clamp(rv + step[:, 2], rvmin, rvmax)
            J1 = objective(F, s1, av1, rv1)
            ok = J1 < J
            s, av, rv = (torch.where(ok, a, b) for a, b in
                         ((s1, s), (av1, av), (rv1, rv)))
            J = torch.where(ok, J1, J)
            lam = torch.where(ok, lam / 3.0, lam * 4.0)
        best = J if best is None else torch.minimum(best, J)
    return best


# --------------------------------------------------------------------------
# The posterior of a star: screen, shortlist, fit, selection, Monte Carlo,
# evidence and draws
# --------------------------------------------------------------------------

# brutus's posterior settings that the configurations leave at their
# defaults (`brutus/fitting.py`; the fixed-size prefilter and selection
# of the fused engines, as the JAX package states them).
WT_THRESH = 1e-3
PREFILTER_K = 2048
VALID_MIN = 0.5 * NEG_BIG


class Grid:
    """The grid's coefficients `(M, F, 3)` and per-model rows (grid
    prior, feh, loga) in precision `prec` on `device`."""

    def __init__(self, mc, labels, prec, device):
        self.prec, self.dev = prec, device
        self.coef = rnd(mc, prec, device)
        self.lnprior = rnd(grid_lnprior(labels), prec, device)
        self.feh = rnd(np.asarray(labels["feh"], float), prec, device)
        self.loga = rnd(np.asarray(labels["loga"], float), prec, device)
        self.M = len(mc)


def screen_shortlist(grid, flux, err, mask, plx, plxe, fit, block, nb):
    """The funnel's shortlist of one star: every model's screening score
    (a direct weighted least-squares solve of `(mu, Av, Av Rv)` in
    magnitudes with the Av prior, Av and Rv held in their limits, mu
    solved again at them; minus half the magnitude chi-square and the
    parallax chi-square at the implied scale), the maximum of each
    `block` of models, and the models of the best `nb` blocks.  Returns
    the `(nb * block,)` model indices (past the grid on its last,
    partial block)."""
    dt = grid.coef.dtype
    f = rnd(torch.nan_to_num(_f64(flux, grid.dev)), grid.prec, grid.dev)
    e = rnd(torch.nan_to_num(_f64(err, grid.dev), nan=1.0), grid.prec,
            grid.dev)
    mask = torch.as_tensor(mask, device=grid.dev)
    pos = mask & (f > 0)
    sf = torch.where(pos, f, torch.ones_like(f))
    mags = torch.where(pos, -2.5 * torch.log10(sf), torch.zeros_like(f))
    w = torch.where(mask, torch.where(
        pos, sf * sf / ((2.5 / LN10) ** 2 * e * e),
        torch.full_like(f, 1e-30)), torch.zeros_like(f))
    c0, r0, dr = grid.coef[..., 0], grid.coef[..., 1], grid.coef[..., 2]
    av_g = fit.get("av_gauss") or (0.0, 1e6)
    avm, avvi = av_g[0], 1.0 / av_g[1] ** 2
    rvm = fit["rv_gauss"][0]
    (avmin, avmax), (rvmin, rvmax) = fit["avlim"], fit["rvlim"]
    d = mags - c0
    S = lambda x: (x * w).sum(-1)
    a00 = torch.clamp(w.sum(), min=1e-30)
    A01, A02 = S(r0), S(dr)
    A11, A12, A22 = S(r0 * r0) + avvi, S(r0 * dr), S(dr * dr)
    b0, b1, b2 = S(d), S(d * r0) + avm * avvi, S(d * dr)
    k1, k2 = A01 / a00, A02 / a00
    s11, s12, s22 = A11 - k1 * A01, A12 - k1 * A02, A22 - k2 * A02
    c1, c2 = b1 - k1 * b0, b2 - k2 * b0
    det = s11 * s22 - s12 * s12
    det = torch.where(det.abs() > 1e-30, det, torch.ones_like(det))
    av = torch.clamp((c1 * s22 - s12 * c2) / det, avmin, avmax)
    avrv = (s11 * c2 - s12 * c1) / det
    ok = av.abs() > 1e-10
    rv = torch.where(ok, avrv / torch.where(ok, av, torch.ones_like(av)),
                     torch.full_like(av, rvm)).clamp(rvmin, rvmax)
    avrv = av * rv
    u = (b0 - av * A01 - avrv * A02) / a00
    res = d - u[:, None] - av[:, None] * r0 - avrv[:, None] * dr
    chi2 = S(res * res)
    if bool(torch.isfinite(plx)) and bool(torch.isfinite(plxe)) \
            and float(plxe) > 0:
        chi2 = chi2 + (torch.exp(-0.2 * LN10 * u) - plx) ** 2 / plxe ** 2
    nblk = -(-grid.M // block)
    score = torch.full((nblk * block,), -math.inf, dtype=dt,
                       device=grid.dev)
    score[:grid.M] = -0.5 * chi2
    best = torch.topk(score.view(nblk, block).amax(1), nb).indices
    return (best[:, None] * block + torch.arange(
        block, device=grid.dev)).reshape(-1)


def _star_rows(star, i, n):
    """Star `i`'s per-star values, repeated for `n` rows."""
    return {k: (v[i:i + 1].expand(n, *v.shape[1:])
                if torch.is_tensor(v) and v.dim() else v)
            for k, v in star.items()}


def _star_rows_at(star, rows):
    """The per-star values of the stars `rows` (an index tensor)."""
    return {k: (v[rows] if torch.is_tensor(v) and v.dim() else v)
            for k, v in star.items()}


def mc_draws(s, av, rv, C, star, model, z, chunk=4096):
    """The draws `x = (s, av, rv) + L z` of each row's Gaussian `N(.,
    C)` (`z (k, 3)`, or `(n, k, 3)` of each row's own) and the priors
    each meets (`star_priors`, NEG_BIG outside the limits): returns
    `(lnp (n, k), inb (n, k), x (n, k, 3))`."""
    lnps, inbs, xs = [], [], []
    for lo in range(0, len(s), chunk):
        j = slice(lo, lo + chunk)
        L = _sqrt_psd(C[j])
        zz = z if z.dim() == 2 else z[j]
        zz = zz.to(L.dtype)
        x = torch.stack([s[j], av[j], rv[j]], -1)[:, None, :] \
            + (zz @ L.transpose(-1, -2) if zz.dim() == 3
               else torch.einsum("kc,nrc->nkr", zz, L))
        sk, ak, rk = x[..., 0], x[..., 1], x[..., 2]
        dist = 1.0 / torch.sqrt(torch.clamp(sk, min=1e-30))
        st = {k: (v[j] if torch.is_tensor(v) and v.dim() else v)
              for k, v in star.items()}
        lnp, inb = star_priors(dist, ak, rk, sk, st,
                               {k: v[j] for k, v in model.items()})
        lnps.append(lnp)
        inbs.append(inb)
        xs.append(x)
    return torch.cat(lnps), torch.cat(inbs), torch.cat(xs)


def _sqrt_psd(C):
    """A square root `L L^T = C` of symmetric matrices, negative
    eigenvalues (round-off of a singular matrix) taken as 0."""
    lam, V = torch.linalg.eigh(C)
    return V * torch.sqrt(torch.clamp(lam, min=0.0))[..., None, :]


def log_mean_exp(lnp, inb):
    """`log mean exp(lnp)` over each row's draws within the limits."""
    n = inb.sum(-1)
    return (torch.logsumexp(lnp, -1)
            - torch.log(torch.clamp(n, min=1).to(lnp.dtype))), n


def posterior(grid, stars, fit, n_mc, z=None, gen=None):
    """brutus's posterior of each star as the configuration's engine
    defines it, in the grid's precision: the candidates (the funnel's
    screened shortlist, or every model where `screen_k` is 0), each
    fitted (`Fit.brutus_fit`), the likelihood-rank prefilter, the two
    relative-weight culls, the top-`n_sel_max` selection, and the Monte
    Carlo mean of exp(priors) over `n_mc` draws of each selected model's
    Gaussian: the shared normals `z (n_mc, 3)`, or fresh ones from
    `gen` for every model.  `stars` holds per-star `flux`, `err`, `mask`
    `(n, F)` and the `star_priors` rows.  Returns one dict per star:
    the selected models' grid indices `idx (K,)`, log-posteriors `lnp`,
    fits `s, av, rv`, covariances `cov (K, 3, 3)`, the log-evidence
    `logz`, the draws' priors `lnp_mc (K, n_mc)` and limits `inb`, and
    with `gen` the draws `x (K, n_mc, 3)`."""
    prec, dev, dt = grid.prec, grid.dev, grid.coef.dtype
    block = int(fit["screen_block"])
    screen = 0 < int(fit["screen_k"]) < grid.M
    out = []
    for i in range(len(stars["flux"])):
        row = lambda k: rnd(stars[k][i:i + 1], prec, dev)
        plx, plxe = row("plx"), row("plxe")
        if screen:
            nb = max(1, min(int(fit["screen_k"]) // block,
                            -(-grid.M // block)))
            idx = screen_shortlist(grid, stars["flux"][i:i + 1],
                                   stars["err"][i:i + 1],
                                   stars["mask"][i:i + 1], plx[0], plxe[0],
                                   fit, block, nb)
        else:
            idx = torch.arange(grid.M, device=dev)
        good = idx < grid.M
        gi = torch.clamp(idx, max=grid.M - 1)
        P = len(gi)
        rep = lambda k: stars[k][i:i + 1].repeat(P, 1) if torch.is_tensor(
            stars[k]) else np.repeat(stars[k][i:i + 1], P, 0)
        F = Fit(grid.coef[gi], rep("flux"), rep("err"), rep("mask"), fit,
                prec, dev)
        s, av, rv = F.brutus_fit()
        lnl = F.lnlike(F.chi2(s, av, rv))
        parts = F.precision(av, rv)
        lnprob = lnl + scale_parallax_lnprior(
            s, 1.0 / torch.sqrt(parts[0].abs()), plx, plxe)
        lnprob = torch.where(good & torch.isfinite(lnprob), lnprob,
                             torch.full_like(lnprob, NEG_BIG))
        lmax = lnprob.max()
        if PREFILTER_K < P:        # on the max-shifted key in bfloat16
            key = torch.clamp(lnprob - lmax, min=-3e4).to(
                torch.bfloat16).to(dt)
            pre = torch.sort(key, descending=True, stable=True).indices[
                :PREFILTER_K]
            K = min(int(fit["n_sel_max"]), PREFILTER_K)
        else:
            pre = torch.arange(P, device=dev)
            K = min(int(fit["n_sel_max"]), P)
        take = lambda x: x[pre]
        gi, lnprob, lnl, s, av, rv = map(take, (gi, lnprob, lnl, s, av, rv))
        parts = tuple(map(take, parts))
        mask1 = lnprob > max(float(lmax) + math.log(WT_THRESH), VALID_MIN)
        st = _star_rows(stars, i, len(gi))
        dist = 1.0 / torch.sqrt(torch.clamp(s, min=1e-30))
        lnp_mle = (lnl + grid.lnprior[gi]
                   + gal_lnprior(dist, st["l"], st["b"], grid.feh[gi],
                                 grid.loga[gi])
                   + dust_lnprior(dist[:, None], av[:, None], st["ladder"],
                                  st["mean"], st["std"])[:, 0])
        ok = mask1 & torch.isfinite(lnp_mle) & (lnp_mle > VALID_MIN)
        lnp_mle = torch.where(ok, lnp_mle, torch.full_like(lnp_mle,
                                                           -math.inf))
        mask2 = ok & (lnp_mle > max(float(lnp_mle.max())
                                    + math.log(WT_THRESH), VALID_MIN))
        score = torch.where(mask2, lnl + grid.lnprior[gi],
                            torch.full_like(lnl, -math.inf))
        if K < len(gi):
            sel = torch.sort(score, descending=True, stable=True).indices[:K]
        else:
            sel = torch.arange(len(gi), device=dev)
        sel = sel[torch.isfinite(score[sel]) & (score[sel] > VALID_MIN)]
        take = lambda x: x[sel]
        gi, score, s, av, rv = map(take, (gi, score, s, av, rv))
        parts = tuple(map(take, parts))
        C = covariance(parts, s)
        repaired = ~_pd(torch.linalg.inv(_sym(parts)))
        st = _star_rows(stars, i, len(gi))
        model = dict(feh=grid.feh[gi], loga=grid.loga[gi])
        zz = z if gen is None else torch.randn(
            (len(gi), n_mc, 3), generator=gen, dtype=torch.float64).to(dev)
        lnp_mc, inb, x = mc_draws(s, av, rv, C, st, model, zz)
        term, n_in = log_mean_exp(lnp_mc, inb)
        lnp = score + term
        keep = (n_in > 0) & torch.isfinite(lnp) & (lnp > VALID_MIN)
        rec = dict(idx=gi, lnp=torch.where(keep, lnp, torch.full_like(
            lnp, NEG_BIG)), s=s, av=av, rv=rv, cov=C, keep=keep,
            score=score, lnp_mc=lnp_mc, inb=inb, repaired=repaired)
        rec["logz"] = torch.logsumexp(rec["lnp"][keep], 0) if bool(
            keep.any()) else torch.tensor(NEG_BIG, device=dev)
        if gen is not None:
            rec["x"] = x
        out.append(rec)
    return out


def draw(post, n_draws, gen):
    """brutus's draws from each star's posterior (the fit's outputs):
    `n_draws` models by inverse CDF on the posterior weights, and for
    each, one of its Monte Carlo draws picked by its priors (the Gumbel
    maximum of their logs).  Returns per star a dict of numpy arrays as
    `BruteForce.fit` returns them."""
    out = []
    for p in post:
        K, n_mc = p["lnp_mc"].shape
        dev = p["lnp"].device
        u = torch.rand(n_draws, generator=gen, dtype=torch.float64).to(dev)
        cdf = torch.cumsum(torch.softmax(p["lnp"].double(), 0), 0)
        k = torch.clamp(torch.searchsorted(cdf, u * cdf[-1]), 0, K - 1)
        g = -torch.log(-torch.log(torch.rand(
            (n_draws, n_mc), generator=gen, dtype=torch.float64).clamp(
                1e-300, 1.0))).to(dev)
        lr = p["lnp_mc"][k].double()
        j = torch.argmax(lr + g, 1)
        x = p["x"][k, j].double()
        npy = lambda t: t.detach().double().cpu().numpy()
        out.append(dict(
            model_idx=npy(p["idx"][k]).astype(np.int64),
            scale=npy(p["s"][k]), av=npy(p["av"][k]), rv=npy(p["rv"][k]),
            cov_sar=npy(p["cov"][k]), lnprob=npy(p["lnp"][k]),
            dist=npy(1.0 / torch.sqrt(torch.clamp(x[:, 0], min=1e-30))),
            red=npy(x[:, 1]), dred=npy(x[:, 2]),
            logwt=npy(lr[torch.arange(n_draws, device=dev), j]),
            log_evidence=float(p["logz"])))
    return out
