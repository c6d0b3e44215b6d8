"""
Per-star x per-model optimisation of `(s, Av, Rv)` and the grid
log-likelihood with the reference's semantics (mirrors
`brutus_tpu/ops/optimize.py`; reference `brutus/fitting.py:34-820`).

This is the reference-semantics engine: magnitude-space alternating
solves and a damped flux-space polish, each iterated until its
tolerance holds on the star's good models (`FitConfig.mtol`, `ltol`),
where the fit kernel (K1) runs fixed budgets.  The JAX package writes it
in plain XLA (`lax.while_loop` and `@` over the filter axis, no Pallas);
here it is plain PyTorch.

Every function takes a leading star axis: star-side arrays are
`(B, F)`, per-model state `(B, M)`, and the coefficients either one grid
`(M, F, 3)` shared by every star or per-star shortlists
`(B, M, F, 3)`.  The JAX package runs one star and `vmap`s it; its
`lax.while_loop`s then run while any star is unfinished and freeze the
finished ones, which the loops below do with a per-star `active` mask
(one host sync per iteration), so every star takes the iterations and
reaches the values it would alone.  `loglike_grid`, `optimize_mag` and
`sed_mle` also take one star without the leading axis, as the JAX
functions do.  The filter-axis sums run at full float32 precision (TF32
off), as the JAX package traces them at `default_matmul_precision(
"highest")`, and in the coefficients' dtype.

`loglike_grid` also runs on one shard of a grid sharded over a mesh's
`model` axis (`model_group`), as the JAX package's dense reference
engine runs under GSPMD: every per-star reduction over the models (the
convergence tests' maxima, the init cull's best) is taken over the
whole grid by an all-reduce MAX, and `polish_k`'s best models are the
whole grid's (`_top_models`), so each shard iterates as often, and
reaches the values, that the whole grid would.
"""

import contextlib
import math

import torch

from ..config import FitConfig, LN2PI
from ..parallel.mesh import all_gather, all_reduce, group_rank, group_size
from ..utils import chi2_logpdf, inverse3
from .sed import get_seds_flux

NEG_BIG = -1e30  # the reference's -inf stand-in (fitting.py:778)


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


def parallax_or_nan(B, device, parallax, parallax_err):
    """The `(B,)` float32 parallaxes and errors on `device`, NaN if None."""
    nan = torch.full((B,), math.nan, dtype=torch.float32, device=device)
    return tuple(nan if x is None else x.to(device, torch.float32)
                 for x in (parallax, parallax_err))


@contextlib.contextmanager
def highest_precision():
    """Float32 matrix products at full precision (no TF32) inside the
    block, as `jax.default_matmul_precision("highest")`."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _fdot(X, w):
    """The filter-axis contraction `X @ w` of every star: `X (M, F)`
    shared or `(B, M, F)` per star, `w (B, F)` -> `(B, M)`.  Per-star
    rows are multiplied and summed elementwise, so each star's sums do
    not depend on the other stars of its batch (a batched matrix
    product may block them differently): the funnel's loops then take
    the iterations, and reach the values, of each star run alone."""
    if X.dim() == 2:
        return w @ X.T
    return (X * w[:, None, :]).sum(-1)


def _gmax(x, group=None):
    """Per-star max of `x (B, M)` over the models, of the whole grid on
    a model `group`."""
    return all_reduce(x.amax(-1), "max", group)


def _masked_max(x, mask, group=None):
    """Per-star max of `x (B, M)` over `mask`, -inf where it is empty."""
    return _gmax(torch.where(mask, x, torch.full_like(x, -math.inf)), group)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _n_models(mag_coeffs):
    return mag_coeffs.shape[-3]


def _freeze(active, new, old):
    """`new` for the stars still iterating, `old` for the others."""
    a = active.view(-1, *([1] * (old.dim() - 1)))
    return torch.where(a, new, old)


# ---------------------------------------------------------------------------
# Phase A: magnitude-space alternating (Av, Rv) solves
# (reference brutus/fitting.py:34-271)
# ---------------------------------------------------------------------------

def direct_mag_init(mags, wt_mag, mag_coeffs, cfg: FitConfig):
    """One weighted least-squares solve of `(mu-offset, Av, Av*Rv)` per
    model, the magnitude-space model being linear in them (mirrors
    `optimize.direct_mag_init`).  Returns the clamped `(av, rv)`
    seeds `(B, M)`."""
    r0 = mag_coeffs[..., 1]
    dr = mag_coeffs[..., 2]
    resid0 = mags[:, None, :] - mag_coeffs[..., 0]
    av_var_inv = 1.0 / cfg.av_gauss[1] ** 2
    B, M = mags.shape[0], _n_models(mag_coeffs)
    sw = wt_mag.sum(-1, keepdim=True).expand(B, M)
    swr = _fdot(r0, wt_mag)
    swd = _fdot(dr, wt_mag)
    swrr = _fdot(r0 * r0, wt_mag) + av_var_inv
    swrd = _fdot(r0 * dr, wt_mag)
    swdd = _fdot(dr * dr, wt_mag)
    b0 = _fdot(resid0, wt_mag)
    b1 = _fdot(resid0 * r0, wt_mag) + cfg.av_gauss[0] * av_var_inv
    b2 = _fdot(resid0 * dr, wt_mag)
    G = torch.stack([torch.stack([sw, swr, swd], -1),
                     torch.stack([swr, swrr, swrd], -1),
                     torch.stack([swd, swrd, swdd], -1)], -2)
    sol = torch.einsum("bmij,bmj->bmi", inverse3(G),
                       torch.stack([b0, b1, b2], -1))
    av = torch.clamp(sol[..., 1], *cfg.avlim)
    ok = torch.abs(sol[..., 1]) > 1e-10
    rv = torch.where(ok, sol[..., 2] / torch.where(
        ok, sol[..., 1], torch.ones_like(av)),
        torch.full_like(av, cfg.rv_gauss[0]))
    return av, torch.clamp(rv, *cfg.rvlim)


def _optimize_mag(mags, wt_mag, mag_coeffs, av0, rv0, cfg: FitConfig,
                  group=None):
    if cfg.mag_direct_init:
        av0, rv0 = direct_mag_init(mags, wt_mag, mag_coeffs, cfg)
    mag0 = mag_coeffs[..., 0]
    r0 = mag_coeffs[..., 1]
    dr = mag_coeffs[..., 2]
    av_var_inv = 1.0 / cfg.av_gauss[1] ** 2
    rv_var_inv = 1.0 / cfg.rv_gauss[1] ** 2
    av_mean, rv_mean = cfg.av_gauss[0], cfg.rv_gauss[0]
    avmin, avmax = cfg.avlim
    rvmin, rvmax = cfg.rvlim
    log_init_thresh = math.log(cfg.init_thresh)
    B, M = mags.shape[0], _n_models(mag_coeffs)
    obs = mags[:, None, :]

    # Iteration-constant reductions (fitting.py:158-164).
    s_den = wt_mag.sum(-1, keepdim=True).expand(B, M)
    rp_den = _fdot(dr * dr, wt_mag)
    srp_mix = _fdot(dr, wt_mag)

    def body(av, rv):
        rvec = r0 + rv[..., None] * dr
        resid = obs - (mag0 + av[..., None] * rvec)
        # Av update (fitting.py:176-204)
        a_den = _fdot(rvec * rvec, wt_mag) + av_var_inv
        sa_mix = _fdot(rvec, wt_mag)
        resid_s = _fdot(resid, wt_mag)
        resid_a = _fdot(resid * rvec, wt_mag) + (av_mean - av) * av_var_inv
        sa_idet = 1.0 / (s_den * a_den - sa_mix * sa_mix)
        dav = sa_idet * (s_den * resid_a - sa_mix * resid_s)
        dav = _clip(dav, avmin - av, avmax - av)
        av = av + dav
        resid = resid - dav[..., None] * rvec
        # Rv update (fitting.py:206-237)
        r_den = rp_den * av * av + rv_var_inv
        sr_mix = srp_mix * av
        resid_s = _fdot(resid, wt_mag)
        resid_r = (av * _fdot(resid * dr, wt_mag)
                   + (rv_mean - rv) * rv_var_inv)
        sr_idet = 1.0 / (s_den * r_den - sr_mix * sr_mix)
        drv = sr_idet * (s_den * resid_r - sr_mix * resid_s)
        drv = _clip(drv, rvmin - rv, rvmax - rv)
        rv = rv + drv
        resid = resid - (av * drv)[..., None] * dr
        # convergence over the good fits (fitting.py:240-264)
        logwt = -0.5 * _fdot(resid * resid, wt_mag)
        good = logwt > _gmax(logwt, group)[:, None] + log_init_thresh
        err = _masked_max(torch.maximum(torch.abs(dav), torch.abs(drv)),
                          good, group)
        return av, rv, err

    av, rv = av0, rv0
    err = torch.full((B,), math.inf, dtype=mags.dtype, device=mags.device)
    it = torch.zeros((B,), dtype=torch.int32, device=mags.device)
    while True:
        active = (err >= cfg.mtol) & (it < cfg.max_iter_mag)
        if not bool(active.any()):
            break
        av_n, rv_n, err_n = body(av, rv)
        av, rv = _freeze(active, av_n, av), _freeze(active, rv_n, rv)
        err = _freeze(active, err_n, err)
        it = it + active.to(it.dtype)
    return av, rv, it


def optimize_mag(mags, wt_mag, mag_coeffs, av0, rv0, cfg: FitConfig):
    """Iterated alternating 2x2 weighted least squares in magnitude space
    (mirrors `optimize.optimize_mag`; reference `fitting.py:173-264`):
    the clamped (s, Av) and (s, Rv) solves alternate until the (Av, Rv)
    steps of every good model of a star fall below `cfg.mtol`.

    mags, wt_mag : (B, F) or one star's (F,); mag_coeffs : (M, F, 3) or
    (B, M, F, 3); av0, rv0 : (B, M) or (M,).  Returns `av, rv, n_iter`.
    """
    single = mags.dim() == 1
    if single:
        mags, wt_mag = mags[None], wt_mag[None]
        av0, rv0 = av0[None], rv0[None]
    av, rv, it = _optimize_mag(mags, wt_mag, mag_coeffs, av0, rv0, cfg)
    return (av[0], rv[0], it[0]) if single else (av, rv, it)


# ---------------------------------------------------------------------------
# MLE re-expansion in flux space
# (reference brutus/fitting.py:430-576 `_get_sed_mle`)
# ---------------------------------------------------------------------------

def _sed_mle(flux, wt_flux, mag_coeffs, av, rv, cfg: FitConfig,
             want_step_sums=False):
    m, rvec, drvec = get_seds_flux(mag_coeffs, av, rv)   # unscaled
    # MLE scale (fitting.py:510-518), normal matrix floored
    s_num = _fdot(m, flux * wt_flux)
    s_den = torch.clamp(_fdot(m * m, wt_flux), min=1e-30)
    scale = torch.clamp(s_num / s_den, min=cfg.scale_min)
    m_int = torch.pow(10.0, -0.4 * mag_coeffs[..., 0])
    ms = m * scale[..., None]
    resid = flux[:, None, :] - ms
    red_s = (m - m_int) * scale[..., None]
    # cross terms: the scale rows take unscaled reddening vectors, the
    # (Av, Rv) block scaled ones (fitting.py:526-561)
    t = ms - resid
    sa_mix = _fdot(rvec * t, wt_flux)
    sr_mix = _fdot(drvec * t, wt_flux)
    rvec_s = rvec * scale[..., None]
    drvec_s = drvec * scale[..., None]
    ar_mix = _fdot(drvec_s * (red_s - resid), wt_flux)
    qa = _fdot(rvec_s * rvec_s, wt_flux)
    qr = _fdot(drvec_s * drvec_s, wt_flux)
    a_den = qa + 1.0 / cfg.av_gauss[1] ** 2 + 1.0 / cfg.av_reg ** 2
    r_den = qr + 1.0 / cfg.rv_gauss[1] ** 2 + 1.0 / cfg.rv_reg ** 2
    icov_parts = (s_den, a_den, r_den, sa_mix, sr_mix, ar_mix)
    if not want_step_sums:
        return ms, rvec_s, drvec_s, scale, icov_parts, resid
    ra = _fdot(rvec_s * resid, wt_flux)
    rd = _fdot(drvec_s * resid, wt_flux)
    chi2 = _fdot(resid * resid, wt_flux)
    return (ms, rvec_s, drvec_s, scale, icov_parts, resid,
            (ra, qa, rd, qr), chi2)


def sed_mle(flux, wt_flux, mag_coeffs, av, rv, cfg: FitConfig,
            want_step_sums=False):
    """Flux-space models at `(av, rv)`, their MLE scale and the 6 parts
    `(s_den, a_den, r_den, sa, sr, ar)` of each model's `(s, Av, Rv)`
    precision (mirrors `optimize.sed_mle`).

    flux, wt_flux : (B, F) or (F,); mag_coeffs : (M, F, 3) or
    (B, M, F, 3); av, rv : (B, M) or (M,).  Returns `models, rvecs,
    drvecs, scale, icov_parts, resid`, and with `want_step_sums` also
    the four sums of the damped update and `chi2`.
    """
    single = flux.dim() == 1
    if single:
        flux, wt_flux, av, rv = flux[None], wt_flux[None], av[None], rv[None]
    out = _sed_mle(flux, wt_flux, mag_coeffs, av, rv, cfg, want_step_sums)
    if not single:
        return out
    strip = lambda x: tuple(y[0] for y in x) if isinstance(x, tuple) \
        else x[0]
    return tuple(strip(x) for x in out)


# ---------------------------------------------------------------------------
# Damped flux-space (Av, Rv) updates
# (reference brutus/fitting.py:274-427 `_optimize_fit_flux`)
# ---------------------------------------------------------------------------

def optimize_flux_step(wt_flux, models, rvecs, drvecs, resid, av, rv,
                       stepsize, cfg: FitConfig):
    """One damped `(dAv, dRv)` update in flux space, both solved at the
    current residuals (fitting.py:385-402), scaled by `stepsize`,
    clamped and applied (mirrors `optimize.optimize_flux_step`).
    wt_flux : (B, F); the rest (B, M, F) or (B, M)."""
    av_var_inv = 1.0 / cfg.av_gauss[1] ** 2
    rv_var_inv = 1.0 / cfg.rv_gauss[1] ** 2
    a_num = _fdot(rvecs * resid, wt_flux) + (cfg.av_gauss[0] - av) \
        * av_var_inv
    a_den = _fdot(rvecs * rvecs, wt_flux) + av_var_inv
    dav = stepsize * a_num / a_den
    r_num = _fdot(drvecs * resid, wt_flux) + (cfg.rv_gauss[0] - rv) \
        * rv_var_inv
    r_den = _fdot(drvecs * drvecs, wt_flux) + rv_var_inv
    drv = stepsize * r_num / r_den
    dav = _clip(dav, cfg.avlim[0] - av, cfg.avlim[1] - av)
    av = av + dav
    drv = _clip(drv, cfg.rvlim[0] - rv, cfg.rvlim[1] - rv)
    return av, rv + drv


def _flux_polish(flux, wt_flux, mcoeffs, init_arrays, keep,
                 cfg: FitConfig, group=None):
    """Damped flux-space iteration to convergence (mirrors
    `optimize._flux_polish`; the `while lerr > ltol` loop of reference
    `fitting.py:777-803`): a star stops when the log-likelihood change
    of its `keep` models within `ltol_subthresh` of their best falls to
    `ltol`.  The loop carries `(B, M)` state only: the update needs four
    filter-axis sums, which `sed_mle(want_step_sums=True)` returns.

    Returns `(chi2, scale, av, rv, icov_parts, n_iter)`.
    """
    models, rvecs, drvecs, scale, av, rv, icov, resid = init_arrays
    B = av.shape[0]
    ln_subthresh = math.log(cfg.ltol_subthresh)
    av_var_inv = 1.0 / cfg.av_gauss[1] ** 2
    rv_var_inv = 1.0 / cfg.rv_gauss[1] ** 2
    sums = (_fdot(rvecs * resid, wt_flux), _fdot(rvecs * rvecs, wt_flux),
            _fdot(drvecs * resid, wt_flux), _fdot(drvecs * drvecs, wt_flux))
    lnl_old = torch.full_like(av, NEG_BIG)
    stepsize = torch.ones_like(av)
    lerr = torch.full((B,), math.inf, dtype=av.dtype, device=av.device)
    it = torch.zeros((B,), dtype=torch.int32, device=av.device)
    while True:
        active = (lerr > cfg.ltol) & (it < cfg.max_iter_flux)
        if not bool(active.any()):
            break
        ra, qa, rd, qr = sums
        dav = stepsize * (ra + (cfg.av_gauss[0] - av) * av_var_inv) / (
            qa + av_var_inv)
        drv = stepsize * (rd + (cfg.rv_gauss[0] - rv) * rv_var_inv) / (
            qr + rv_var_inv)
        dav = _clip(dav, cfg.avlim[0] - av, cfg.avlim[1] - av)
        av_n = av + dav
        drv = _clip(drv, cfg.rvlim[0] - rv, cfg.rvlim[1] - rv)
        rv_n = rv + drv
        (_m, _r, _d, scale_n, icov_n, _res, sums_n,
         chi2) = _sed_mle(flux, wt_flux, mcoeffs, av_n, rv_n, cfg,
                          want_step_sums=True)
        lnl_new = -0.5 * chi2
        sel = keep & (lnl_new > _masked_max(lnl_new, keep, group)[:, None]
                      + ln_subthresh)
        lerr_n = _masked_max(torch.abs(lnl_new - lnl_old), sel, group)
        step_n = torch.where(lnl_new < lnl_old,
                             stepsize / cfg.stepsize_rescale, stepsize)
        f = lambda new, old: _freeze(active, new, old)
        scale, av, rv = f(scale_n, scale), f(av_n, av), f(rv_n, rv)
        icov = tuple(f(n, o) for n, o in zip(icov_n, icov))
        sums = tuple(f(n, o) for n, o in zip(sums_n, sums))
        lnl_old, stepsize = f(lnl_new, lnl_old), f(step_n, stepsize)
        lerr = f(lerr_n, lerr)
        it = it + active.to(it.dtype)
    return -2.0 * lnl_old, scale, av, rv, icov, it


# ---------------------------------------------------------------------------
# The per-star grid log-likelihood
# (reference brutus/fitting.py:579-820 `loglike`)
# ---------------------------------------------------------------------------

def _top_models(lnl, k, group=None):
    """The `k` best models of each star by `lnl (B, M)`, over the whole
    grid on a model `group`: `(sel, in_top)`, `sel (B, k_local)` this
    shard's candidates (local indices) and `in_top` which of them are
    among the grid's best `k`.

    Each of the `n` shards of `M_local` models (`shard_grid`'s layout:
    shard `r` holds global models `r * M_local + j`; one process is one
    shard) offers its best `min(k, M_local)`, which hold every one of
    its models among the grid's best `k`; the offers' values are
    all-gathered (exact) and the best `k` of their union taken.  Ties
    at the `k`-th value go to the lower global model index, as
    `lax.top_k` breaks them (the JAX package's `lax.approx_max_k` is
    exact off the TPU): both selections are stable sorts, and the
    gather lays the offers out by shard, each shard's in ascending
    index among equal values, so an offer's position orders the global
    indices of equal values."""
    k_local = min(k, lnl.shape[-1])
    val, sel = torch.sort(lnl, dim=-1, descending=True, stable=True)
    val, sel = val[:, :k_local], sel[:, :k_local]
    offers = all_gather(val, group, dim=1)       # (B, n * k_local)
    best = torch.sort(offers, dim=-1, descending=True, stable=True).indices
    top = torch.zeros_like(offers, dtype=torch.bool).scatter_(
        1, best[:, :k], True)
    r = group_rank(group)
    return sel, top[:, r * k_local:(r + 1) * k_local]


def _loglike_grid_body(flux, fluxerr, mask, mag_coeffs, parallax,
                       parallax_err, av_init, rv_init, cfg: FitConfig,
                       group=None):
    """Batched `optimize._loglike_grid_body`: data hygiene, the
    magnitude phase, the flux-space MLE expansion, the init cull (with
    the parallax in scale space), the flux polish of the kept models,
    the Gaussian constant and the chi2 dimensionality prior.  Star-side
    inputs are `(B, ...)`; `group` a model group over which the grid is
    sharded (see the module docstring)."""
    dtype = mag_coeffs.dtype
    flux = flux.to(dtype)
    fluxerr = fluxerr.to(dtype)
    parallax = parallax.to(dtype)
    parallax_err = parallax_err.to(dtype)
    B, M = flux.shape[0], _n_models(mag_coeffs)
    (flux, wt_flux, mags, wt_mag, mask, ndim,
     tot_var) = prepare_star_data(flux, fluxerr, mask, cfg)

    kw = dict(dtype=dtype, device=flux.device)
    av0 = (torch.as_tensor(av_init, **kw).expand(B, M)
           if av_init is not None else torch.full((B, M), cfg.av0, **kw))
    rv0 = (torch.as_tensor(rv_init, **kw).expand(B, M)
           if rv_init is not None else torch.full((B, M), cfg.rv0, **kw))
    av, rv, n_iter_mag = _optimize_mag(mags, wt_mag, mag_coeffs, av0, rv0,
                                       cfg, group)
    (models, rvecs, drvecs, scale, icov_parts,
     resid) = _sed_mle(flux, wt_flux, mag_coeffs, av, rv, cfg)
    chi2_mag = _fdot(resid * resid, wt_flux)
    lnl_mag = -0.5 * chi2_mag

    # init cull (fitting.py:743-768)
    if cfg.apply_init_cull:
        par = torch.sqrt(scale)
        have = (torch.isfinite(parallax) & torch.isfinite(parallax_err))
        perr = torch.where(have, parallax_err, torch.ones_like(parallax_err))
        chi2_p = torch.where(have[:, None],
                             (par - parallax[:, None]) ** 2
                             / perr[:, None] ** 2, torch.zeros_like(par))
        lnl_p = lnl_mag - 0.5 * chi2_p
        keep = lnl_p > _gmax(lnl_p, group)[:, None] + math.log(
            cfg.init_thresh)
    else:
        lnl_p = lnl_mag
        keep = torch.ones_like(lnl_mag, dtype=torch.bool)

    # flux polish (fitting.py:777-810); culled models keep phase A
    const = -0.5 * (ndim * LN2PI + (torch.log(torch.where(
        mask, tot_var, torch.ones_like(tot_var))) * mask).sum(-1))
    if cfg.polish_k and cfg.polish_k < M * group_size(group):
        sel, in_top = _top_models(lnl_p, cfg.polish_k, group)
        g = lambda x: torch.gather(x, 1, sel)
        rows = torch.arange(B, device=sel.device)[:, None]
        gm = lambda x: x[rows, sel]                  # (B, M, F) per star
        coef_k = (mag_coeffs[sel] if mag_coeffs.dim() == 3
                  else gm(mag_coeffs))
        keep_k = g(keep) & in_top
        (chi2_f, scale_f, av_f, rv_f, icov_f, n_iter_flux) = _flux_polish(
            flux, wt_flux, coef_k,
            (gm(models), gm(rvecs), gm(drvecs), g(scale), g(av), g(rv),
             tuple(g(p) for p in icov_parts), gm(resid)), keep_k, cfg,
            group)
        put = lambda full, new: full.scatter(
            1, sel, torch.where(keep_k, new, g(full)))
        lnl = put(lnl_mag, -0.5 * chi2_f + const[:, None])
        chi2 = put(chi2_mag, chi2_f)
        scale, av, rv = put(scale, scale_f), put(av, av_f), put(rv, rv_f)
        icov_parts = tuple(put(full, new) for full, new
                           in zip(icov_parts, icov_f))
    else:
        (chi2_f, scale_f, av_f, rv_f, icov_f, n_iter_flux) = _flux_polish(
            flux, wt_flux, mag_coeffs,
            (models, rvecs, drvecs, scale, av, rv, icov_parts, resid),
            keep, cfg, group)
        lnl = torch.where(keep, -0.5 * chi2_f + const[:, None], lnl_mag)
        chi2 = torch.where(keep, chi2_f, chi2_mag)
        scale = torch.where(keep, scale_f, scale)
        av = torch.where(keep, av_f, av)
        rv = torch.where(keep, rv_f, rv)
        icov_parts = tuple(torch.where(keep, new, full) for full, new
                           in zip(icov_parts, icov_f))

    # dimensionality prior (fitting.py:812-815)
    if cfg.dim_prior:
        lnl = chi2_logpdf(chi2, (ndim - 3)[:, None])
    return dict(lnlike=lnl, ndim=ndim, chi2=chi2, scale=scale, av=av,
                rv=rv, icov_parts=icov_parts,
                n_iter=torch.stack([n_iter_mag, n_iter_flux], -1))


def loglike_grid(flux, fluxerr, mask, mag_coeffs, parallax=math.nan,
                 parallax_err=math.nan, av_init=None, rv_init=None,
                 cfg: FitConfig = FitConfig(), model_group=None):
    """Log-likelihood of stars against every model of `mag_coeffs`,
    profiling out `(s, Av, Rv)` per model, with the reference's
    convergence loops (mirrors `optimize.loglike_grid`).

    flux, fluxerr, mask : one star's (F,) or a batch's (B, F);
    mag_coeffs : (M, F, 3) shared, or (B, M, F, 3) per star; parallax,
    parallax_err : scalars or (B,), NaN where absent; av_init, rv_init :
    optional (M,) or (B, M) magnitude-phase seeds (default the prior
    means; ignored with `cfg.mag_direct_init`).  `cfg.polish_k > 0`
    polishes the best `polish_k` models of each star (exact top-k).
    `model_group`: `mag_coeffs` is this shard's slice of a grid sharded
    over that group (module docstring); `polish_k` then counts the
    group's models, and its best models are the whole grid's
    (`_top_models`, which says how ties are broken).

    Returns a dict: `lnlike, chi2, scale, av, rv` (M,) / (B, M),
    `icov_parts` the 6 precision parts, `ndim`, and `n_iter`, the
    (magnitude, flux) iteration counts, (2,) / (B, 2).
    """
    mag_coeffs = torch.as_tensor(mag_coeffs)
    kw = dict(device=mag_coeffs.device)
    flux = torch.as_tensor(flux, **kw)
    fluxerr = torch.as_tensor(fluxerr, **kw)
    mask = torch.as_tensor(mask, **kw)
    single = flux.dim() == 1
    if single:
        flux, fluxerr, mask = flux[None], fluxerr[None], mask[None]
        av_init = None if av_init is None else torch.as_tensor(av_init)[None]
        rv_init = None if rv_init is None else torch.as_tensor(rv_init)[None]
    B = flux.shape[0]
    plx = torch.as_tensor(parallax, dtype=mag_coeffs.dtype, **kw).expand(B)
    plxe = torch.as_tensor(parallax_err, dtype=mag_coeffs.dtype,
                           **kw).expand(B)
    with highest_precision():
        out = _loglike_grid_body(flux, fluxerr, mask, mag_coeffs, plx, plxe,
                                 av_init, rv_init, cfg, model_group)
    if single:
        out = {k: tuple(p[0] for p in v) if k == "icov_parts" else v[0]
               for k, v in out.items()}
    return out


__all__ = ["prepare_star_data", "parallax_or_nan", "direct_mag_init",
           "optimize_mag", "sed_mle", "optimize_flux_step", "loglike_grid",
           "highest_precision"]
