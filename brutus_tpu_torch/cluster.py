"""
Co-eval cluster isochrone likelihood and the cluster fitter (mirrors
`brutus_tpu/cluster.py`).

Parity: reference `brutus/cluster.py:23-419` (`isochrone_loglike`): the
joint likelihood of a star cluster given shared parameters `(feh, loga,
av, rv, dist, fout)`, optional per-band photometric offsets and optional
empirical-correction parameters; every star is marginalised over the
EEPs of the isochrone and a grid of binary secondary mass fractions,
with an inlier / outlier mixture.

One evaluation takes a batch of parameter sets (the walkers of
`fit_cluster`, where the JAX package maps its core with `jax.vmap`):
their population SEDs come from one `models.isochrone.
population_seds_multi` call, and the masked chi-square of every
(smf, EEP) model against every star is one `(Nsmf * Neep, 3F) @ (3F,
Nobj)` matrix product per parameter set (JAX's three contractions,
stacked), at full precision (no TF32): the terms are O(SNR**2) and
cancel to O(1).  Parameter sets go through
those products in groups small enough that one `(group, Nsmf * Neep,
Nobj)` block stays within `BLOCK_ELEMENTS`; the results do not depend on
the grouping.
"""

import math

import numpy as np
import torch
from scipy.stats import chi2 as chisquare

from .models.isochrone import population_seds_multi
from .models.tracks import DEFAULT_CORR_PARAMS
from .ops.optimize import highest_precision
from .utils import resolve_device

DEFAULT_SMF_GRID = np.array([0.0, 0.2, 0.35, 0.45, 0.5, 0.55, 0.6, 0.65,
                             0.7, 0.75, 0.8, 0.85, 0.9, 0.95, 1.0])

# The largest (parameter sets x models x stars) block of the chi-square
# held at once: 2**27 float64 values, 1 GiB per temporary.
BLOCK_ELEMENTS = 1 << 27


def _read_params(theta, spec, n, counter):
    """`n` parameters from `theta`, skipping fixed entries."""
    if spec == "free":
        vals = np.asarray(theta[counter:counter + n], dtype=float)
        return vals, counter + n
    vals = np.zeros(n)
    for i, c in enumerate(spec):
        if c is None:
            vals[i] = theta[counter]
            counter += 1
        else:
            vals[i] = c
    return vals, counter


def _chi2_cmd(cmd, okf, w, dw, d2w):
    """The masked chi-square `sum_f ok_pf w_of (d_of - m_pf)**2` of the
    model fluxes `cmd (G, P, F)` (valid where `okf`) against every star,
    as `(m**2 ok) @ w' - 2 (m ok) @ dw' + ok @ d2w'` with the per-star
    data terms `w`, `dw = d w`, `d2w = d**2 w` of shape `(G, Nobj, F)`:
    `(G, P, Nobj)`, no `(P, Nobj, F)` residual.  The three contractions
    run as one matrix product over the stacked `3F` axis, at full
    precision: in float32 the cancellation leaves an error of ~eps *
    SNR**2 * F (`tests/test_torch_cluster.py::test_chi2_f32_envelope`)."""
    mo = cmd * okf
    lhs = torch.cat([cmd * mo, mo, okf], dim=-1)
    rhs = torch.cat([w, -2.0 * dw, d2w], dim=-1)
    with highest_precision():
        return torch.matmul(lhs, rhs.transpose(1, 2))


def _chi2_lnl(chi2, halfdf):
    """`chi2_logpdf(chi2, 2 halfdf)` in place on the block `chi2`, the
    per-star constants taken once (the same operations in the same
    order), -inf where the value is not finite."""
    pos = chi2 > 0
    c0 = -(halfdf * math.log(2.0) + torch.lgamma(halfdf))
    lnl = torch.log(torch.where(pos, chi2, 1.0))
    lnl.mul_(halfdf - 1.0).add_(c0).sub_(chi2.masked_fill_(~pos, 1.0)
                                         .mul_(0.5))
    return lnl.masked_fill_(~(pos & torch.isfinite(lnl)), -math.inf)


def _cluster_core(tables, data, cvals, Xb, corr, mini_bound,
                  eep_binary_max, cluster_prob, idx, smf_sig, dim_prior):
    """Cluster log-likelihoods of a batch of parameter sets (mirrors
    `brutus_tpu.cluster._cluster_core`, mapped over the batch).

    tables : `(xgrid, ygrid, nn_params)` of the isochrone.
    data : `_device_data`'s dict (EEP grid, smf log-measures, photometry,
        masks, dof, outlier log-likelihoods, parallaxes).
    cvals : `(G, 6)` = (feh, loga, av, rv, dist, fout); Xb : `(G, F)`
        per-band offsets; corr : `(G, 4)` correction parameters.

    Returns `(lnl_total (G,), lnl_mix (G, Nobj))`, the reference's
    `(lnl, lnl_mix)` of `brutus/cluster.py:407-419`.
    """
    xgrid, ygrid, nn_params = tables
    eep_grid = data["eep_grid"]
    feh, loga, av, rv, dist, fout = cvals.unbind(-1)
    fout = torch.clamp(fout, 1e-10, 1.0 - 1e-10)

    # Population SEDs of every smf, (G, Nsmf, Neep, F).
    seds, mini = population_seds_multi(
        xgrid, ygrid, nn_params, idx, eep_grid, feh, 0.0, loga, av, rv,
        dist, smf_sig, mini_bound, eep_binary_max,
        corr_params=corr.unbind(-1))
    G, n_smf, n_pts, n_f = seds.shape

    # IMF measure along the isochrone (reference cluster.py:367-375):
    # d(mini)/d(EEP) of the primary, shared by every smf.
    grad_mini = torch.gradient(mini, dim=-1)[0]
    valid_pt = torch.isfinite(grad_mini) & (grad_mini > 0)
    # No binaries past the MSTO for smf > 0 (reference cluster.py:354-356).
    beyond = eep_grid > eep_binary_max
    smf_pos = torch.tensor([s > 0 for s in smf_sig],
                           device=seds.device)[:, None]
    valid = valid_pt[:, None] & ~(smf_pos & beyond)         # (G, Nsmf, Neep)
    sed_ok = torch.isfinite(seds)
    # A point with no finite band would score chi2_cmd = 0 (reference
    # `usable` any-finite condition, cluster.py:348-352).
    valid = valid & sed_ok.any(-1)
    zero = torch.zeros((), dtype=seds.dtype, device=seds.device)
    cmd = torch.where(sed_ok, 10.0 ** (-0.4 * torch.where(sed_ok, seds,
                                                          zero)), zero)
    okf = sed_ok.to(cmd.dtype)

    # Data side per star, offset-scaled: w = mask / (err * Xb)**2.
    # Missing bands carry NaN in `phot`, so every data operand is zeroed
    # under the mask.
    mask = data["phot_mask"]
    m = mask.to(cmd.dtype)
    phot_t = torch.where(mask, data["phot"], zero)[None] * Xb[:, None]
    safe_err = torch.where(mask, data["err"], zero + 1.0)[None] \
        * Xb[:, None]
    w = m / safe_err ** 2                                   # (G, Nobj, F)
    dw = phot_t * w
    d2w = phot_t ** 2 * w
    lnvar = torch.log(2.0 * torch.pi * safe_err ** 2) * m

    # Parallax at the shared cluster distance (reference
    # cluster.py:292-301); ivar is 0 where absent.
    pivar = data["parallax_ivar"]
    chi2_p = (data["parallax"] - 1e3 / dist[:, None]) ** 2 * pivar
    lnorm_p = torch.where(pivar > 0, -torch.log(pivar / (2.0 * torch.pi)),
                          zero)

    # Mass-measure and smf-measure priors (reference cluster.py:378-407).
    lnprior = torch.where(
        valid, torch.log(torch.where(valid, grad_mini[:, None], zero + 1.0))
        + data["grad_smf_log"][:, None], zero - torch.inf).reshape(G, -1)
    cmd, okf = cmd.reshape(G, -1, n_f), okf.reshape(G, -1, n_f)
    per_set = cmd.shape[1] * m.shape[0]
    step = max(1, BLOCK_ELEMENTS // max(per_set, 1))
    lnl_in = []
    for lo in range(0, G, step):
        g = slice(lo, lo + step)
        chi2 = _chi2_cmd(cmd[g], okf[g], w[g], dw[g], d2w[g])
        chi2 += chi2_p[g, None]
        if dim_prior:
            lnl = _chi2_lnl(chi2, 0.5 * data["phot_n"])
        else:
            with highest_precision():
                lnorm_cmd = torch.matmul(okf[g], lnvar[g].transpose(1, 2))
            lnl = -0.5 * (chi2 + lnorm_cmd + lnorm_p)
            lnl = lnl.masked_fill_(~torch.isfinite(lnl), -math.inf)
        del chi2
        lnl += lnprior[g, :, None]
        lnl_in.append(torch.logsumexp(lnl, dim=1))
        del lnl
    lnl_in = torch.cat(lnl_in)                               # (G, Nobj)

    # Inlier / outlier mixture (reference cluster.py:410-414).
    ln_fin = torch.log(cluster_prob * (1.0 - fout))
    ln_fout = torch.log1p(-cluster_prob * (1.0 - fout))
    lnl_mix = torch.logaddexp(lnl_in + ln_fin[:, None],
                              data["lnl_outlier"] + ln_fout[:, None])
    return lnl_mix.sum(-1), lnl_mix


def _prepare_cluster_data(phot, err, parallax, parallax_err, dim_prior):
    """Host-side data hygiene that no parameter changes: masks, dof
    counts and the outlier model (mirrors
    `brutus_tpu.cluster._prepare_cluster_data`; reference
    cluster.py:303-321)."""
    phot = np.asarray(phot, dtype=float)
    err = np.asarray(err, dtype=float)
    n_obj, n_bands = phot.shape
    phot_mask = np.isfinite(phot) & np.isfinite(err)
    phot_n = phot_mask.sum(axis=1).astype(float)
    if np.any(~phot_mask.all(axis=1) & (phot_n == 0)):
        raise ValueError("at least one object has no valid data")

    if (parallax is None) != (parallax_err is None):
        raise ValueError("provide both `parallax` and `parallax_err`")
    pmask = np.zeros(n_obj, bool)
    plx = np.zeros(n_obj)
    pivar = np.zeros(n_obj)
    if parallax is not None:
        parallax = np.asarray(parallax, float)
        parallax_err = np.asarray(parallax_err, float)
        pmask = np.isfinite(parallax) & np.isfinite(parallax_err)
        plx[pmask] = parallax[pmask]
        pivar[pmask] = 1.0 / parallax_err[pmask] ** 2
        phot_n = phot_n + pmask

    if dim_prior:
        outlier_chi2 = chisquare.ppf(1.0 - 1e-5, phot_n)
        lnl_outlier = chisquare.logpdf(outlier_chi2, phot_n)
    else:
        with np.errstate(all="ignore"):
            omax = np.nanmax(phot + 3 * err, axis=0)
            omin = np.nanmin(phot - 3 * err, axis=0)
            osize = (6.0 * err) / (omax - omin)
            osize[~phot_mask] = 1.0
            ovol = np.prod(np.where(phot_mask, osize, 1.0), axis=1)
            if parallax is not None and pmask.any():
                pmax = np.nanmax((parallax + 3 * parallax_err)[pmask])
                pmin = np.nanmin((parallax - 3 * parallax_err)[pmask])
                ovol[pmask] *= (6 * parallax_err[pmask]) / (pmax - pmin)
            lnl_outlier = -np.log(ovol)

    return (phot, err, phot_mask, phot_n, lnl_outlier, plx, pivar,
            n_bands)


def _smf_measures(smf_grid):
    smf_grid = np.asarray(smf_grid, dtype=float)
    grad_smf = (np.gradient(smf_grid) if len(smf_grid) > 1
                else np.array([1.0]))
    return tuple(float(s) for s in smf_grid), np.log(grad_smf)


def _f64(a, device):
    return torch.as_tensor(np.asarray(a, float), device=device)


def _device_data(prepared, eep_grid, grad_smf_log, device):
    """The data of `_cluster_core` as float64 tensors on `device`."""
    phot, err, phot_mask, phot_n, lnl_outlier, plx, pivar, _ = prepared
    t = lambda a: _f64(a, device)
    return dict(eep_grid=t(eep_grid), grad_smf_log=t(grad_smf_log),
                phot=t(phot), err=t(err),
                phot_mask=torch.as_tensor(phot_mask, device=device),
                phot_n=t(phot_n), lnl_outlier=t(lnl_outlier),
                parallax=t(plx), parallax_ivar=t(pivar))


def _tables_on(isochrone, device):
    xgrid, ygrid, nn_params = isochrone.tables
    to = lambda a: a.to(device)
    return (tuple(map(to, xgrid)), to(ygrid), tuple(map(to, nn_params)))


def _grids(smf_grid, eep_grid):
    smf_sig, grad_smf_log = _smf_measures(
        DEFAULT_SMF_GRID if smf_grid is None else smf_grid)
    if eep_grid is None:
        eep_grid = np.linspace(202.0, 808.0, 2000)
    return smf_sig, grad_smf_log, np.asarray(eep_grid, dtype=float)


def isochrone_loglike(theta, isochrone, phot, err, cluster_params="free",
                      offsets="fixed", corr_params="fixed",
                      mini_bound=0.08, eep_binary_max=480.0,
                      smf_grid=None, eep_grid=None,
                      parallax=None, parallax_err=None,
                      cluster_prob=0.95, dim_prior=True,
                      return_lnls=False, device=None):
    """Total log-likelihood of a co-eval cluster population (mirrors
    `brutus_tpu.cluster.isochrone_loglike`; reference
    `brutus/cluster.py:23-419`, whose docstring gives the `theta` packing:
    fixed entries are skipped).  Runs on `device` (CUDA unless the
    caller names another), in float64."""
    if isochrone is None:
        raise ValueError("`isochrone` must be provided")
    if phot is None or err is None:
        raise ValueError("`phot` and `err` must be provided")
    dev = resolve_device(device)
    prepared = _prepare_cluster_data(phot, err, parallax, parallax_err,
                                     dim_prior)
    n_bands = prepared[-1]
    smf_sig, grad_smf_log, eep_grid = _grids(smf_grid, eep_grid)

    # Degeneracy guards (reference cluster.py:200-225).
    if parallax is None and parallax_err is None:
        if offsets == "free" and (cluster_params == "free"
                                  or cluster_params[4] is None):
            raise ValueError(
                "without parallaxes, fix either the distance or at "
                "least one photometric offset")
    if corr_params != "fixed" and ((corr_params[0] is None
                                    or corr_params[1] is None)
                                   and corr_params[3] is None):
        raise ValueError("if `feh_scale` is free then `dtdm` and `drdm` "
                         "must be fixed (perfect degeneracy)")

    # Unpack theta (reference cluster.py:227-290).
    counter = 0
    cvals, counter = _read_params(theta, cluster_params, 6, counter)
    if offsets == "fixed":
        Xb = np.ones(n_bands)
        counter += n_bands
    else:
        Xb, counter = _read_params(theta, offsets, n_bands, counter)
    if corr_params == "fixed":
        corr = np.asarray(DEFAULT_CORR_PARAMS, float)
        counter += 4
    else:
        corr, counter = _read_params(theta, corr_params, 4, counter)

    data = _device_data(prepared, eep_grid, grad_smf_log, dev)
    row = lambda a: _f64(np.asarray(a, float)[None], dev)
    total, lnl_mix = _cluster_core(
        _tables_on(isochrone, dev), data, row(cvals), row(Xb), row(corr),
        mini_bound, eep_binary_max, cluster_prob, isochrone.iso_idx,
        smf_sig, dim_prior)
    if return_lnls:
        return float(total[0]), lnl_mix[0].cpu().numpy()
    return float(total[0])


# Uniform prior bounds of the free parameters `fit_cluster` samples;
# feh / loga default to the isochrone grid's extent.
DEFAULT_BOUNDS = dict(feh=None, loga=None, av=(0.0, 6.0),
                      rv=(2.4, 4.2), dist=(100.0, 20000.0),
                      fout=(1e-4, 0.5), offsets=(0.8, 1.2),
                      dtdm=(-0.1, 0.3), drdm=(-0.3, 0.1),
                      msto_smooth=(5.0, 100.0), feh_scale=(-1.0, 2.0))

_CLUSTER_NAMES = ("feh", "loga", "av", "rv", "dist", "fout")
_CORR_NAMES = ("dtdm", "drdm", "msto_smooth", "feh_scale")


def _cluster_posterior(isochrone, phot, err, cluster_params, offsets,
                       corr_params, mini_bound, eep_binary_max, smf_grid,
                       eep_grid, parallax, parallax_err, cluster_prob,
                       dim_prior, bounds, dev):
    """`fit_cluster`'s posterior: the free parameters' names, bounds and
    places in `theta`, the fixed values, and `logpost(u)`, the
    log-likelihoods of a batch `(n, ndim)` of points of the unit cube
    (the free parameters scaled into their bounds) from one
    `_cluster_core` call, -inf outside the cube."""
    prepared = _prepare_cluster_data(phot, err, parallax, parallax_err,
                                     dim_prior)
    n_bands = prepared[-1]
    smf_sig, grad_smf_log, eep_grid = _grids(smf_grid, eep_grid)

    b = dict(DEFAULT_BOUNDS)
    b.update(bounds or {})
    for key, axis in (("feh", 0), ("loga", 2)):
        if b[key] is None:
            g = isochrone.xgrid[axis].cpu().numpy()
            b[key] = (float(g.min()), float(g.max()))

    # The free-parameter layout: fixed values, and (lo, hi) rows of the
    # free ones in the reference's theta order.
    fixed_c = np.array([np.nan] * 6)
    fixed_o = np.ones(n_bands)
    fixed_r = np.asarray(DEFAULT_CORR_PARAMS, float)
    names, los_, his_, targets = [], [], [], []

    def add_free(spec, n, base, group, labels):
        if spec == "fixed":
            return
        for i in range(n):
            v = None if spec == "free" else spec[i]
            if v is None:
                lab = labels[i]
                key = "offsets" if group == "o" else lab
                names.append(lab)
                los_.append(b[key][0])
                his_.append(b[key][1])
                targets.append((group, i))
            else:
                base[i] = v

    add_free(cluster_params, 6, fixed_c, "c", _CLUSTER_NAMES)
    add_free(offsets, n_bands, fixed_o, "o",
             [f"offset_{i}" for i in range(n_bands)])
    add_free(corr_params, 4, fixed_r, "r", _CORR_NAMES)
    if not names:
        raise ValueError("no free parameters to fit")

    t = lambda a: _f64(a, dev)
    lo, hi = t(los_), t(his_)
    base = dict(c=t(fixed_c), o=t(fixed_o), r=t(fixed_r))
    where = {grp: ([k for k, (g, _) in enumerate(targets) if g == grp],
                   [i for (g, i) in targets if g == grp])
             for grp in "cor"}
    tables = _tables_on(isochrone, dev)
    data = _device_data(prepared, eep_grid, grad_smf_log, dev)
    idx = isochrone.iso_idx

    def logpost(u):
        inb = torch.all((u > 0.0) & (u < 1.0), dim=-1)
        x = lo + torch.clamp(u, 0.0, 1.0) * (hi - lo)        # (n, ndim)
        vals = {}
        for grp, v in base.items():
            v = v.expand(len(u), -1).clone()
            k, pos = where[grp]
            if k:
                v[:, pos] = x[:, k]
            vals[grp] = v
        ll, _ = _cluster_core(tables, data, vals["c"], vals["o"], vals["r"],
                              mini_bound, eep_binary_max, cluster_prob, idx,
                              smf_sig, dim_prior)
        return torch.where(inb & torch.isfinite(ll), ll,
                           torch.full_like(ll, -torch.inf))

    return dict(logpost=logpost, names=names, lo=lo, hi=hi,
                targets=targets, fixed=(fixed_c, fixed_o, fixed_r))


def fit_cluster(isochrone, phot, err, cluster_params="free",
                offsets="fixed", corr_params="fixed",
                mini_bound=0.08, eep_binary_max=480.0,
                smf_grid=None, eep_grid=None,
                parallax=None, parallax_err=None,
                cluster_prob=0.95, dim_prior=True, bounds=None,
                n_walkers=32, n_steps=1000, n_burn=500, stretch_a=2.0,
                seed=0, max_samples=4000, return_chain=False,
                evidence=False, n_temps=16, beta_power=5.0,
                verbose=False, device=None):
    """Fit the cluster parameters with the ensemble sampler (mirrors
    `brutus_tpu.cluster.fit_cluster`, the replacement of the reference's
    external dynesty sampler, demo "Overview 5"): the free parameters get
    independent uniform priors over `bounds` (`DEFAULT_BOUNDS`, feh /
    loga over the isochrone grid), and every half-step evaluates its
    walkers' likelihoods as one batch on `device` (CUDA unless the
    caller names another).

    `cluster_params`, `offsets`, `corr_params` are
    `isochrone_loglike`'s fixed / free specs; the free entries are the
    sampled dimensions, in `theta` order.  `evidence=True` also
    estimates `logz +/- logz_err` by stepping stones over an
    `n_temps`-rung power-posterior ladder.

    Returns a dict with `samples (n_kept, ndim_free)`, `logl`,
    `map_theta`, `names`, `acceptance`, `tau`, `ess`, `rhat`,
    `theta_full` (the MAP with the fixed entries) and, with
    `return_chain`, the post-burn `chain` and `chain_logl`.
    """
    from .sampling import chain_diagnostics, ensemble_sample

    if cluster_params == "fixed":
        # The six cluster parameters have no defaults: "fixed" would
        # leave them NaN and every likelihood -inf.
        raise ValueError(
            'cluster_params="fixed" is not valid for fit_cluster: the '
            "cluster parameters have no defaults.  Pass a 6-tuple of "
            "values (None entries stay free) to fix them.")

    dev = resolve_device(device)
    post = _cluster_posterior(
        isochrone, phot, err, cluster_params, offsets, corr_params,
        mini_bound, eep_binary_max, smf_grid, eep_grid, parallax,
        parallax_err, cluster_prob, dim_prior, bounds, dev)
    logpost, names, targets = post["logpost"], post["names"], post["targets"]
    lo, hi = post["lo"], post["hi"]
    fixed_c, fixed_o, fixed_r = post["fixed"]
    ndim = len(names)

    ev = None
    if evidence:
        from .sampling import (tempered_ensemble_sample,
                               default_beta_ladder, evidence_from_ladder)
        betas = default_beta_ladder(n_temps, power=beta_power)
        trun = tempered_ensemble_sample(
            logpost, ndim, betas, n_walkers=n_walkers, n_steps=n_steps,
            stretch_a=stretch_a, seed=seed, device=dev)
        ev = evidence_from_ladder(
            betas, trun["logl"][:, n_burn:].cpu().numpy())
        run = dict(chain=trun["chain"][-1], logp=trun["logl"][-1],
                   accept=trun["accept"][-1])
    else:
        run = ensemble_sample(logpost, ndim, n_walkers=n_walkers,
                              n_steps=n_steps, stretch_a=stretch_a,
                              seed=seed, device=dev)
    chain_u = run["chain"][n_burn:].cpu().numpy()
    chain_lp = run["logp"][n_burn:].cpu().numpy()
    diag = chain_diagnostics(chain_u,
                             accept=run["accept"][n_burn:].cpu().numpy())

    lo_np, hi_np = lo.cpu().numpy(), hi.cpu().numpy()
    kept_u = chain_u.reshape(-1, ndim)
    kept_lp = chain_lp.reshape(-1)
    finite = np.isfinite(kept_lp)
    kept_u, kept_lp = kept_u[finite], kept_lp[finite]
    stride = max(1, len(kept_u) // max_samples) if max_samples else 1
    samples = lo_np + kept_u[::stride] * (hi_np - lo_np)
    logl = kept_lp[::stride]
    map_x = samples[np.argmax(logl)]

    theta_full = dict(cluster=fixed_c.copy(), offsets=fixed_o.copy(),
                      corr=fixed_r.copy())
    for k, (g, i) in enumerate(targets):
        {"c": theta_full["cluster"], "o": theta_full["offsets"],
         "r": theta_full["corr"]}[g][i] = map_x[k]
    out = dict(samples=samples, logl=logl, names=list(names),
               map_theta=map_x, theta_full=theta_full,
               acceptance=diag["acceptance"], tau=diag["tau"],
               ess=diag["ess"], rhat=diag["rhat"])
    if ev is not None:
        out.update(logz=ev["logz"], logz_err=ev["logz_err"],
                   logz_ti=ev["logz_ti"])
    if return_chain:
        out["chain"] = lo_np + chain_u * (hi_np - lo_np)
        out["chain_logl"] = chain_lp
    if verbose:
        import sys
        sys.stderr.write(
            f"fit_cluster: acceptance={out['acceptance']:.2f} "
            f"max rhat={out['rhat'].max():.3f}\n")
    return out


__all__ = ["isochrone_loglike", "fit_cluster", "DEFAULT_SMF_GRID",
           "DEFAULT_BOUNDS"]
