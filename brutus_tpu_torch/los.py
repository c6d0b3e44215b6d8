"""
Line-of-sight (LOS) 3-D extinction modeling (mirrors `brutus_tpu/los.py`).

Parity: reference `brutus/los.py`: an N-cloud step model of cumulative
reddening along a sightline, fit to the per-star `(distance, Av)`
posterior draws produced by `BruteForce.fit`.  The prior transform maps
the nested-sampling unit cube to parameters; the likelihood
kernel-weights each star's posterior draws within each distance
segment, marginalizes with a logsumexp, and mixes in a uniform outlier
model.

The likelihood runs on the card for a batch of parameter sets (the
walkers of `fit_clouds`, where the JAX package maps its core with
`jax.vmap`): in float64 for `LOS_clouds_loglike_samples`, in float32
inside `fit_clouds`, whose walkers and draws are float32 as the JAX
package's are.  The JAX core builds the `(clouds + 1, stars, draws)`
block of every segment's kernel and sets the entries of draws outside
the segment to -inf; each draw lies in one segment, so the port
evaluates only that entry, a `(walkers, stars, draws)` block whose
logsumexp over draws is the same sum without its zero terms.  The
prior transform `LOS_clouds_priortransform` stays in numpy on the host.
"""

import math

import numpy as np
import torch
from scipy.stats import truncnorm

from .utils import resolve_device

# The largest (walkers x stars x draws) block evaluated at once: 2**26
# values (512 MiB per float64 temporary); walkers go through the
# likelihood in groups that keep to it.
BLOCK_ELEMENTS = 1 << 26


def LOS_clouds_priortransform(u, rlims=(0.0, 6.0), dlims=(4.0, 19.0),
                              pb_params=(-3.0, 0.7, -np.inf, 0.0),
                              s_params=(-3.0, 0.3, -np.inf, 0.0),
                              dust_template=False, nlims=(0.2, 2.0)):
    """Unit-cube -> LOS parameters for nested sampling (mirrors
    `los.LOS_clouds_priortransform`; reference `brutus/los.py:24-116`):
    truncated-log-normal outlier fraction and smoothings, sorted uniform
    cloud distances, uniform cloud reddenings (or template rescalings).
    """
    u = np.asarray(u)
    x = np.array(u)

    pb_mean, pb_std, pb_low, pb_high = pb_params
    a = (pb_low - pb_mean) / pb_std
    b = (pb_high - pb_mean) / pb_std
    x[0] = np.exp(truncnorm.ppf(u[0], a, b, loc=pb_mean, scale=pb_std))

    s_mean, s_std, s_low, s_high = s_params
    a = (s_low - s_mean) / s_std
    b = (s_high - s_mean) / s_std
    x[1] = np.exp(truncnorm.ppf(u[1], a, b, loc=s_mean, scale=s_std))
    x[2] = np.exp(truncnorm.ppf(u[2], a, b, loc=s_mean, scale=s_std))

    ns = 2
    # sorted cloud distances
    x[ns + 2::2] = np.sort(u[ns + 2::2]) * (dlims[1] - dlims[0]) + dlims[0]
    # foreground reddening
    x[ns + 1] = u[ns + 1] * (rlims[1] - rlims[0]) + rlims[0]
    # cloud reddenings, tied to the distance ordering
    dsort = np.argsort(u[ns + 2::2])
    if dust_template:
        x[ns + 3::2] = (u[ns + 3::2][dsort] * (nlims[1] - nlims[0])
                        + nlims[0])
    else:
        x[ns + 3::2] = (u[ns + 3::2][dsort] * (rlims[1] - rlims[0])
                        + rlims[0])
    return x


def _as(like, x):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def kernel_tophat(reds, kmean, kwidth):
    """Top-hat log-kernel (mirrors `los.kernel_tophat`; reference
    `brutus/los.py:251-282`)."""
    kmean, kwidth = _as(reds, kmean), _as(reds, kwidth)
    inb = (reds >= kmean - kwidth) & (reds < kmean + kwidth)
    return torch.where(inb, -torch.log(2.0 * kwidth),
                       torch.full_like(reds, -math.inf))


def kernel_gauss(reds, kmean, kstd):
    """Gaussian log-kernel (mirrors `los.kernel_gauss`; reference
    `brutus/los.py:285-312`)."""
    kmean, kstd = _as(reds, kmean), _as(reds, kstd)
    return (-0.5 * ((reds - kmean) / kstd) ** 2
            - torch.log(math.sqrt(2.0 * math.pi) * kstd))


def kernel_lorentz(reds, kmean, khwhm):
    """Lorentzian log-kernel (mirrors `los.kernel_lorentz`; reference
    `brutus/los.py:315-342`)."""
    kmean, khwhm = _as(reds, kmean), _as(reds, khwhm)
    return (-torch.log1p(((reds - kmean) / khwhm) ** 2)
            - torch.log(math.pi * khwhm))


_KERNELS = {"tophat": kernel_tophat, "gauss": kernel_gauss,
            "lorentz": kernel_lorentz}


def _los_loglike_core(reds, dists, pb, rsmooth0, rsmooth, ds, rs,
                      template_reds=None, kernel="gauss",
                      rlims=(0.0, 6.0), additive_foreground=False):
    """The cloud model's log-likelihood for a batch of parameter sets
    (mirrors `los._los_loglike_core`, batched over its first axis).

    reds : (W, C+1) foreground + per-cloud reddenings.
    dists : (W, C) sorted cloud distances.  pb, rsmooth0, rsmooth : (W,).
    ds, rs : (Nobj, Ndraw) draws, of the parameters' type;
    template_reds : (Nobj,).
    Returns (W,).
    """
    W = reds.shape[0]
    group = max(1, BLOCK_ELEMENTS // rs.numel())
    if W > group:
        return torch.cat([_los_loglike_core(
            reds[i:i + group], dists[i:i + group], pb[i:i + group],
            rsmooth0[i:i + group], rsmooth[i:i + group], ds, rs,
            template_reds, kernel, rlims, additive_foreground)
            for i in range(0, W, group)])
    kern = _KERNELS[kernel]
    area = rlims[1] - rlims[0]
    n_obj, n_draw = rs.shape

    # The segment [0, d_1), [d_1, d_2), ..., [d_C, 1e10) of each draw:
    # the number of clouds at or before it; a draw in none gets -inf.
    seg = torch.zeros((W, n_obj, n_draw), dtype=torch.int64,
                      device=rs.device)
    for c in range(dists.shape[1]):
        seg += ds[None] >= dists[:, c, None, None]
    inside = (ds >= 0.0) & (ds < 1e10)
    flat = seg.view(W, -1)
    mean = torch.gather(reds, 1, flat).view(seg.shape)
    if template_reds is not None:
        mean = torch.where(seg > 0, mean * template_reds[None, :, None],
                           mean)
    if additive_foreground:
        mean = torch.where(seg > 0, mean + reds[:, :1, None], mean)
    sig = torch.where(seg > 0, rsmooth[:, None, None],
                      rsmooth0[:, None, None])
    logw = torch.where(inside, kern(rs[None], mean, sig),
                       torch.full_like(mean, -math.inf))

    # Marginalize over the draws per star, then the outlier mixture.
    logls = torch.logsumexp(logw, dim=2) - math.log(n_draw)
    logls = torch.logaddexp(torch.log1p(-pb)[:, None] + logls,
                            (torch.log(pb) - math.log(area))[:, None])
    return logls.sum(dim=1)


def LOS_clouds_loglike_samples(theta, dsamps, rsamps, kernel="gauss",
                               rlims=(0.0, 6.0), template_reds=None,
                               Ndraws=25, additive_foreground=False,
                               monotonic=True, device=None):
    """Log-likelihood of the cumulative-reddening cloud model (mirrors
    `los.LOS_clouds_loglike_samples`; reference `brutus/los.py:119-248`:
    the same parameterization, kernels, outlier mixture and
    monotonicity rejection), in float64 on the card.

    `kernel` is "gauss", "tophat", "lorentz" or a callable
    `kernel(rs, (mean, sigma))` of float64 tensors on the card (`rs`
    the `(Nobj, Ndraws)` reddening draws) returning log-weights.
    """
    if kernel not in _KERNELS and not callable(kernel):
        raise ValueError(f"invalid kernel {kernel!r}")
    dev = resolve_device(device)

    theta = np.asarray(theta, dtype=float)
    pb, s0, s = theta[0], theta[1], theta[2]
    reds = np.atleast_1d(theta[3::2])
    dists = np.atleast_1d(theta[4::2])

    if not np.all(np.sort(dists) == dists):
        raise ValueError("Distances must be monotonically increasing.")
    if monotonic and not np.all(np.sort(reds) == reds):
        return -np.inf

    area = rlims[1] - rlims[0]
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=dev)
    ds = t(np.asarray(dsamps)[:, :Ndraws])
    rs = t(np.asarray(rsamps)[:, :Ndraws])
    treds = None if template_reds is None else t(template_reds)

    if callable(kernel) and not isinstance(kernel, str):
        # Custom kernel: cloud by cloud, `kernel(reds, (mean, sigma))`.
        xlo = np.concatenate([[0.0], dists])
        xhi = np.concatenate([dists, [1e10]])
        sig = np.concatenate([[s0 * area],
                              np.full(len(reds) - 1, s * area)])
        logw = []
        for c in range(len(reds)):
            mean_c = float(reds[c]) * (torch.ones_like(rs) if treds is None
                                       or c == 0 else treds[:, None])
            if additive_foreground and c > 0:
                mean_c = mean_c + float(reds[0])
            lw = torch.as_tensor(kernel(rs, (mean_c, sig[c])),
                                 dtype=torch.float64, device=dev)
            logw.append(torch.where((ds >= xlo[c]) & (ds < xhi[c]), lw,
                                    torch.full_like(rs, -math.inf)))
        logls = (torch.logsumexp(torch.stack(logw), dim=(0, 2))
                 - math.log(rs.shape[1]))
        logls = torch.logaddexp(math.log1p(-pb) + logls,
                                torch.full_like(logls, math.log(pb)
                                                - math.log(area)))
        return float(logls.sum())

    out = _los_loglike_core(
        t(reds)[None], t(dists)[None], t([pb]), t([s0 * area]),
        t([s * area]), ds, rs, template_reds=treds, kernel=kernel,
        rlims=tuple(rlims), additive_foreground=additive_foreground)
    return float(out[0])


# ---------------------------------------------------------------------------
# Fitting the cloud model
# ---------------------------------------------------------------------------

def _prior_transform(u, rlims, dlims, pb_params, s_params, dust_template,
                     nlims):
    """`LOS_clouds_priortransform` on a tensor `u (..., ndim)` (mirrors
    `los._prior_transform_jax`: the truncated-log-normal ppf through
    `ndtri` and the normal CDF).  Returns `pb, s0, s, fg, dists,
    creds`."""

    def trunc_lognorm_ppf(q, mean, std, lo, hi):
        a, b = torch.special.ndtr(torch.tensor(
            [(lo - mean) / std, (hi - mean) / std], dtype=torch.float64,
            device=q.device)).to(q.dtype)
        return torch.exp(mean + std * torch.special.ndtri(a + q * (b - a)))

    pb = trunc_lognorm_ppf(u[..., 0], *pb_params)
    s0 = trunc_lognorm_ppf(u[..., 1], *s_params)
    s = trunc_lognorm_ppf(u[..., 2], *s_params)
    fg = u[..., 3] * (rlims[1] - rlims[0]) + rlims[0]
    ud, order = torch.sort(u[..., 4::2], dim=-1, stable=True)
    dists = ud * (dlims[1] - dlims[0]) + dlims[0]
    ur_sorted = torch.gather(u[..., 5::2], -1, order)
    lo, hi = nlims if dust_template else rlims
    creds = ur_sorted * (hi - lo) + lo
    return pb, s0, s, fg, dists, creds


def _theta_from_u(kept_u, rlims, dlims, pbp, ssp, dust_template, nlims,
                  dev):
    """Bulk unit-cube -> theta transform on the card, in the type of
    `kept_u` (mirrors `los._theta_from_u`), returning the reference's
    theta layout `[pb, s0, s, fg_red, d1, r1, d2, r2, ...]` as numpy."""
    u = torch.as_tensor(np.asarray(kept_u), device=dev)
    pb, s0, s, fg, dists, creds = _prior_transform(
        torch.clamp(u, 1e-6, 1 - 1e-6), rlims, dlims, pbp, ssp,
        dust_template, nlims)
    dr = torch.stack([dists, creds], dim=-1).reshape(
        *dists.shape[:-1], 2 * dists.shape[-1])
    return torch.cat([torch.stack([pb, s0, s, fg], dim=-1), dr],
                     dim=-1).cpu().numpy()


def fit_clouds(dsamps, rsamps, n_clouds, kernel="gauss",
               rlims=(0.0, 6.0), dlims=(4.0, 19.0),
               pb_params=(-3.0, 0.7, -np.inf, 0.0),
               s_params=(-3.0, 0.3, -np.inf, 0.0),
               template_reds=None, additive_foreground=False,
               monotonic=True, Ndraws=25,
               n_walkers=64, n_steps=1500, n_burn=750, stretch_a=2.0,
               seed=0, max_samples=4000, return_chain=False,
               evidence=False, n_temps=16, beta_power=5.0, device=None):
    """Fit the N-cloud LOS extinction model with the ensemble sampler of
    `sampling` (mirrors `brutus_tpu.los.fit_clouds`, the same
    parameters and outputs).

    Sampling happens in the prior unit cube (the prior transform maps to
    parameters); out-of-cube proposals and non-monotonic reddening
    profiles are rejected (reference `los.py:200-203`).  The walkers,
    the draws and the likelihood are float32, as the JAX package's
    are.
    `evidence=True` runs the `n_temps`-rung power-posterior ladder and
    adds `logz`, `logz_err` and `logz_ti`; its beta=1 rung gives the
    samples.  The walkers draw from a `torch.Generator` on the card
    seeded with `seed`, so chains match the JAX package's as
    distributions.

    Returns
    -------
    dict with `samples (n_kept, ndim)` in the reference's theta layout
    `[pb, s0, s, fg_red, d1, r1, d2, r2, ...]` (thinned to at most
    `max_samples` rows), `logl (n_kept,)`, `map_theta`, `acceptance`,
    per-parameter `tau`, `ess` and split-chain `rhat`; with
    `return_chain=True` also `chain (n_steps - n_burn, n_walkers, ndim)`
    in theta space and `chain_logl`.
    """
    from .sampling import (chain_diagnostics, default_beta_ladder,
                           ensemble_sample, evidence_from_ladder,
                           tempered_ensemble_sample)

    if kernel not in _KERNELS:
        raise ValueError(f"invalid kernel {kernel!r}")
    dev = resolve_device(device)
    area = rlims[1] - rlims[0]
    ndim = 4 + 2 * n_clouds
    dust_template = template_reds is not None
    nlims = (0.2, 2.0)

    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                    device=dev)
    ds = f32(np.asarray(dsamps)[:, :Ndraws])
    rs = f32(np.asarray(rsamps)[:, :Ndraws])
    treds = f32(template_reds) if dust_template else None
    pbp = tuple(float(x) for x in pb_params)
    ssp = tuple(float(x) for x in s_params)

    def logpost(u, ds, rs):
        """(W, ndim) unit-cube positions -> (W,) log-posteriors."""
        inb = ((u > 0.0) & (u < 1.0)).all(dim=-1)
        uc = torch.clamp(u, 1e-6, 1.0 - 1e-6)
        pb, s0, s, fg, dists, creds = _prior_transform(
            uc, rlims, dlims, pbp, ssp, dust_template, nlims)
        reds = torch.cat([fg[:, None], creds], dim=-1)
        ll = _los_loglike_core(
            reds, dists, pb, s0 * area, s * area, ds, rs,
            template_reds=treds, kernel=kernel, rlims=tuple(rlims),
            additive_foreground=additive_foreground)
        if monotonic:
            # Reference rejection of non-monotonic profiles
            # (los.py:200-203); pass monotonic=False in template mode.
            ok = (torch.diff(reds, dim=-1) >= 0.0).all(dim=-1)
            inb = inb & ok
        return torch.where(inb, ll, torch.full_like(ll, -math.inf))

    ev = None
    if evidence:
        betas = default_beta_ladder(n_temps, power=beta_power)
        trun = tempered_ensemble_sample(
            logpost, ndim, betas, n_walkers=n_walkers, n_steps=n_steps,
            stretch_a=stretch_a, seed=seed, logl_args=(ds, rs), device=dev,
            dtype=torch.float32)
        ev = evidence_from_ladder(betas,
                                  trun["logl"][:, n_burn:].cpu().numpy())
        # The beta=1 rung IS an ordinary posterior chain: reuse it.
        run = dict(chain=trun["chain"][-1], logp=trun["logl"][-1],
                   accept=trun["accept"][-1])
    else:
        run = ensemble_sample(logpost, ndim, n_walkers=n_walkers,
                              n_steps=n_steps, stretch_a=stretch_a,
                              seed=seed, logpost_args=(ds, rs), device=dev,
                              dtype=torch.float32)
    chain_u = run["chain"][n_burn:].cpu().numpy()
    chain_lp = run["logp"][n_burn:].cpu().numpy()
    diag = chain_diagnostics(chain_u,
                             accept=run["accept"][n_burn:].cpu().numpy())

    kept_u = chain_u.reshape(-1, ndim)
    kept_lp = chain_lp.reshape(-1)
    finite = np.isfinite(kept_lp)
    kept_u, kept_lp = kept_u[finite], kept_lp[finite]
    stride = (max(1, len(kept_u) // max_samples) if max_samples
              else 1)
    thetas = _theta_from_u(kept_u[::stride], rlims, dlims, pbp, ssp,
                           dust_template, nlims, dev)
    kept_lp = kept_lp[::stride]
    out = dict(samples=thetas, logl=kept_lp,
               map_theta=thetas[np.argmax(kept_lp)],
               acceptance=diag["acceptance"], tau=diag["tau"],
               ess=diag["ess"], rhat=diag["rhat"])
    if ev is not None:
        out["logz"] = ev["logz"]
        out["logz_err"] = ev["logz_err"]
        out["logz_ti"] = ev["logz_ti"]
    if return_chain:
        out["chain"] = _theta_from_u(chain_u, rlims, dlims, pbp, ssp,
                                     dust_template, nlims, dev)
        out["chain_logl"] = chain_lp
    return out


__all__ = ["LOS_clouds_priortransform", "LOS_clouds_loglike_samples",
           "fit_clouds",
           "kernel_tophat", "kernel_gauss", "kernel_lorentz"]
