"""
Posterior visualization (mirrors `brutus_tpu/plotting.py`).

Parity: reference `brutus/plotting.py` — `cornerplot`, `dist_vs_red`,
`posterior_predictive`, `photometric_offsets`, `photometric_offsets_2d`,
and the corner-style `_hist2d` contour helper, driven by the results
schema written by `fitting.BruteForce`.

The drawing is host-side matplotlib, as in the JAX package; matplotlib
is imported only inside the functions that draw, so the module and its
device helpers import without it.  What the JAX package computes with
jax runs on the card in float64: the posterior-predictive SEDs and
magnitudes (`ops.sed.get_seds`), the leave-one-band-out weights
(`utils.chi2_logpdf`) and `cornerplot_fit`'s draw regeneration
(`utils.draw_sar` on a `torch.Generator` seeded with `seed`, so the
draws match the JAX package's as a distribution).
"""

import numpy as np
import torch
from scipy.ndimage import gaussian_filter as norm_kde

from .utils import chi2_logpdf, magnitude, resolve_device
from .utils import quantile as _wquantile


def _quantile(x, q, weights=None):
    return _wquantile(np.asarray(x, np.float64), np.asarray(q, np.float64),
                      None if weights is None
                      else np.asarray(weights, np.float64)).numpy()


def _hist2d(x, y, ax=None, span=None, weights=None, levels=None,
            color="gray", plot_density=True, plot_contours=True,
            fill_contours=True, smooth=0.02, bins=100, **kwargs):
    """Corner-style smoothed 2-D histogram with sigma-level contours.

    Parity: reference `brutus/plotting.py:1386-1602` (same default
    0.5/1/1.5/2-sigma levels and density shading).
    """
    import matplotlib.pyplot as plt
    if ax is None:
        ax = plt.gca()
    if levels is None:
        levels = 1.0 - np.exp(-0.5 * np.arange(0.5, 2.1, 0.5) ** 2)
    if span is None:
        span = [[x.min(), x.max()], [y.min(), y.max()]]
    H, xe, ye = np.histogram2d(x, y, bins=bins, range=span,
                               weights=weights)
    if smooth is not None:
        sx = smooth * H.shape[0] if smooth < 1 else smooth
        sy = smooth * H.shape[1] if smooth < 1 else smooth
        H = norm_kde(H, (sx, sy))
    # Convert density levels to histogram thresholds.
    Hflat = np.sort(H.ravel())[::-1]
    cum = np.cumsum(Hflat)
    cum /= cum[-1]
    V = np.array([Hflat[np.searchsorted(cum, lv)]
                  if lv < 1 else Hflat[-1] for lv in levels])
    V.sort()
    V = np.unique(V)
    xc = 0.5 * (xe[1:] + xe[:-1])
    yc = 0.5 * (ye[1:] + ye[:-1])
    if plot_density:
        ax.pcolormesh(xe, ye, H.T, cmap="Greys", shading="auto",
                      rasterized=True)
    if plot_contours and len(V) > 1:
        if fill_contours:
            ax.contourf(xc, yc, H.T, np.concatenate([V, [H.max() * 1.01]]),
                        colors=None, cmap="Greys", alpha=0.6)
        ax.contour(xc, yc, H.T, V, colors=color, **kwargs)
    ax.set_xlim(span[0])
    ax.set_ylim(span[1])
    return ax


def cornerplot(samples, labels=None, weights=None, span=None,
               quantiles=(0.16, 0.5, 0.84), truths=None, fig=None,
               color="black", smooth=0.02, bins=50,
               show_titles=True, title_fmt=".2f", title_quantiles=None,
               hist_kwargs=None, hist2d_kwargs=None,
               truth_color="crimson", truth_kwargs=None,
               label_kwargs=None, title_kwargs=None,
               max_n_ticks=5, top_ticks=False, verbose=False,
               **kwargs):
    """Corner plot of posterior samples.

    Parity: reference `brutus/plotting.py:38-520` (`cornerplot`),
    generalized to any `(ndim, nsamps)` sample array — the reference's
    usage passes stellar labels + derived dist/Av/Rv per star.

    Per-panel styling (reference kwargs): `span` entries may be
    `(lo, hi)` bounds OR a float fraction `q` (the central `q`-mass
    interval, e.g. `0.95`); `quantiles` draws dashed lines on the
    diagonal; `title_quantiles` (default = `quantiles`) feeds the
    `show_titles` summaries; `hist_kwargs` / `hist2d_kwargs` pass
    through to the diagonal histogram / off-diagonal `_hist2d`;
    `truth_color` + `truth_kwargs` style the truth lines;
    `label_kwargs` / `title_kwargs` style axis labels / titles;
    `max_n_ticks` / `top_ticks` control tick placement; `verbose`
    prints the title quantiles per parameter.
    """
    import matplotlib.pyplot as plt
    from matplotlib.ticker import MaxNLocator

    samples = np.atleast_2d(np.asarray(samples))
    if samples.shape[0] > samples.shape[1]:
        samples = samples.T
    ndim, nsamps = samples.shape
    if labels is None:
        labels = [f"x{i}" for i in range(ndim)]
    hist_kwargs = dict(hist_kwargs or {})
    hist2d_kwargs = dict(hist2d_kwargs or {})
    truth_kwargs = {"lw": 1.5, **(truth_kwargs or {})}
    label_kwargs = dict(label_kwargs or {})
    title_kwargs = {"fontsize": 9, **(title_kwargs or {})}
    if title_quantiles is None:
        title_quantiles = (quantiles if quantiles
                           and len(quantiles) == 3 else (0.16, 0.5, 0.84))
    # Span entries: missing -> 0.999 mass; float q -> central q mass;
    # else explicit (lo, hi)  (reference plotting.py:214-230).
    if span is None:
        span = [0.999] * ndim
    span = list(span)
    for i, s in enumerate(span):
        if s is None:
            s = 0.999
        if np.ndim(s) == 0:
            q = 0.5 * (1.0 - float(s))
            lo, hi = _quantile(samples[i], [q, 1.0 - q], weights)
            span[i] = [lo, hi if hi > lo else lo + 1e-10]
        else:
            span[i] = [s[0], s[1]]

    if fig is None:
        fig, axes = plt.subplots(ndim, ndim,
                                 figsize=(2.2 * ndim, 2.2 * ndim))
    else:
        axes = np.asarray(fig.axes).reshape(ndim, ndim)
    axes = np.atleast_2d(axes)

    for i in range(ndim):
        for j in range(ndim):
            ax = axes[i, j]
            if j > i:
                ax.axis("off")
                continue
            if max_n_ticks:
                ax.xaxis.set_major_locator(
                    MaxNLocator(max_n_ticks, prune="lower"))
            if i == j:
                h, edges = np.histogram(samples[i], bins=bins,
                                        range=span[i], weights=weights)
                ax.stairs(h, edges, color=hist_kwargs.pop("color", color),
                          **{k: v for k, v in hist_kwargs.items()
                             if k != "color"})
                if quantiles:
                    for q in _quantile(samples[i], quantiles, weights):
                        ax.axvline(q, ls="--", color=color, lw=1)
                if truths is not None and truths[i] is not None:
                    ax.axvline(truths[i], color=truth_color,
                               **truth_kwargs)
                qlo, qmid, qhi = _quantile(samples[i], title_quantiles,
                                           weights)
                if verbose:
                    print(f"{labels[i]}: {qmid:{title_fmt}} "
                          f"+{qhi - qmid:{title_fmt}} "
                          f"-{qmid - qlo:{title_fmt}}")
                if show_titles:
                    ax.set_title(f"{labels[i]} = {qmid:{title_fmt}}"
                                 f"$^{{+{qhi - qmid:{title_fmt}}}}"
                                 f"_{{-{qmid - qlo:{title_fmt}}}}$",
                                 **title_kwargs)
                ax.set_yticks([])
                ax.set_xlim(span[i])
                if top_ticks:
                    ax.xaxis.set_ticks_position("top")
            else:
                h2 = dict(kwargs)
                h2.update(hist2d_kwargs)
                _hist2d(samples[j], samples[i], ax=ax,
                        span=[span[j], span[i]], weights=weights,
                        smooth=smooth, bins=bins,
                        color=h2.pop("color", color), **h2)
                if truths is not None:
                    if truths[j] is not None:
                        ax.axvline(truths[j], color=truth_color,
                                   **truth_kwargs)
                    if truths[i] is not None:
                        ax.axhline(truths[i], color=truth_color,
                                   **truth_kwargs)
            if i == ndim - 1:
                ax.set_xlabel(labels[j], **label_kwargs)
            if j == 0 and i > 0:
                ax.set_ylabel(labels[i], **label_kwargs)
    fig.tight_layout()
    return fig, axes


def dist_vs_red(data, ebv=False, dist_type="distance_modulus",
                parallax=None, parallax_err=None, cmap="magma",
                bins=(750, 300), span=None, smooth=0.01, ax=None,
                weights=None, device=None, **kwargs):
    """Smoothed 2-D distance-reddening posterior for one star (mirrors
    `plotting.dist_vs_red`).

    Parity: reference `brutus/plotting.py:523-776`; accepts saved
    `(dists, reds, dreds)` draws for one object, binned on `device`.
    """
    import matplotlib.pyplot as plt
    from .pdf import bin_pdfs_distred
    dists, reds, dreds = [np.atleast_2d(np.asarray(v)) for v in data]
    pdfs, xe, ye = bin_pdfs_distred(
        (dists, reds, dreds), ebv=ebv, dist_type=dist_type, bins=bins,
        span=span, smooth=smooth,
        parallaxes=(None if parallax is None else np.atleast_1d(parallax)),
        parallax_errors=(None if parallax_err is None
                         else np.atleast_1d(parallax_err)), device=device)
    if ax is None:
        ax = plt.gca()
    ax.pcolormesh(xe, ye, pdfs[0].T, cmap=cmap, shading="auto",
                  rasterized=True, **kwargs)
    labels = {"scale": "scale $s$", "parallax": r"parallax [mas]",
              "distance": "distance [kpc]",
              "distance_modulus": r"$\mu$ [mag]"}
    ax.set_xlabel(labels[dist_type])
    ax.set_ylabel(r"$E(B-V)$ [mag]" if ebv else r"$A_V$ [mag]")
    return ax, (pdfs[0], xe, ye)


def posterior_predictive(models, idxs, reds, dreds, dists, data=None,
                         data_err=None, data_mask=None, offset=None,
                         labels=None, vcolor="blue", pcolor="black",
                         ax=None, device=None, **kwargs):
    """Posterior-predictive SED check: model flux distributions per band
    against the observed photometry (mirrors
    `plotting.posterior_predictive`; the SEDs on `device`).

    Parity: reference `brutus/plotting.py:779-936`.
    """
    import matplotlib.pyplot as plt
    from .offsets import _model_fluxes
    seds = _model_fluxes(models, idxs, reds, dreds, dists,
                         resolve_device(device)).cpu().numpy()
    n_filt = seds.shape[1]
    if offset is not None:
        seds = seds * np.asarray(offset)
    if ax is None:
        ax = plt.gca()
    parts = ax.violinplot([seds[:, i] for i in range(n_filt)],
                          positions=np.arange(n_filt), widths=0.8,
                          showextrema=False)
    for pc in parts["bodies"]:
        pc.set_facecolor(vcolor)
        pc.set_alpha(0.5)
    if data is not None:
        mask = (np.ones(n_filt, bool) if data_mask is None
                else np.asarray(data_mask, bool))
        x = np.arange(n_filt)[mask]
        ax.errorbar(x, np.asarray(data)[mask],
                    yerr=(None if data_err is None
                          else np.asarray(data_err)[mask]),
                    fmt="o", color=pcolor, capsize=3)
    if labels is not None:
        ax.set_xticks(np.arange(n_filt))
        ax.set_xticklabels(labels, rotation=45, ha="right")
    ax.set_ylabel("flux density")
    return ax


def _posterior_predictive_mags(models, idxs, reds, dreds, dists,
                               device=None):
    """Posterior-predictive apparent magnitudes `(Nobj, Nsamps, Nfilt)`
    in float64 on `device` (mirrors `plotting._posterior_predictive_mags`;
    reference `brutus/plotting.py:1073-1077`)."""
    from .offsets import _model_fluxes
    return _model_fluxes(models, idxs, reds, dreds, dists,
                         resolve_device(device), flux=False).cpu().numpy()


def _leave_band_weights(magobs, mageobs, mask, mpred, band, dim_prior=True,
                        device=None):
    """Per-sample posterior weights recomputed with `band` excluded, in
    float64 on `device` (mirrors `plotting._leave_band_weights`).

    Parity: reference `brutus/plotting.py:1100-1116` (leave-one-band-out
    `phot_loglike` reweighting), vectorized over objects x samples: the
    chi-square sums skip NaN terms and a non-finite log-likelihood
    counts as -1e300.  Returns `(selection, weights)` of shapes
    `(Nobj,)`, `(Nobj, Nsamps)` as numpy.
    """
    dev = resolve_device(device)
    mask = np.asarray(mask, bool)
    mtemp = np.array(mask, bool)
    mtemp[:, band] = False
    sel = (mask[:, band] & (mtemp.sum(axis=1) > 3)
           & np.all(np.isfinite(np.where(mask, magobs, 0.0)), axis=1))
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=dev)
    mt = torch.as_tensor(mtemp, device=dev)
    var = torch.where(mt, t(mageobs), 1.0)[:, None, :] ** 2
    resid = torch.where(mt[:, None, :],
                        torch.where(mt, t(magobs), 0.0)[:, None, :]
                        - t(mpred), 0.0)
    chi2 = torch.nansum(resid ** 2 / var, dim=2)        # (Nobj, Nsamps)
    if dim_prior:
        dof = t(np.maximum(mtemp.sum(axis=1) - 3, 1))
        lnl = chi2_logpdf(chi2, dof[:, None])
    else:
        lnl = -0.5 * chi2
    lnl = torch.where(torch.isfinite(lnl), lnl, -1e300)
    wt = torch.exp(lnl - torch.logsumexp(lnl, dim=1, keepdim=True))
    wt = wt / wt.sum(dim=1, keepdim=True)
    return sel, wt.cpu().numpy()


def photometric_offsets(phot, err, mask, models, idxs, reds, dreds, dists,
                        x=None, flux=True, weights=None, bins=100,
                        offset=None, dim_prior=True, plot_thresh=0.0,
                        cmap="viridis", xspan=None, yspan=None, titles=None,
                        xlabel=None, plot_kwargs=None, fig=None,
                        device=None):
    """Per-band panels of photometric offsets `mag_pred - mag_obs`
    (mirrors `plotting.photometric_offsets`; the magnitudes and weights
    on `device`).

    Parity: reference `brutus/plotting.py:939-1145`: posterior-predictive
    magnitudes per draw, observed data reweighted by the leave-one-band-out
    likelihood, one 2-D histogram panel of `Delta mag` vs `x` (default:
    observed magnitude) per band in a 5-column grid.
    """
    phot, err, mask = [np.asarray(v) for v in (phot, err, mask)]
    mask = mask.astype(bool)
    idxs = np.asarray(idxs)
    n_obj, n_samp = idxs.shape
    n_filt = models.shape[1]
    if plot_kwargs is None:
        plot_kwargs = {}
    if weights is None:
        weights = np.ones((n_obj, n_samp))
    elif np.ndim(weights) == 1:
        weights = np.repeat(weights, n_samp).reshape(n_obj, n_samp)
    bins = ([bins] * n_filt if np.isscalar(bins) else list(bins))
    if titles is None:
        titles = [f"Band {i}" for i in range(n_filt)]
    if offset is None:
        offset = np.ones(n_filt)

    mpred = _posterior_predictive_mags(models, idxs, reds, dreds, dists,
                                       device)
    with np.errstate(all="ignore"):
        if flux:
            magobs, mageobs = [np.asarray(v) for v in
                               magnitude(phot * offset, err * offset)]
        else:
            magobs, mageobs = phot + offset, err

    import matplotlib.pyplot as plt
    if fig is None:
        ncols = 5
        nrows = (n_filt - 1) // ncols + 1
        fig, axes = plt.subplots(nrows, ncols,
                                 figsize=(ncols * 6, nrows * 5),
                                 squeeze=False)
    else:
        fig, axes = fig
    ax = np.asarray(axes).ravel()

    for i in range(n_filt):
        s, wt = _leave_band_weights(magobs, mageobs, mask, mpred, i,
                                    dim_prior=dim_prior, device=device)
        mobs = np.repeat(magobs[s, i], n_samp)
        if x is None:
            xp = mobs
        elif np.shape(x) == (n_obj, n_samp):
            xp = np.asarray(x)[s].ravel()
        else:
            xp = np.repeat(np.asarray(x)[s], n_samp)
        mp = mpred[s, :, i].ravel()
        w = (weights[s] * wt[s]).ravel()
        good = np.isfinite(xp) & np.isfinite(mp - mobs)
        if good.sum() < 2:
            continue
        if xspan is None:
            xlo, xhi = _quantile(xp[good], [0.02, 0.98], w[good])
        else:
            xlo, xhi = xspan[i]
        if yspan is None:
            ylo, yhi = _quantile((mp - mobs)[good], [0.02, 0.98], w[good])
        else:
            ylo, yhi = yspan[i]
        bx = np.linspace(xlo, xhi, bins[i] + 1)
        by = np.linspace(min(ylo, -1e-10), max(yhi, 1e-10), bins[i] + 1)
        ax[i].hist2d(xp[good], (mp - mobs)[good], bins=(bx, by),
                     weights=w[good], cmin=plot_thresh or None, cmap=cmap,
                     **plot_kwargs)
        ax[i].set_xlabel(xlabel if xlabel else
                         (titles[i] if x is None else "Label"))
        ax[i].set_title(titles[i])
        ax[i].set_ylabel(r"$\Delta\,$mag")
    for i in range(n_filt, ax.size):
        ax[i].set_frame_on(False)
        ax[i].set_xticks([])
        ax[i].set_yticks([])
    fig.tight_layout()
    return fig, axes


def photometric_offsets_2d(phot, err, mask, models, idxs, reds, dreds,
                           dists, x, y, flux=True, weights=None, bins=30,
                           offset=None, dim_prior=True, plot_thresh=10,
                           clims=(-0.05, 0.05), show_off=True,
                           cmap="coolwarm", xspan=None, yspan=None,
                           titles=None, xlabel=None, ylabel=None,
                           plot_kwargs=None, fig=None, device=None):
    """Per-band 2-D maps of the weighted-median `mag_pred - mag_obs`
    binned over `(x, y)` (e.g. sky position or color-magnitude; mirrors
    `plotting.photometric_offsets_2d`, the magnitudes and weights on
    `device`).

    Parity: reference `brutus/plotting.py:1148-1383`.
    """
    phot, err, mask = [np.asarray(v) for v in (phot, err, mask)]
    mask = mask.astype(bool)
    idxs = np.asarray(idxs)
    x, y = np.asarray(x, float), np.asarray(y, float)
    n_obj, n_samp = idxs.shape
    n_filt = models.shape[1]
    if plot_kwargs is None:
        plot_kwargs = {}
    if weights is None:
        weights = np.ones((n_obj, n_samp))
    elif np.ndim(weights) == 1:
        weights = np.repeat(weights, n_samp).reshape(n_obj, n_samp)
    bins = ([bins] * n_filt if np.isscalar(bins) else list(bins))
    if titles is None:
        titles = [f"Band {i}" for i in range(n_filt)]
    if offset is None:
        offset = np.ones(n_filt)
    elif show_off:
        titles = [f"{t} ({100.0 * (off - 1.0):2.2}% offset)"
                  for t, off in zip(titles, offset)]

    mpred = _posterior_predictive_mags(models, idxs, reds, dreds, dists,
                                       device)
    with np.errstate(all="ignore"):
        if flux:
            magobs, mageobs = [np.asarray(v) for v in
                               magnitude(phot * offset, err * offset)]
        else:
            magobs, mageobs = phot + offset, err
        dm = mpred - np.where(mask, magobs, np.nan)[:, None, :]

    import matplotlib.pyplot as plt
    if fig is None:
        ncols = 5
        nrows = (n_filt - 1) // ncols + 1
        fig, axes = plt.subplots(nrows, ncols,
                                 figsize=(ncols * 6, nrows * 5),
                                 squeeze=False)
    else:
        fig, axes = fig
    ax = np.asarray(axes).ravel()

    for i in range(n_filt):
        nb = bins[i]
        xb = (np.linspace(*xspan[i], nb + 1) if xspan is not None
              else np.linspace(np.nanmin(x), np.nanmax(x), nb + 1))
        yb = (np.linspace(*yspan[i], nb + 1) if yspan is not None
              else np.linspace(np.nanmin(y), np.nanmax(y), nb + 1))
        xloc = np.clip(np.digitize(x, xb) - 1, 0, nb - 1)
        yloc = np.clip(np.digitize(y, yb) - 1, 0, nb - 1)
        s, wt = _leave_band_weights(magobs, mageobs, mask, mpred, i,
                                    dim_prior=dim_prior, device=device)
        off2d = np.full((nb, nb), np.nan)
        flat = xloc * nb + yloc
        for b in np.unique(flat[s]):
            bsel = np.where(s & (flat == b))[0]
            if len(bsel) >= plot_thresh:
                offs = dm[bsel, :, i].ravel()
                w = (wt[bsel] * weights[bsel]).ravel()
                good = np.isfinite(offs)
                if good.any():
                    off2d[b // nb, b % nb] = _quantile(
                        offs[good], [0.5], w[good])[0]
        img = ax[i].imshow(off2d.T, origin="lower",
                           extent=(xb[0], xb[-1], yb[0], yb[-1]),
                           vmin=clims[0], vmax=clims[1], aspect="auto",
                           cmap=cmap, **plot_kwargs)
        ax[i].set_xlabel(xlabel or "X")
        ax[i].set_ylabel(ylabel or "Y")
        ax[i].set_title(titles[i])
        plt.colorbar(img, ax=ax[i], label=r"$\Delta\,$mag")
    for i in range(n_filt, ax.size):
        ax[i].set_frame_on(False)
        ax[i].set_xticks([])
        ax[i].set_yticks([])
    fig.tight_layout()
    return fig, axes


def cornerplot_fit(idxs, data, params, lndistprior=None, coord=None,
                   avlim=(0.0, 6.0), rvlim=(1.0, 8.0), weights=None,
                   parallax=None, parallax_err=None, Nr=500,
                   applied_parallax=True, pcolor="blue",
                   quantiles=(0.025, 0.5, 0.975), color="black",
                   span=None, smooth=0.02, bins=50, show_titles=True,
                   title_fmt=".2f", truths=None, fig=None, seed=0,
                   device=None, **kwargs):
    """Corner plot driven directly by `BruteForce.fit` outputs (mirrors
    `plotting.cornerplot_fit`).

    Parity: reference `brutus/plotting.py:38-520` (`cornerplot`):
    stellar labels come from `params[idxs]` (ignoring `agewt`), the
    `(Av, Rv, parallax, distance)` columns from the saved draws — or,
    when `data` is `(scales, avs, rvs, covs_sar)`, regenerated with
    `draw_sar` and reweighted by the distance (+ parallax) priors —
    and the parallax measurement is overlaid on the parallax panel.

    Parameters
    ----------
    idxs : (Nsamps,) resampled model indices for one star.
    data : `(dists, reds, dreds)` saved draws, or
        `(scales, avs, rvs, covs_sar)` per-draw MLE summaries.
    params : structured array of per-model labels (`models_labels`).

    Regenerated draws come from `draw_sar` on `device`, weighted by
    `lndistprior` (default `gal_lnprior` at `coord`; a custom one is
    called as `lndistprior(dists (Nsamps, Nr), coord)` on tensors of
    the card) and the parallax, and one is kept per model.
    """
    dev = resolve_device(device)
    idxs = np.asarray(idxs)
    labels = [n for n in params.dtype.names if n != "agewt"]
    samples = np.array([np.asarray(params[n], float)[idxs]
                        for n in labels])

    if len(data) == 3:
        ddraws, adraws, rdraws = [np.asarray(d, float) for d in data]
        pdraws = 1.0 / ddraws
    else:
        if lndistprior is None and coord is None:
            raise ValueError("`coord` must be passed if the default "
                             "distance prior is used")
        if applied_parallax and (parallax is None or parallax_err is None):
            raise ValueError("`parallax` and `parallax_err` must be "
                             "provided together")
        pdraws, ddraws, adraws, rdraws = _regenerate_draws(
            data, lndistprior, coord, avlim, rvlim,
            (parallax, parallax_err) if applied_parallax else None, Nr,
            seed, dev)

    samples = np.vstack([samples, adraws[None], rdraws[None],
                         pdraws[None], ddraws[None]])
    labels = labels + ["Av", "Rv", "Parallax", "Distance"]

    fig, axes = cornerplot(samples, labels=labels, weights=weights,
                           span=span, quantiles=quantiles, truths=truths,
                           fig=fig, color=color, smooth=smooth, bins=bins,
                           show_titles=show_titles, title_fmt=title_fmt,
                           **kwargs)
    # Parallax-measurement overlay (reference plotting.py:467-480).
    if parallax is not None and parallax_err is not None:
        i = labels.index("Parallax")
        ax = axes[i, i]
        xg = np.linspace(*ax.get_xlim(), 256)
        pdf = np.exp(-0.5 * ((xg - parallax) / parallax_err) ** 2)
        ymax = ax.get_ylim()[1]
        ax.fill_between(xg, pdf * ymax / max(pdf.max(), 1e-300),
                        color=pcolor, alpha=0.3)
    return fig, axes


def _regenerate_draws(data, lndistprior, coord, avlim, rvlim, plx, Nr,
                      seed, dev):
    """One `(parallax, distance, Av, Rv)` draw per saved model: `Nr`
    draws of its `(scale, av, rv, cov_sar)` from `pdf._regenerate`,
    weighted by the distance prior (+ the parallax `plx = (p, p_err)`),
    one kept (mirrors `brutus_tpu/plotting.py:504-535`)."""
    from .pdf import _regenerate
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    p, perr = (np.nan, np.nan) if plx is None else plx
    draws = _regenerate(
        gen, *(t(d)[None] for d in data), Nr, avlim, rvlim, lndistprior,
        None if coord is None else t(coord)[None], t([p]), t([perr]))
    pick = torch.multinomial(draws[-1][0], 1, generator=gen)
    return tuple(torch.gather(v[0], 1, pick)[:, 0].cpu().numpy()
                 for v in draws[:4])


__all__ = ["cornerplot", "cornerplot_fit", "dist_vs_red",
           "posterior_predictive", "photometric_offsets",
           "photometric_offsets_2d", "_hist2d"]
