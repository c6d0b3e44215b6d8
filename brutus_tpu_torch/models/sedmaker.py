"""
SED grid generation (mirrors `brutus_tpu/models/sedmaker.py`): the
producer of the `(Nmodel, Nfilt, 3)` coefficient grids that
`fitting.BruteForce` fits.

Parity: reference `brutus/seds.py:387-857` (`SEDmaker`): for every label
tuple `(mini, eep, feh, afe, smf)`, stellar parameters from the MIST
tracks, band photometry from the BC networks over a weighted `(Av, Rv)`
lattice, and the linear reddening coefficients `(mag, dAv, dRv)` per
band from weighted least squares.

The grid is evaluated in chunks on the device, in float64 unless the
caller asks otherwise: the Av weights `(1e-5 + Av)**-1` are squared in
the fit, so the weight at Av = 0 is 1e10.  The secondary of an
unresolved binary (the 50-step bisection of `get_eep` and its SED) is
computed only for the models whose labels allow one, which the host
knows from the labels; every output, NaN included, is the JAX
function's, which computes it for every model and masks it.
"""

import sys
import time

import numpy as np
import torch

from ..ops.interp import interp1d_monotone_bisect, interpn
from ..utils import add_mag
from .nn import FastNNPredictor
from .tracks import MISTtracks


def _wls_line(x, y, w):
    """Weighted straight-line fit `y ~ intercept + slope * x` along axis
    -2 of `y`, as `np.polyfit(x, y, 1, w=w)` (effective weights w**2)
    (mirrors `brutus_tpu.models.sedmaker._wls_line`).

    x, w : (N,); y : (..., N, B) -> slope, intercept : (..., B)
    """
    W = (w * w)[:, None]
    x_ = x[:, None]
    sw = torch.sum(W, dim=-2)
    swx = torch.sum(W * x_, dim=-2)
    swxx = torch.sum(W * x_ * x_, dim=-2)
    swy = torch.sum(W * y, dim=-2)
    swxy = torch.sum(W * x_ * y, dim=-2)
    denom = sw * swxx - swx * swx
    slope = (sw * swxy - swx * swy) / denom
    intercept = (swy * swxx - swx * swxy) / denom
    return slope, intercept


class SEDmaker(MISTtracks):
    """SED coefficient grids from MIST tracks and BC networks (mirrors
    `brutus_tpu.models.sedmaker.SEDmaker`; reference
    `brutus/seds.py:387-443`).

    The tracks come from `mistfile` or from their rows (`library`, as
    `MISTtracks` takes them), the networks from `nnfile` or a
    `FastNNPredictor` (`nn`).  Runs on `device` (CUDA unless the caller
    names another) in float64.
    """

    def __init__(self, filters=None, nnfile=None, mistfile=None,
                 predictions=None, ageweight=True, verbose=True,
                 device=None, library=None, nn=None):
        from ..filters import FILTERS
        self.filters = list(FILTERS if filters is None else filters)
        if verbose:
            sys.stderr.write(f"Filters: {self.filters}\n")
        super().__init__(mistfile=mistfile, predictions=predictions,
                         ageweight=ageweight, verbose=verbose, device=device,
                         library=library)
        self.FNNP = nn if nn is not None else FastNNPredictor(
            filters=self.filters, nnfile=nnfile, verbose=verbose,
            device=self.device)

    def _t(self, v):
        return torch.as_tensor(v, dtype=self.ygrid.dtype, device=self.device)

    # -- binary age-matching ----------------------------------------------

    def get_eep(self, loga, mini=1.0, eep=350.0, feh=0.0, afe=0.0,
                smf=1.0, tol=1e-3):
        """EEP of a secondary of mass `mini * smf` at the same age:
        monotone bisection of `loga(eep)` (the reference minimises per
        model, `seds.py:601-655`); NaN where the residual's square is
        `tol` or more.  Every argument broadcasts."""
        loga, mini, eep, feh, afe, smf = torch.broadcast_tensors(
            *[self._t(v) for v in (loga, mini, eep, feh, afe, smf)])
        eep_lo = torch.full_like(loga, float(self.gridpoints["eep"][0]))
        eep_hi = torch.full_like(loga, float(self.gridpoints["eep"][-1]))
        mini2 = mini * smf

        def f(e):
            labels = torch.stack([mini2, e, feh, afe], dim=-1)
            return interpn(self.xgrid, self._loga_grid, labels) - loga

        eep2 = interp1d_monotone_bisect(f, eep_lo, eep_hi)
        resid = f(eep2)
        return torch.where(resid ** 2 < tol, eep2,
                           torch.full_like(eep2, torch.nan))

    # -- single-model API (reference seds.py:445-599) ---------------------

    def get_sed(self, mini=1.0, eep=350.0, feh=0.0, afe=0.0, av=0.0,
                rv=3.3, smf=0.0, dist=1000.0, loga_max=10.14,
                eep_binary_max=480.0, tol=1e-3, mini_bound=0.5,
                apply_corr=True, corr_params=None, eep2=None,
                return_eep2=False, return_dict=True, **kwargs):
        """SED and parameters of one model, through the batched path
        (mirrors `brutus_tpu.models.sedmaker.SEDmaker.get_sed`)."""
        sed, params, params2, eep2_out = self._seds_batch(
            np.atleast_1d(mini), np.atleast_1d(eep), np.atleast_1d(feh),
            np.atleast_1d(afe), np.atleast_1d(smf),
            av=np.atleast_1d(av), rv=np.atleast_1d(rv), dist=dist,
            loga_max=loga_max, eep_binary_max=eep_binary_max,
            mini_bound=mini_bound, apply_corr=apply_corr,
            corr_params=corr_params, tol=tol,
            eep2=None if eep2 is None else np.atleast_1d(eep2))
        sed = sed[0, 0].cpu().numpy()
        p1 = params[0].cpu().numpy()
        p2 = params2[0].cpu().numpy()
        if return_dict:
            p1 = dict(zip(self.predictions, p1))
            p2 = dict(zip(self.predictions, p2))
        if return_eep2:
            return sed, p1, p2, float(eep2_out[0])
        return sed, p1, p2

    def _nn_sed(self, p, av, rv, dist):
        """SEDs `(N, L, F)` of the predictions `p (N, npred)` over the
        extinctions `av`, `rv` (`(L,)`, `(1, L)` or `(N, L)`)."""
        col = lambda name: p[:, self.predictions.index(name), None]
        return self.FNNP.sed(logt=col("logt"), logg=col("logg"),
                             feh_surf=col("feh_surf"), afe=col("afe_surf"),
                             logl=col("logl"), av=av, rv=rv, dist=dist)

    def _seds_batch(self, mini, eep, feh, afe, smf, av, rv, dist=1000.0,
                    loga_max=10.14, eep_binary_max=480.0, mini_bound=0.5,
                    apply_corr=True, corr_params=None, tol=1e-3,
                    eep2=None):
        """SEDs at per-model extinctions (mirrors
        `brutus_tpu.models.sedmaker.SEDmaker._seds_batch`).

        The labels are host arrays `(N,)` (the host picks the models
        that may have a secondary); `av`, `rv` are a lattice `(L,)`
        shared by every model, or `(N, L)`.  Returns `(seds (N, L, F),
        params (N, npred), params2, eep2 (N,))` as device tensors.
        """
        mini, eep, feh, afe, smf = (np.asarray(v, float)
                                    for v in (mini, eep, feh, afe, smf))
        labels = self._t(np.stack([mini, eep, feh, afe], axis=-1))
        params = self.get_predictions(labels, apply_corr=apply_corr,
                                      corr_params=corr_params)
        loga = params[:, self._ageidx]
        # A 1-D lattice is shared by every model, as JAX broadcasts it.
        av, rv = (torch.atleast_2d(self._t(v)) for v in (av, rv))

        # Primary SED; age gate (reference seds.py:556-564).
        sed = self._nn_sed(params, av, rv, dist)
        ok_age = (loga <= loga_max) & torch.isfinite(loga)
        nan = torch.full_like(sed, torch.nan)
        sed = torch.where(ok_age[:, None, None], sed, nan)

        # Unresolved binary companion (reference seds.py:565-590), only
        # for the models that may have one.
        mini_min = max(self.mini_bound, mini_bound)
        is_bin = smf > 0.0
        bin_ok = is_bin & (eep <= eep_binary_max) & (mini * smf >= mini_min)
        rows = np.flatnonzero(bin_ok)
        nan1 = torch.full_like(loga, torch.nan)
        params2 = torch.full_like(params, torch.nan)
        if eep2 is None:
            eep2 = nan1.clone()
            if len(rows):
                eep2[rows] = self.get_eep(
                    loga[rows], mini=mini[rows], eep=eep[rows],
                    feh=feh[rows], afe=afe[rows], smf=smf[rows], tol=tol)
        else:
            eep2 = torch.broadcast_to(self._t(eep2), loga.shape).clone()
        no_bin = torch.from_numpy(is_bin & ~bin_ok).to(self.device)
        sed = torch.where(no_bin[:, None, None], nan, sed)
        if len(rows):
            labels2 = torch.stack([self._t(mini[rows] * smf[rows]),
                                   eep2[rows], labels[rows, 2],
                                   labels[rows, 3]], dim=-1)
            p2 = self.get_predictions(labels2, apply_corr=apply_corr,
                                      corr_params=corr_params)
            pick = lambda v: v[rows] if v.shape[0] > 1 else v
            sed2 = self._nn_sed(p2, pick(av), pick(rv), dist)
            sed[rows] = add_mag(sed[rows], sed2)
            params2[rows] = p2
        return sed, params, params2, eep2

    # -- grid generation (reference seds.py:657-857) ----------------------

    def make_grid(self, mini_grid=None, eep_grid=None, feh_grid=None,
                  afe_grid=None, smf_grid=None, av_grid=None, av_wt=None,
                  rv_grid=None, rv_wt=None, dist=1000.0, loga_max=10.14,
                  eep_binary_max=480.0, mini_bound=0.5, apply_corr=True,
                  corr_params=None, chunk=8192, verbose=True, **kwargs):
        """`(mag, dAv, dRv)` coefficients over the label grid (mirrors
        `brutus_tpu.models.sedmaker.SEDmaker.make_grid`), into
        `grid_label`, `grid_param`, `grid_sed` and `grid_sel`.

        The default grids (reference seds.py:754-776): mini 0.5-2.0 in
        steps of 0.025 (61), EEP 202-454 in steps of 6 and 454-808 in
        steps of 2 (220), [Fe/H] -3.0 to -2.1 in steps of 0.1 and -2.0 to
        0.5 in steps of 0.05 (61), afe -0.2 to 0.6 in steps of 0.2 (5),
        single stars only: 4,093,100 label tuples.  The reference's
        818,620 models are these with one afe value (`afe_grid=[0.0]`).
        The extinction lattice is Av 0-1.5 in steps of 0.3 (6) by Rv
        2.4-4.2 in steps of 0.3 (7).

        Chunks of `chunk` models run on the device; each chunk's results
        are copied back while the next one is computed.
        """
        if mini_grid is None:
            mini_grid = np.arange(0.5, 2.0 + 1e-5, 0.025)
        if eep_grid is None:
            eep_grid = np.concatenate([np.arange(202.0, 454.0, 6.0),
                                       np.arange(454.0, 808.0 + 1e-5, 2.0)])
        if feh_grid is None:
            feh_grid = np.concatenate([np.arange(-3.0, -2.0, 0.1),
                                       np.arange(-2.0, 0.5 + 1e-5, 0.05)])
        if afe_grid is None:
            afe_grid = np.arange(-0.2, 0.6 + 1e-5, 0.2)
        if smf_grid is None:
            smf_grid = np.array([0.0])
        label_names = ["mini", "eep", "feh", "afe", "smf"]
        axes = np.meshgrid(mini_grid, eep_grid, feh_grid, afe_grid,
                           smf_grid, indexing="ij")
        grid_label = np.zeros(axes[0].size,
                              dtype=[(n, float) for n in label_names])
        for n, a in zip(label_names, axes):
            grid_label[n] = a.ravel()
        n_grid = len(grid_label)

        self.grid_label = grid_label
        self.grid_param = np.full(n_grid, np.nan, dtype=[
            (n, float) for n in self.predictions])
        self.grid_sed = np.full(n_grid, np.nan, dtype=[
            (n, float, 3) for n in self.filters])
        self.grid_sel = np.zeros(n_grid, dtype=bool)

        lattice, fit = extinction_lattice(self.device, av_grid, av_wt,
                                          rv_grid, rv_wt)
        opts = dict(dist=dist, loga_max=loga_max,
                    eep_binary_max=eep_binary_max, mini_bound=mini_bound,
                    apply_corr=apply_corr, corr_params=corr_params)
        nf, npred = len(self.filters), len(self.predictions)

        def consume(lo, hi, flat):
            coeffs, params, good = split_rows(flat, nf, npred)
            for i, name in enumerate(self.filters):
                self.grid_sed[name][lo:hi] = coeffs[:, i, :]
            for i, name in enumerate(self.predictions):
                self.grid_param[name][lo:hi] = params[:, i]
            self.grid_sel[lo:hi] = good

        fetch = _Fetch(self.device)
        t0 = time.time()
        for lo in range(0, n_grid, chunk):
            hi = min(lo + chunk, n_grid)
            g = grid_label[lo:hi]
            flat = self.grid_rows(g["mini"], g["eep"], g["feh"], g["afe"],
                                  g["smf"], lattice, fit, **opts)
            done = fetch.push((lo, hi), flat)
            if done is not None:
                consume(*done)
            if verbose:
                rate = (time.time() - t0) / hi
                sys.stderr.write(
                    f"\rConstructing grid {100.0 * hi / n_grid:6.3f}% "
                    f"({hi}/{n_grid}) (t/obj: {rate * 1e3:.3f} ms, "
                    f"est. remaining: {rate * (n_grid - hi):.1f} s)   ")
                sys.stderr.flush()
        done = fetch.push(None, None)
        if done is not None:
            consume(*done)
        if verbose:
            sys.stderr.write("\n")

    def grid_rows(self, mini, eep, feh, afe, smf, lattice, fit, **opts):
        """One chunk of `make_grid`, as one device matrix `(C, 3F + npred
        + 1)`: the intrinsic SED (Av = 0, Rv = 3.3), the Av and Rv
        coefficients, the predictions and the validity flag.

        `lattice, fit` are `extinction_lattice`'s: the Rv-major extinction
        lattice `(av, rv)` with (0, 3.3) appended, so the intrinsic SED is
        the last lattice column (the JAX function evaluates it in a
        second call at the same secondary EEPs; the values are the
        same), and `(av_grid, av_wt, rv_grid, rv_wt)` as tensors.
        """
        av_grid, av_wt, rv_grid, rv_wt = fit
        seds, params, _, _ = self._seds_batch(mini, eep, feh, afe, smf,
                                              av=lattice[0], rv=lattice[1],
                                              **opts)
        sed0 = seds[:, -1]
        C, nf = sed0.shape
        lat = seds[:, :-1].reshape(C, len(rv_grid), len(av_grid), nf)
        # Av fit at fixed Rv (slope per Rv), then the slope's own linear
        # trend in Rv (reference seds.py:828-832).
        av_slope, _ = _wls_line(av_grid, lat, av_wt)          # (C, Nrv, F)
        sedr, seda = _wls_line(rv_grid, av_slope, rv_wt)      # (C, F)
        good = (torch.all(torch.isfinite(sed0), dim=-1)
                & torch.all(torch.isfinite(params), dim=-1))
        return torch.cat([sed0, seda, sedr, params,
                          good[:, None].to(sed0.dtype)], dim=1)

    def to_hdf5(self, filepath):
        """Write the generated grid in the schema `io.load_models` reads
        (mirrors `brutus_tpu.models.sedmaker.SEDmaker.to_hdf5`)."""
        from ..io import save_models
        coeffs = np.stack([self.grid_sed[name] for name in self.filters],
                          axis=1)
        save_models(filepath, coeffs, self.grid_label, self.filters,
                    parameters=self.grid_param)


def split_rows(flat, nf, npred):
    """`grid_rows`' matrix on the host as `(coeffs (C, F, 3), params (C,
    npred), good (C,))`, the coefficients NaN where the model is not
    valid (what `make_grid` stores)."""
    good = flat[:, -1] > 0.5
    coeffs = np.stack([flat[:, :nf], flat[:, nf:2 * nf],
                       flat[:, 2 * nf:3 * nf]], axis=-1)
    coeffs[~good] = np.nan
    return coeffs, flat[:, 3 * nf:3 * nf + npred], good


def extinction_lattice(device, av_grid=None, av_wt=None, rv_grid=None,
                       rv_wt=None):
    """`make_grid`'s extinction lattice and fit weights on `device`, with
    the reference's defaults (seds.py:754-776): Av 0-1.5 in steps of 0.3
    weighted `(1e-5 + Av)**-1` (a pivot through Av = 0), Rv 2.4-4.2 in
    steps of 0.3 weighted `exp(-|Rv - 3.3| / 0.5)`.

    Returns `((av, rv), (av_grid, av_wt, rv_grid, rv_wt))`: the lattice
    `(1, Nrv * Nav + 1)`, Rv-major as the JAX function flattens it, then
    (Av, Rv) = (0, 3.3); and the fit's grids and weights.
    """
    if av_grid is None:
        av_grid = np.arange(0.0, 1.5 + 1e-5, 0.3)
        av_grid[-1] -= 1e-5
    if av_wt is None:
        av_wt = (1e-5 + av_grid) ** -1.0
    if rv_grid is None:
        rv_grid = np.arange(2.4, 4.2 + 1e-5, 0.3)
    if rv_wt is None:
        rv_wt = np.exp(-np.abs(rv_grid - 3.3) / 0.5)
    t = lambda a: torch.as_tensor(np.asarray(a, float), device=device)
    av = np.concatenate([np.tile(av_grid, len(rv_grid)), [0.0]])
    rv = np.concatenate([np.repeat(rv_grid, len(av_grid)), [3.3]])
    return ((t(av[None]), t(rv[None])),
            (t(av_grid), t(av_wt), t(rv_grid), t(rv_wt)))


class _Fetch:
    """One chunk of lookahead: `push` starts the copy of a chunk's device
    matrix to the host (on CUDA into one of two pinned buffers, in
    turns) and returns the previous chunk, `(lo, hi, numpy matrix)`, once
    its copy has landed; `push(None, None)` returns the last one."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.pending = None
        self.buffers = [None, None]
        self.n = 0

    def push(self, key, flat):
        prev, self.pending = self.pending, None
        if flat is not None and self.cuda:
            slot = self.n % 2
            self.n += 1
            buf = self.buffers[slot]
            if buf is None or buf.shape != flat.shape:
                buf = self.buffers[slot] = torch.empty(
                    flat.shape, dtype=flat.dtype, pin_memory=True)
            buf.copy_(flat, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self.pending = (key, buf, ev)
        elif flat is not None:
            self.pending = (key, flat, None)
        if prev is None:
            return None
        key, buf, ev = prev
        if ev is not None:
            ev.synchronize()
        return (*key, buf.cpu().numpy())


__all__ = ["SEDmaker", "extinction_lattice", "split_rows"]
