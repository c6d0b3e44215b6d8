"""
Batch brute-force fitter of the PyTorch port (mirrors
`brutus_tpu/fitting.py`; reference `brutus/fitting.py:1110-2065`).

Two engines, resolved as the JAX package's fused engine resolves them
(`fitting.py:756-761`):

- the funnel, when `screen_k` is below the grid size: per batch of
  stars, one Python step runs the screen (K2), the block top-k, the
  slab gather (K3), the shortlist fit (K1, stacked mode), the select
  stage, the MC integration (K4) and the resampling (`_funnel_step`);
- the dense engine, when `screen_k` is 0 or at least the grid size:
  K1 in dense mode fits every grid model for every star, and
  `lnpost_grid` selects, integrates and resamples (`_dense_step`).

Custom prior callables take `lnpost_grid` on both engines, since K4
hard-codes the built-in priors.  Host work (data hygiene, dust-map
lookup, HDF5 output) stays in numpy.  Float32 matrix products run in
true float32: the screen's sums need it (bf16-level noise scrambled the
shortlist on the TPU, `pallas_loglike.py:467-472`), so the fit turns
TF32 off.
"""

import sys
import time
import warnings

import numpy as np
import torch

from .config import (FitConfig, PosteriorConfig, GalPriorConfig,
                     DustPriorConfig)
from .convert import from_numpy_grid, dense_tables, default_grid_lnprior
from .dustmap import Bayestar, uniform_profile
from .io import ResultsWriter
from .ops.fit import loglike_grid_fused
from .ops.funnel import loglike_grid_screened
from .ops.mc import NL_PAD
from .ops.posterior import (lnpost_batch, lnpost_grid, draw_noise,
                            selection_size)
from .utils import magnitude, resolve_device


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported to brutus_tpu_torch yet (ROADMAP Queue 1 "
        f"item {item})")


def _funnel_step(tables, seed, rows, flux, err, mask, plx, plx_err, coord,
                 dust_profile, fit_cfg, post_cfg, gal_cfg, dust_cfg,
                 apply_av_prior, tile, lngalprior=None, lndustprior=None):
    """One batch through the funnel: likelihood, then posterior (K4, or
    `lnpost_grid` on the shortlists for custom prior callables, as
    `posterior.py:806-843` routes them)."""
    res = loglike_grid_screened(
        flux, err, mask, tables.table, tables.maskrow, tables.n_real,
        tables.aux_names, parallax=plx, parallax_err=plx_err, cfg=fit_cfg,
        tile=tile, screen_k=fit_cfg.screen_k,
        screen_block=fit_cfg.screen_block)
    pack, names = res["pack"], res["names"]
    P = pack.shape[2]
    custom = lngalprior is not None or lndustprior is not None
    noise = draw_noise(seed, rows, selection_size(post_cfg, P), post_cfg,
                       pack.device, grid=custom)
    kw = dict(parallax=plx, parallax_err=plx_err, dust_profile=dust_profile,
              cfg=post_cfg, gal_cfg=gal_cfg, dust_cfg=dust_cfg,
              apply_av_prior=apply_av_prior)
    if not custom:
        return lnpost_batch(pack, names, res["ndim"], coord, noise, **kw)
    row = {n: pack[:, i] for i, n in enumerate(names)}
    results = dict(lnlike=row["lnlike"], chi2=row["chi2"],
                   scale=row["scale"], av=row["av"], rv=row["rv"],
                   icov_parts=tuple(row[n] for n in ("i00", "i11", "i22",
                                                     "i01", "i02", "i12")),
                   ndim=res["ndim"])
    return lnpost_grid(results, row["lnprior"], coord, noise,
                       feh=row.get("feh"), loga=row.get("loga"),
                       global_idx=torch.round(row["gidx"]).to(torch.int64),
                       lngalprior=lngalprior, lndustprior=lndustprior, **kw)


def _dense_step(tables, seed, rows, flux, err, mask, plx, plx_err, coord,
                dust_profile, fit_cfg, post_cfg, gal_cfg, dust_cfg,
                apply_av_prior, tile, lngalprior=None, lndustprior=None):
    """One batch through the dense engine (`brutus_tpu.BruteForce.
    _build_step`, engine "fused" without the funnel): K1 over the whole
    grid, then `lnpost_grid`."""
    res = loglike_grid_fused(flux, err, mask, tables.coeffs, cfg=fit_cfg,
                             tile=tile, n_real=tables.n_real)
    M = res["lnlike"].shape[1]
    noise = draw_noise(seed, rows, selection_size(post_cfg, M), post_cfg,
                       tables.coeffs.device, grid=True)
    return lnpost_grid(res, tables.lnprior, coord, noise, parallax=plx,
                       parallax_err=plx_err, feh=tables.feh,
                       loga=tables.loga, dust_profile=dust_profile,
                       cfg=post_cfg, gal_cfg=gal_cfg, dust_cfg=dust_cfg,
                       apply_av_prior=apply_av_prior,
                       lngalprior=lngalprior, lndustprior=lndustprior)


class BruteForce:
    """Grid-scan fitter over `(Nmodel, Nfilt, 3)` magnitude coefficients
    (reference `brutus/fitting.py:1110-1142`).

    `device` is where the grid and every stage live: CUDA unless the
    caller passes another (the CPU runs the kernels' plain versions).
    """

    def __init__(self, models, models_labels, labels_mask=None,
                 device=None):
        self.NMODEL, self.NDIM, self.NCOEF = np.shape(models)
        self.models = np.asarray(models)
        self.models_labels = models_labels
        self.labels_mask = labels_mask
        self.device = resolve_device(device)

    def _setup(self, data, data_err, data_mask, phot_offsets=None,
               parallax=None, parallax_err=None, lnprior=None,
               apply_agewt=True, apply_grad=True, data_coords=None,
               mag_max=50.0, merr_max=0.25):
        """Data hygiene + default priors (reference `brutus/fitting.py:
        1144-1424`, as `brutus_tpu.BruteForce._setup`)."""
        data = np.ascontiguousarray(data, dtype=float)
        data_err = np.ascontiguousarray(data_err, dtype=float)
        data_mask = np.ascontiguousarray(data_mask).astype(bool)
        n_data, n_filt = data.shape
        if n_filt != self.NDIM:
            raise ValueError(f"data has {n_filt} bands but the grid has "
                             f"{self.NDIM}")
        if parallax is not None and parallax_err is None:
            raise ValueError("must provide both `parallax` and "
                             "`parallax_err`")
        if parallax is None:
            parallax = np.full(n_data, np.nan)
            parallax_err = np.full(n_data, np.nan)
        if phot_offsets is None:
            phot_offsets = np.ones(n_filt)
        if lnprior is None:
            lnprior = default_grid_lnprior(self.models_labels,
                                           self.labels_mask,
                                           apply_agewt=apply_agewt,
                                           apply_grad=apply_grad)
        if data_coords is None:
            data_coords = np.zeros((n_data, 2))
        # Remove bad photometry the user may not have masked
        # (fitting.py:1404-1420).
        with warnings.catch_warnings(), np.errstate(all="ignore"):
            warnings.simplefilter("ignore")
            mag, err = magnitude(data, data_err)
            bad_mag = (mag > mag_max) | (err > merr_max)
            clean = (np.isfinite(data) & np.isfinite(data_err)
                     & (data_err > 0.0))
            data_mask = data_mask & clean & ~bad_mag
        if np.any(data_mask.sum(axis=1) < 4):
            raise ValueError(
                "Objects with fewer than 4 bands of acceptable photometry "
                "give degenerate fits; remove them or adjust "
                "`mag_max`/`merr_max`.")
        return (data * phot_offsets, data_err * phot_offsets, data_mask,
                np.asarray(parallax, dtype=float),
                np.asarray(parallax_err, dtype=float),
                np.asarray(data_coords, dtype=float),
                np.asarray(lnprior, dtype=float))

    def fit(self, data, data_err, data_mask, data_labels=None,
            save_file=None, phot_offsets=None, parallax=None,
            parallax_err=None, Nmc_prior=50, avlim=(0.0, 20.0),
            av_gauss=None, rvlim=(1.0, 8.0), rv_gauss=(3.32, 0.18),
            lnprior=None, lnprior_ext=None, wt_thresh=1e-3,
            cdf_thresh=2e-3, Ndraws=250, apply_agewt=True, apply_grad=True,
            lngalprior=None, lndustprior=None, lngalprior_cfg=None,
            dustfile=None, dustmap=None, dust_cfg=None, apply_dlabels=True,
            data_coords=None, logl_dim_prior=True, ltol=3e-2,
            ltol_subthresh=1e-2, logl_initthresh=5e-3, mag_max=50.0,
            merr_max=0.25, save_dar_draws=True, verbose=True,
            batch_size=16, n_sel_max=2048, seed=0, resume=False,
            return_results=False, mesh=None, engine=None, tile=512,
            screen_k=None, screen_block=None, screen_select=None,
            mag_direct_init=True, scan_batches=1):
        """Fit every star against the grid and write the results file.

        Same arguments, defaults and output schema as
        `brutus_tpu.BruteForce.fit` on its fused engine: the funnel
        when `screen_k` is below the grid size, else the dense engine.
        Custom `lngalprior` / `lndustprior` callables follow the JAX
        package's per-star contract on torch tensors (see
        `ops.posterior.lnpost_grid`).  Each star draws from its own
        Philox stream keyed by `seed` and its row in `data`
        (`ops/rng.py`), so a row's results do not depend on
        `batch_size`; the funnel's MC kernel makes those normals itself
        unless `PosteriorConfig.kernel_rng` is off, when they are drawn
        outside and fed to it.  `screen_select="approx"`
        selects exactly.  Results stream batch by batch into
        `save_file`; `return_results=True` also returns them as a dict
        of numpy arrays.
        """
        if engine not in (None, "fused"):
            raise _not_ported(f"engine={engine!r}", 7)
        if mesh is not None:
            raise _not_ported("a device mesh", 8)
        if scan_batches != 1:
            raise _not_ported("scan_batches > 1", 5)
        if lnprior_ext is not None:
            raise _not_ported("lnprior_ext", 5)
        if resume:
            raise _not_ported("resume", 5)
        # The XLA engine's convergence loop and magnitude-space start;
        # the fit kernel runs fixed budgets from the direct seed.
        if (ltol, ltol_subthresh, mag_direct_init) != (3e-2, 1e-2, True):
            raise _not_ported("ltol, ltol_subthresh and mag_direct_init="
                              "False (the XLA engine)", 7)
        if screen_select not in (None, "exact", "approx"):
            raise ValueError(f"screen_select={screen_select!r}: expected "
                             "'exact' or 'approx'")
        (data, data_err, data_mask, parallax, parallax_err, data_coords,
         lnprior) = self._setup(data, data_err, data_mask,
                                phot_offsets=phot_offsets,
                                parallax=parallax,
                                parallax_err=parallax_err,
                                lnprior=lnprior, apply_agewt=apply_agewt,
                                apply_grad=apply_grad,
                                data_coords=data_coords,
                                mag_max=mag_max, merr_max=merr_max)
        n_data = data.shape[0]
        fit_cfg = FitConfig(
            avlim=tuple(avlim),
            av_gauss=(0.0, 1e6) if av_gauss is None else tuple(av_gauss),
            rvlim=tuple(rvlim), rv_gauss=tuple(rv_gauss),
            init_thresh=logl_initthresh, dim_prior=logl_dim_prior,
            screen_k=(FitConfig.screen_k if screen_k is None
                      else int(screen_k)),
            screen_block=(FitConfig.screen_block if screen_block is None
                          else int(screen_block)))
        use_screen = bool(fit_cfg.screen_k) and \
            fit_cfg.screen_k < self.NMODEL
        post_cfg = PosteriorConfig(n_mc_prior=Nmc_prior,
                                   wt_thresh=wt_thresh,
                                   cdf_thresh=cdf_thresh, n_draws=Ndraws,
                                   avlim=tuple(avlim), rvlim=tuple(rvlim),
                                   n_sel_max=min(n_sel_max, self.NMODEL))
        if self.NMODEL >= 2 ** 24:
            raise ValueError("the fit kernel carries grid indices as "
                             "float32, exact only below 2**24 models")
        gal_cfg = lngalprior_cfg or GalPriorConfig()
        dust_cfg = dust_cfg or DustPriorConfig()
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)

        if dustmap is None and dustfile is not None:
            dustmap = Bayestar(dustfile)
        apply_av_prior = (dustmap is not None) and (av_gauss is None)
        dust_profile = None
        if apply_av_prior:
            dd, dm, ds = dustmap.query((data_coords[:, 0],
                                        data_coords[:, 1]))
            dd, dm, ds = uniform_profile(dd, np.atleast_2d(dm),
                                         np.atleast_2d(ds), n=NL_PAD)
            dust_profile = (torch.as_tensor(dd, **f32),
                            torch.as_tensor(dm, **f32),
                            torch.as_tensor(ds, **f32))

        build, step = ((from_numpy_grid, _funnel_step) if use_screen
                       else (dense_tables, _dense_step))
        tables = build(self.models, self.models_labels, self.labels_mask,
                       device=dev, lnprior=lnprior,
                       apply_dlabels=apply_dlabels, tile=tile)
        writer = None
        if save_file is not None:
            writer = ResultsWriter(save_file, n_data, Ndraws,
                                   labels=data_labels,
                                   save_dar_draws=save_dar_draws)
        prev_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        collected = [] if return_results else None
        t_start = time.time()
        try:
            for lo in range(0, n_data, batch_size):
                sl = slice(lo, min(lo + batch_size, n_data))
                n = sl.stop - lo
                dp = None
                if dust_profile is not None:
                    dp = (dust_profile[0], dust_profile[1][sl],
                          dust_profile[2][sl])
                out = step(
                    tables, seed, torch.arange(lo, sl.stop, device=dev),
                    torch.as_tensor(data[sl], **f32),
                    torch.as_tensor(data_err[sl], **f32),
                    torch.as_tensor(data_mask[sl], device=dev),
                    torch.as_tensor(parallax[sl], **f32),
                    torch.as_tensor(parallax_err[sl], **f32),
                    torch.as_tensor(data_coords[sl], **f32), dp, fit_cfg,
                    post_cfg, gal_cfg, dust_cfg, apply_av_prior, tile,
                    lngalprior, lndustprior)
                out = {k: v.cpu().numpy() for k, v in out.items()}
                if writer is not None:
                    writer.write_batch(lo, out, n_valid=n)
                if collected is not None:
                    collected.append(out)
                if verbose:
                    done = sl.stop
                    rate = (time.time() - t_start) / done
                    sys.stderr.write(
                        f"\rFitting object {done}/{n_data} "
                        f"[chi2/n: {out['chi2min'][n - 1]:.1f}/"
                        f"{out['ndim'][n - 1]}] "
                        f"(mean time: {rate:.3f} s/obj, est. remaining: "
                        f"{rate * (n_data - done):.1f} s)   ")
                    sys.stderr.flush()
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev_tf32
            if writer is not None:
                writer.close()
        if verbose:
            sys.stderr.write("\n")
        if collected is not None:
            return {k: np.concatenate([c[k] for c in collected])
                    for k in collected[0]}


__all__ = ["BruteForce", "default_grid_lnprior"]
