"""
Batch brute-force fitter of the PyTorch port (mirrors
`brutus_tpu/fitting.py`; reference `brutus/fitting.py:1110-2065`).

Four engines, resolved from `engine` and `screen_k` as the JAX package
resolves them on one device (`fitting.py:749-972`):

- `engine="fused"` (the default) with `screen_k` below the grid size:
  the funnel.  Per batch of stars, one Python step runs the screen
  (K2), the block top-k, the slab gather (K3), the shortlist fit (K1,
  stacked mode), the select stage, the MC integration (K4) and the
  resampling (`_funnel_step`);
- `engine="fused"` with `screen_k` 0 or at least the grid size: the
  dense engine, K1 in dense mode over every grid model, then
  `lnpost_grid` (`_dense_step`);
- `engine="xla"` with `screen_k` below the grid size: the
  reference-semantics funnel, K2 and K3 as in the funnel, then the
  convergence loops of `ops.optimize.loglike_grid` on the shortlists
  and `lnpost_grid` (`_xla_funnel_step`, `ops/screen_xla.py`);
- `engine="xla"` otherwise: the dense reference engine,
  `ops.optimize.loglike_grid` over the whole grid in its dtype, then
  `lnpost_grid` (`_xla_dense_step`).

The JAX package picks `"xla"` when `engine` is None off the TPU; the
port picks `"fused"` on every device, its kernels being its accelerator
path, except on a mesh whose `model` axis is over 1 without the funnel,
where it picks `"xla"` as the JAX package's TPU rule does.  Custom
prior callables take `lnpost_grid` on every engine, since K4 hard-codes
the built-in priors.  `ltol`, `ltol_subthresh` and
`mag_direct_init` steer the reference-semantics engines only: the fit
kernel runs fixed budgets from its direct seed, as in the JAX package.

On a device mesh (`fit(mesh=...)`, `parallel.make_mesh`), every rank
calls `fit` with the same inputs (SPMD) and the engines resolve as the
JAX package's do on a mesh (`fitting.py:749-957`): with a `model` axis
over 1, the funnel, fused or reference-semantics, screens each rank's
slice of the grid and merges the shortlists over the axis
(`ops/funnel.py`, `ops/screen_xla.py`), and the dense reference engine
runs on each rank's slice with its per-star reductions merged over the
axis (`ops/optimize.py`, `ops/posterior.py`); the dense fused engine
needs the whole grid on each rank, so it refuses such a mesh.  Over the
`data` axis each rank takes its contiguous share of every batch (the
last batch padded with copies of its last row, as the JAX package pads
it) under the rows' global indices, so each star draws what it draws
alone, and the packed results are all-gathered over the axis: every
rank returns the whole result, and only the mesh's first rank writes
`save_file`.  `scan_batches` is ignored there, as in the JAX package.

Batches stream: each batch's (or, with `scan_batches=N`, each group of
N batches') outputs are packed into one float32 and one int32 matrix on
the device, copied into pinned host buffers without blocking, and
turned into numpy only after the next group has been launched, so the
card computes while the host writes.  Host work (data hygiene, dust-map
lookup, HDF5 output) stays in numpy.  Float32 matrix products run in
true float32 while a group is launched: the screen's sums need it
(bf16-level noise scrambled the shortlist on the TPU,
`pallas_loglike.py:467-472`), and the reference engine's sums too
(the JAX package traces them at "highest" precision).

Inside a `torch.profiler` session, `fit` marks its stages with the
`bf.*` spans and keeps its counters (`profiling`; README lists them).
"""

import math
import sys
import time
import warnings

import numpy as np
import torch

from . import profiling
from .config import (FitConfig, PosteriorConfig, GalPriorConfig,
                     DustPriorConfig)
from .convert import (from_numpy_grid, dense_tables, reference_tables,
                      default_grid_lnprior)
from .dustmap import Bayestar, uniform_profile
from .io import ResultsWriter
from .ops.fit import loglike_grid_fused
from .ops.funnel import loglike_grid_screened
from .ops.mc import NL_PAD
from .ops.optimize import highest_precision, loglike_grid
from .ops.posterior import (lnpost_batch, lnpost_grid, draw_noise,
                            selection_size)
from .ops.screen_xla import loglike_grid_screened_xla
from .parallel.mesh import all_gather, all_reduce, group_size
from .utils import magnitude, resolve_device

# Diagnostics of the selection, fetched only with `return_sel`.
SEL_KEYS = ("sel_idx", "lnp_sel", "valid_sel")

# The JAX package's functional API (`brutus_tpu.fitting.loglike`,
# `lnpost`; reference `brutus/fitting.py`'s `loglike` and `lnpost`).
loglike = loglike_grid


def lnpost(seed, results, lnprior_grid, coord, parallax=math.nan,
           parallax_err=math.nan, feh=None, loga=None, dust_profile=None,
           global_idx=None, cfg=PosteriorConfig(), gal_cfg=GalPriorConfig(),
           dust_cfg=DustPriorConfig(), apply_av_prior=True, lngalprior=None,
           lndustprior=None, row=0):
    """Posterior weights and `(dist, Av, Rv)` draws for ONE star (mirrors
    `brutus_tpu.fitting.lnpost`, `ops/posterior.py:453`, which takes a
    PRNG key where this takes `seed`): `results` is `loglike`'s dict
    for the star (`(M,)` fields), `lnprior_grid`, `feh`, `loga` `(M,)`
    grid rows, `coord` its `(l, b)`, `dust_profile` `(av_dist, av_mean,
    av_std)` of its sightline.  Its random numbers are the Philox stream
    of `(seed, row)` (`posterior.draw_noise`), as `fit` draws row `row`'s.
    Returns `lnpost_grid`'s fields without the star axis."""
    lnl = torch.as_tensor(results["lnlike"])
    dev = lnl.device
    one = lambda x: torch.as_tensor(x, device=dev)[None]
    batch = {k: one(results[k]) for k in ("lnlike", "chi2", "scale", "av",
                                          "rv", "ndim")}
    batch["icov_parts"] = tuple(one(p) for p in results["icov_parts"])
    M = lnl.shape[0]
    noise = draw_noise(seed, torch.tensor([row]), selection_size(cfg, M),
                       cfg, dev, grid=True)
    f32 = lambda x: one(torch.as_tensor(x, dtype=torch.float32))
    if dust_profile is not None:
        av_dist, av_mean, av_std = dust_profile
        dust_profile = (torch.as_tensor(av_dist, device=dev), one(av_mean),
                        one(av_std))
    out = lnpost_grid(batch, lnprior_grid, f32(coord), noise,
                      parallax=f32(parallax), parallax_err=f32(parallax_err),
                      feh=feh, loga=loga, dust_profile=dust_profile,
                      global_idx=None if global_idx is None
                      else one(global_idx), cfg=cfg, gal_cfg=gal_cfg,
                      dust_cfg=dust_cfg, apply_av_prior=apply_av_prior,
                      lngalprior=lngalprior, lndustprior=lndustprior)
    return {k: v[0] for k, v in out.items()}


def _funnel_step(tables, seed, rows, flux, err, mask, plx, plx_err, coord,
                 dust_profile, fit_cfg, post_cfg, gal_cfg, dust_cfg,
                 apply_av_prior, tile, lngalprior=None, lndustprior=None,
                 ext_at=None, model_group=None):
    """One batch through the funnel: likelihood, then posterior (K4, or
    `lnpost_grid` on the shortlists for custom prior callables, as
    `posterior.py:806-843` routes them).  `ext_at(gidx)` gives the
    external label prior at the shortlists' grid indices, added to a
    copy of the pack's lnlike row (`fitting.py:165-173`)."""
    res = loglike_grid_screened(
        flux, err, mask, tables.table, tables.maskrow, tables.n_real,
        tables.aux_names, parallax=plx, parallax_err=plx_err, cfg=fit_cfg,
        tile=tile, screen_k=fit_cfg.screen_k,
        screen_block=fit_cfg.screen_block, model_group=model_group)
    pack, names, gidx = res["pack"], res["names"], res["global_idx"]
    if ext_at is not None:
        pack = pack.clone()
        pack[:, names.index("lnlike")] += ext_at(gidx)
    P = pack.shape[2]
    custom = lngalprior is not None or lndustprior is not None
    with profiling.span("bf.noise"):
        noise = draw_noise(seed, rows, selection_size(post_cfg, P),
                           post_cfg, pack.device, grid=custom)
    kw = dict(parallax=plx, parallax_err=plx_err, dust_profile=dust_profile,
              cfg=post_cfg, gal_cfg=gal_cfg, dust_cfg=dust_cfg,
              apply_av_prior=apply_av_prior)
    if not custom:
        return lnpost_batch(pack, names, res["ndim"], coord, noise,
                            global_idx=gidx, **kw)
    row = {n: pack[:, i] for i, n in enumerate(names)}
    results = dict(lnlike=row["lnlike"], chi2=row["chi2"],
                   scale=row["scale"], av=row["av"], rv=row["rv"],
                   icov_parts=tuple(row[n] for n in ("i00", "i11", "i22",
                                                     "i01", "i02", "i12")),
                   ndim=res["ndim"])
    with profiling.span("bf.posterior"):
        return lnpost_grid(results, row["lnprior"], coord, noise,
                           feh=row.get("feh"), loga=row.get("loga"),
                           global_idx=gidx, lngalprior=lngalprior,
                           lndustprior=lndustprior, **kw)


def _dense_step(tables, seed, rows, flux, err, mask, plx, plx_err, coord,
                dust_profile, fit_cfg, post_cfg, gal_cfg, dust_cfg,
                apply_av_prior, tile, lngalprior=None, lndustprior=None,
                ext_at=None, model_group=None):
    """One batch through the dense engine (`brutus_tpu.BruteForce.
    _build_step`, engine "fused" without the funnel): K1 over the whole
    grid, then `lnpost_grid`; the external prior is added over the
    padded grid, zero on the padding (`fitting.py:857-860`)."""
    with profiling.span("bf.likelihood"):
        res = loglike_grid_fused(flux, err, mask, tables.coeffs,
                                 cfg=fit_cfg, tile=tile,
                                 n_real=tables.n_real)
    if ext_at is not None:
        res["lnlike"] = res["lnlike"] + ext_at(None)
    M = res["lnlike"].shape[1]
    with profiling.span("bf.noise"):
        noise = draw_noise(seed, rows, selection_size(post_cfg, M),
                           post_cfg, tables.coeffs.device, grid=True)
    with profiling.span("bf.posterior"):
        return lnpost_grid(res, tables.lnprior, coord, noise, parallax=plx,
                           parallax_err=plx_err, feh=tables.feh,
                           loga=tables.loga, dust_profile=dust_profile,
                           cfg=post_cfg, gal_cfg=gal_cfg, dust_cfg=dust_cfg,
                           apply_av_prior=apply_av_prior,
                           lngalprior=lngalprior, lndustprior=lndustprior)


def _xla_funnel_step(tables, seed, rows, flux, err, mask, plx, plx_err,
                     coord, dust_profile, fit_cfg, post_cfg, gal_cfg,
                     dust_cfg, apply_av_prior, tile, lngalprior=None,
                     lndustprior=None, ext_at=None, model_group=None):
    """One batch through the reference-semantics funnel
    (`brutus_tpu.fitting._screened_step_xla`): K2, K3, the convergence
    loops on the shortlists, then `lnpost_grid` on them."""
    with profiling.span("bf.likelihood"):
        res = loglike_grid_screened_xla(
            flux, err, mask, tables.table, tables.maskrow, tables.n_real,
            tables.aux_names, parallax=plx, parallax_err=plx_err,
            cfg=fit_cfg, tile=tile, screen_k=fit_cfg.screen_k,
            screen_block=fit_cfg.screen_block, last=tables.last,
            model_group=model_group)
    gidx, aux = res.pop("global_idx"), res.pop("aux")
    if ext_at is not None:
        res["lnlike"] = res["lnlike"] + ext_at(gidx)
    M = res["lnlike"].shape[1]
    noise = draw_noise(seed, rows, selection_size(post_cfg, M), post_cfg,
                       res["lnlike"].device, grid=True)
    with profiling.span("bf.posterior"):
        return lnpost_grid(res, aux["lnprior"], coord, noise, parallax=plx,
                           parallax_err=plx_err, feh=aux.get("feh"),
                           loga=aux.get("loga"), dust_profile=dust_profile,
                           global_idx=gidx, cfg=post_cfg, gal_cfg=gal_cfg,
                           dust_cfg=dust_cfg, apply_av_prior=apply_av_prior,
                           lngalprior=lngalprior, lndustprior=lndustprior)


def _xla_dense_step(tables, seed, rows, flux, err, mask, plx, plx_err,
                    coord, dust_profile, fit_cfg, post_cfg, gal_cfg,
                    dust_cfg, apply_av_prior, tile, lngalprior=None,
                    lndustprior=None, ext_at=None, model_group=None):
    """One batch through the dense reference engine (`brutus_tpu.
    BruteForce._build_step`, engine "xla"): `loglike_grid` over the
    whole grid in its dtype, then `lnpost_grid`; on a `model_group`,
    over this rank's slice of the grid, merged over the group."""
    with profiling.span("bf.likelihood"):
        res = loglike_grid(flux, err, mask, tables.coeffs, parallax=plx,
                           parallax_err=plx_err, cfg=fit_cfg,
                           model_group=model_group)
    res.pop("n_iter")
    if ext_at is not None:
        res["lnlike"] = res["lnlike"] + ext_at(None).to(
            res["lnlike"].dtype)
    M = res["lnlike"].shape[1] * group_size(model_group)
    noise = draw_noise(seed, rows, selection_size(post_cfg, M), post_cfg,
                       tables.coeffs.device, grid=True)
    with profiling.span("bf.posterior"):
        return lnpost_grid(res, tables.lnprior, coord, noise, parallax=plx,
                           parallax_err=plx_err, feh=tables.feh,
                           loga=tables.loga, dust_profile=dust_profile,
                           cfg=post_cfg, gal_cfg=gal_cfg, dust_cfg=dust_cfg,
                           apply_av_prior=apply_av_prior,
                           lngalprior=lngalprior, lndustprior=lndustprior,
                           model_group=model_group)


class _ExternalPrior:
    """The `lnprior_ext` Gaussian label priors (`fitting.py:717-740`),
    built per batch on the device from each star's `(mean, std)` per
    label: `at(lo, hi, cols)` is the `(hi - lo, n)` float32 log-prior of
    stars `lo..hi` (rows past the data repeat its last, as a mesh pads
    its last batch) at the grid models `cols` ((B, n) indices, or None
    for the `n_cols` columns from `first` of the (padded) grid, zero
    beyond the real models).  A star whose mean is not finite or whose
    std is not positive gets none."""

    def __init__(self, lnprior_ext, models_labels, n_cols, device, first=0):
        names = models_labels.dtype.names
        for k in lnprior_ext:
            if k not in names:
                raise ValueError(f"`lnprior_ext` key {k!r} does not match "
                                 "any model label")
        f64 = dict(dtype=torch.float64, device=device)
        self.terms = []
        for k, pars in lnprior_ext.items():
            pars = np.asarray(pars, dtype=float)
            self.terms.append((
                torch.as_tensor(np.asarray(models_labels[k], float), **f64),
                torch.as_tensor(pars[:, 0], **f64),
                torch.as_tensor(pars[:, 1], **f64)))
        self.n_cols = n_cols
        self.first = first
        self.device = device

    def at(self, lo, hi, cols):
        total = None
        for lab, mean, std in self.terms:
            rows = torch.arange(lo, hi, device=mean.device).clamp(
                max=mean.shape[0] - 1)
            m, s = mean[rows, None], std[rows, None]
            ok = torch.isfinite(m) & (s > 0)
            safe = torch.where(ok, s, torch.ones_like(s))
            if cols is None:
                M = lab.shape[0]
                c = torch.arange(self.first, self.first + self.n_cols,
                                 device=lab.device)
                x = lab[c.clamp(max=M - 1)][None]
                ok = ok & (c < M)
            else:
                # padding models of the last slab lie past the grid:
                # clamped, as the JAX package's gather clamps (they are
                # killed by their lnlike)
                x = lab[cols.long().clamp(max=lab.shape[0] - 1)]
            chi2 = (x - torch.where(ok, m, torch.zeros_like(m))) ** 2
            term = torch.where(ok, -0.5 * (chi2 / safe ** 2 + torch.log(
                2 * math.pi * safe ** 2)), torch.zeros_like(chi2))
            # accumulated in float32, term by term, as the JAX package's
            # float32 table is
            total = (term if total is None else total.double() + term).to(
                torch.float32)
        return total


def _nbytes(values):
    """Bytes of the tensors among `values`."""
    return sum(v.nbytes for v in values if isinstance(v, torch.Tensor))


def _pack_outputs(out, skip):
    """A step's outputs as one float32 and one int32 `(B, X)` matrix on
    the device, and the recipe that splits them on the host (mirrors
    `fitting._pack_outputs`)."""
    groups = {"f": [], "i": []}
    layout = []
    B = next(iter(out.values())).shape[0]
    for k in sorted(out):
        if k in skip:
            continue
        v = out[k]
        kind = "f" if v.is_floating_point() else "i"
        shape = tuple(v.shape[1:])
        layout.append((k, kind, shape, int(np.prod(shape)) if shape else 1,
                       torch.empty(0, dtype=v.dtype).numpy().dtype))
        groups[kind].append(v.reshape(B, -1).to(
            torch.float32 if kind == "f" else torch.int32))
    return ([torch.cat(groups[kind], 1) if groups[kind] else None
             for kind in ("f", "i")], layout)


def _unpack_outputs(fpack, ipack, layout):
    """Split the host copies of `_pack_outputs`' matrices back into the
    named arrays, each a copy of its own (mirrors
    `fitting._unpack_outputs`)."""
    pos = {"f": 0, "i": 0}
    buf = {"f": fpack, "i": ipack}
    out = {}
    for k, kind, shape, n, dtype in layout:
        b = buf[kind]
        v = b[:, pos[kind]:pos[kind] + n].reshape((b.shape[0],) + shape)
        pos[kind] += n
        out[k] = np.array(v, dtype=dtype)
    return out


class _Fetcher:
    """Device -> host copies of packed outputs that overlap the next
    group's work (the JAX package's `copy_to_host_async`,
    `fitting.py:1043-1050`): on CUDA each matrix is copied with `non_blocking=True`
    into one of two sets of pinned buffers, alternating, and a CUDA
    event marks the copy's end; `result` waits for that event only.  A
    set is reused two groups later, after its result was taken.  On the
    CPU the copy is the matrix itself."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.sets = [{}, {}]
        self.turn = 0

    def start(self, packs):
        if not self.cuda:
            return [None if p is None else p.numpy() for p in packs], None
        bufs = self.sets[self.turn]
        self.turn ^= 1
        host = []
        for i, p in enumerate(packs):
            if p is None:
                host.append(None)
                continue
            b = bufs.get(i)
            if b is None or b.shape[1] != p.shape[1] \
                    or b.shape[0] < p.shape[0]:
                b = bufs[i] = torch.empty(p.shape, dtype=p.dtype,
                                          pin_memory=True)
            b = b[:p.shape[0]]
            b.copy_(p, non_blocking=True)
            host.append(b)
        event = torch.cuda.Event()
        event.record()
        return host, event

    @staticmethod
    def result(host, event):
        with profiling.span("bf.wait"):
            if event is not None:
                event.synchronize()
        return [None if h is None else np.asarray(h) for h in host]


class BruteForce:
    """Grid-scan fitter over `(Nmodel, Nfilt, 3)` magnitude coefficients
    (reference `brutus/fitting.py:1110-1142`; mirrors
    `brutus_tpu.BruteForce`).

    `dtype` casts the grid (`fitting.py:420-421`): the dense reference
    engine runs in it, the kernels' engines in float32.  `device` is
    where the grid and every stage live: CUDA unless the caller passes
    another (the CPU runs the kernels' plain versions).

    The set-up that does not depend on the stars is kept between `fit`
    calls: the default grid prior for each `(apply_agewt, apply_grad)`,
    and the device tables of the newest call, reused while the engine's
    table builder, `tile`, `apply_dlabels`, the mesh shard, the device
    and the grid prior (the default or the caller's `lnprior`, by
    content) stay the same; any other call rebuilds them.  Both are
    read from the grid as it was when they were built, so a grid
    changed in place needs a new `BruteForce`.
    """

    def __init__(self, models, models_labels, labels_mask=None,
                 dtype=None, device=None):
        self.NMODEL, self.NDIM, self.NCOEF = np.shape(models)
        self.models = np.asarray(models)
        if dtype is not None:
            self.models = self.models.astype(dtype, copy=False)
        self.models_labels = models_labels
        self.labels_mask = labels_mask
        self.NLABELS = len(models_labels.dtype.names)
        self.device = resolve_device(device)
        # call-invariant set-up: the default grid priors by their flags,
        # and `(key, grid prior, tables)` of the newest table build
        self._priors = {}
        self._tables = None

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
            with profiling.span("bf.grid_prior"):
                flags = (bool(apply_agewt), bool(apply_grad))
                lnprior = self._priors.get(flags)
                if lnprior is None:
                    lnprior = np.asarray(default_grid_lnprior(
                        self.models_labels, self.labels_mask,
                        apply_agewt=apply_agewt, apply_grad=apply_grad),
                        dtype=float)
                    lnprior.flags.writeable = False     # shared by calls
                    self._priors[flags] = lnprior
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

    def _kept_tables(self, key, lnprior):
        """The kept tables, where the newest build had the inputs `key`
        and a grid prior equal to `lnprior`; else None."""
        if self._tables is None or self._tables[0] != key:
            return None
        _, prior, tables = self._tables
        if prior is lnprior or np.array_equal(prior, lnprior,
                                              equal_nan=True):
            return tables
        return None

    @profiling.traced_call("bf.fit")
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
            merr_max=0.25, save_dar_draws=True, running_io=True,
            verbose=True, batch_size=16, n_sel_max=2048, seed=0,
            resume=False, return_results=False, return_sel=False,
            mesh=None, engine=None, tile=512, screen_k=None,
            screen_block=None, screen_select=None, mag_direct_init=True,
            scan_batches=1, _yield_batches=False):
        """Fit every star against the grid and write the results file.

        Same arguments, defaults and output schema as
        `brutus_tpu.BruteForce.fit` (module docstring for the engines
        and for `mesh`, a `parallel.make_mesh` mesh that every rank
        passes with the same inputs; its ranks run on their mesh
        devices).  Custom `lngalprior` / `lndustprior` callables
        follow the JAX package's per-star contract on torch tensors (see
        `ops.posterior.lnpost_grid`).  `lnprior_ext` maps model labels
        to per-star `(n_data, 2)` Gaussian `(mean, std)` priors added to
        the likelihood.  Each star draws from its own Philox stream
        keyed by `seed` and its row in `data` (`ops/rng.py`), so a row's
        results depend neither on `batch_size` nor on `scan_batches`,
        which groups N batches of the funnel engines into one launch
        sequence and one copy back (the dense engines run batch by
        batch).  `resume=True` continues a partial `save_file` from its
        first unwritten row.  `return_results=True` also returns the
        results as a dict of numpy arrays, with the selection's
        diagnostics `sel_idx`, `lnp_sel`, `valid_sel` when
        `return_sel=True`.  `running_io` is accepted for the reference's
        signature; results always stream batch by batch.
        `screen_select="approx"` selects exactly.
        """
        if engine not in (None, "fused", "xla"):
            raise ValueError(f"engine={engine!r}: expected 'fused' or "
                             "'xla'")
        if screen_select not in (None, "exact", "approx"):
            raise ValueError(f"screen_select={screen_select!r}: expected "
                             "'exact' or 'approx'")
        with profiling.span("bf.setup"):
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
            rvlim=tuple(rvlim), rv_gauss=tuple(rv_gauss), ltol=ltol,
            ltol_subthresh=ltol_subthresh, init_thresh=logl_initthresh,
            dim_prior=logl_dim_prior,
            screen_k=(FitConfig.screen_k if screen_k is None
                      else int(screen_k)),
            screen_block=(FitConfig.screen_block if screen_block is None
                          else int(screen_block)),
            mag_direct_init=bool(mag_direct_init))
        post_cfg = PosteriorConfig(n_mc_prior=Nmc_prior,
                                   wt_thresh=wt_thresh,
                                   cdf_thresh=cdf_thresh, n_draws=Ndraws,
                                   avlim=tuple(avlim), rvlim=tuple(rvlim),
                                   n_sel_max=min(n_sel_max, self.NMODEL))
        gal_cfg = lngalprior_cfg or GalPriorConfig()
        dust_cfg = dust_cfg or DustPriorConfig()
        f32 = torch.float32

        # engine resolution on a mesh (`fitting.py:751-775`)
        n_dax, model_ax = ((mesh.shape["data"], mesh.shape["model"])
                           if mesh is not None else (1, 1))
        use_screen = bool(fit_cfg.screen_k) and \
            fit_cfg.screen_k < self.NMODEL
        if engine is None:
            engine = "fused" if model_ax == 1 or use_screen else "xla"
        if engine == "fused" and model_ax > 1 and not use_screen:
            raise ValueError(
                "engine='fused' with a model>1 mesh requires the funnel "
                "(screen_k < NMODEL): the dense fused kernel replicates the "
                "grid per device.  Use screen_k or engine='xla' for dense "
                "grid sharding.")
        if model_ax > 1 and use_screen and lnprior_ext is not None:
            raise NotImplementedError(
                "lnprior_ext with a model-sharded funnel mesh")
        if mesh is not None and batch_size % n_dax != 0:
            raise ValueError("batch_size must be divisible by the mesh "
                             "'data' axis size")
        dev = self.device if mesh is None else mesh.device
        model_group = mesh.get_group("model") if model_ax > 1 else None
        data_group = mesh.get_group("data") if n_dax > 1 else None
        shard = mesh.coords[1] if mesh is not None else 0

        if dustmap is None and dustfile is not None:
            dustmap = Bayestar(dustfile)
        apply_av_prior = (dustmap is not None) and (av_gauss is None)
        dust_dist = dust_mean = dust_std = None
        if apply_av_prior:
            with profiling.span("bf.dust"):
                dd, dm, ds = dustmap.query((data_coords[:, 0],
                                            data_coords[:, 1]))
                dd, dust_mean, dust_std = uniform_profile(
                    dd, np.atleast_2d(dm), np.atleast_2d(ds), n=NL_PAD)
                dust_dist = torch.as_tensor(dd, dtype=f32, device=dev)
            profiling.count("h2d_bytes", dust_dist.nbytes)

        build, step = {
            ("fused", True): (from_numpy_grid, _funnel_step),
            ("fused", False): (dense_tables, _dense_step),
            ("xla", True): (from_numpy_grid, _xla_funnel_step),
            ("xla", False): (reference_tables, _xla_dense_step),
        }[engine, use_screen]
        kw = {} if build is reference_tables else dict(tile=tile)
        if model_ax > 1:
            kw.update(n_shards=model_ax, shard=shard)
        with profiling.span("bf.tables"):
            key = (build, tuple(sorted(kw.items())), bool(apply_dlabels),
                   dev)
            tables = self._kept_tables(key, lnprior)
            reused = tables is not None
            if not reused:
                self._tables = None     # frees the old entry's memory first
                tables = build(self.models, self.models_labels,
                               self.labels_mask, device=dev, lnprior=lnprior,
                               apply_dlabels=apply_dlabels, **kw)
                # the caller may change its own prior in place: keep a copy
                own = any(lnprior is p for p in self._priors.values())
                self._tables = (key, lnprior if own else lnprior.copy(),
                                tables)
        profiling.count("setup_reused", int(reused))
        if not reused and profiling.recording():
            profiling.count("h2d_bytes", _nbytes(vars(tables).values()))
        ext = None
        if lnprior_ext is not None:
            n_cols, first = self.NMODEL, 0
            if step is _dense_step:
                n_cols = tables.coeffs.shape[-1]
            elif step is _xla_dense_step:     # this rank's columns
                n_cols = tables.coeffs.shape[0]
                first = shard * n_cols
            ext = _ExternalPrior(lnprior_ext, self.models_labels, n_cols,
                                 dev, first)
        # The dense reference engine reads the data in the grid's dtype.
        data_dt = (tables.coeffs.dtype if step is _xla_dense_step
                   else f32)
        # Funnel engines group `scan_batches` batches per launch sequence
        # and copy-back (`fitting.py:984-990`), on one device.
        n_scan = (max(1, int(scan_batches))
                  if step in (_funnel_step, _xla_funnel_step)
                  and mesh is None else 1)
        chunk = batch_size * n_scan
        # a data rank's share of each batch
        share = batch_size // n_dax
        skip = () if return_sel else SEL_KEYS
        first_rank = mesh is None or mesh.first
        verbose = verbose and first_rank

        writer = None
        if save_file is not None and first_rank:
            writer = ResultsWriter(save_file, n_data, Ndraws,
                                   labels=data_labels,
                                   save_dar_draws=save_dar_draws,
                                   resume=resume)
        start_row = writer.cursor if (writer is not None and resume) else 0
        if mesh is not None and resume:     # the first rank's cursor
            start_row = int(all_reduce(torch.tensor(
                [start_row], device=dev), "sum", mesh.world)[0])
        fetcher = _Fetcher(dev)

        def launch(lo, hi):
            """Upload and launch the batches of rows lo..hi (float32
            products at full precision); start the copy back of their
            packed outputs."""
            with highest_precision(), profiling.span("bf.launch"):
                return _launch(lo, hi)

        def _launch(lo, hi):
            # This rank's rows lo..hi, batch by batch; on a mesh, its
            # share of the batch at lo, past the data copies of the last
            # row (`fitting.py:1008-1017`).
            r0, r1, per = lo, hi, batch_size
            if mesh is not None:
                r0 = lo + mesh.coords[0] * share
                r1, per = r0 + share, share
            take = np.minimum(np.arange(r0, r1), n_data - 1)
            # pageable uploads: pinning each small input per call cost
            # more than it overlapped (PERF.md, the streaming loop)
            up = lambda x, dt=f32: torch.as_tensor(x[take], dtype=dt,
                                                   device=dev)
            with profiling.span("bf.upload"):
                g = dict(flux=up(data, data_dt), err=up(data_err, data_dt),
                         mask=up(data_mask, torch.bool), plx=up(parallax),
                         plxe=up(parallax_err), coord=up(data_coords))
                if apply_av_prior:
                    g["dm"], g["ds"] = up(dust_mean), up(dust_std)
            if profiling.recording():
                profiling.count("h2d_bytes", _nbytes(g.values()))
            packs = []
            for blo in range(r0, r1, per):
                bhi = min(blo + per, r1)
                b = slice(blo - r0, bhi - r0)
                rows = torch.arange(blo, bhi, device=dev)
                dp = ((dust_dist, g["dm"][b], g["ds"][b])
                      if apply_av_prior else None)
                ext_at = (None if ext is None else
                          (lambda cols, a=blo, z=bhi: ext.at(a, z, cols)))
                out = step(tables, seed, rows,
                           g["flux"][b], g["err"][b], g["mask"][b],
                           g["plx"][b], g["plxe"][b], g["coord"][b], dp,
                           fit_cfg, post_cfg, gal_cfg, dust_cfg,
                           apply_av_prior, tile, lngalprior, lndustprior,
                           ext_at=ext_at, model_group=model_group)
                with profiling.span("bf.pack"):
                    packs.append(_pack_outputs(out, skip))
            layout = packs[0][1]
            mats = [None if packs[0][0][i] is None
                    else torch.cat([p[0][i] for p in packs])
                    for i in range(2)]
            # every rank gets the whole batch, in row order
            mats = [None if m is None else
                    all_gather(m, data_group, dim=0)[:hi - lo] for m in mats]
            with profiling.span("bf.copy"):
                return (lo, hi - lo, layout) + fetcher.start(mats)

        def finish(item):
            lo, n, layout, host, event = item
            fpack, ipack = fetcher.result(host, event)
            with profiling.span("bf.unpack"):
                return lo, n, _unpack_outputs(fpack, ipack, layout)

        def batches():
            """`(lo, n, out)` per group, one group in flight: group i+1
            is launched before group i is read back."""
            pending = None
            for lo in range(start_row, n_data, chunk):
                item = launch(lo, min(lo + chunk, n_data))
                if pending is not None:
                    yield finish(pending)
                pending = item
            if pending is not None:
                yield finish(pending)

        if _yield_batches:
            if writer is not None:      # the caller writes what it takes
                writer.close()
            return batches()

        collected = [] if return_results else None
        t_start = time.time()
        n_done = 0
        try:
            for lo, n, out in batches():
                if writer is not None:
                    with profiling.span("bf.write"):
                        writer.write_batch(lo, out, n_valid=n)
                if collected is not None:
                    collected.append(out)
                n_done += n
                if verbose:
                    rate = (time.time() - t_start) / max(n_done, 1)
                    remain = rate * (n_data - start_row - n_done)
                    sys.stderr.write(
                        f"\rFitting object {start_row + n_done}/{n_data} "
                        f"[chi2/n: {out['chi2min'][n - 1]:.1f}/"
                        f"{out['ndim'][n - 1]}] "
                        f"(mean time: {rate:.3f} s/obj, est. remaining: "
                        f"{remain:.1f} s)   ")
                    sys.stderr.flush()
        finally:
            if writer is not None:
                writer.close()
        if verbose:
            sys.stderr.write("\n")
        if collected is not None and collected:
            return {k: np.concatenate([c[k] for c in collected])
                    for k in collected[0]}

    def _fit(self, data, data_err, data_mask, **kwargs):
        """Per-star generator (mirrors `brutus_tpu.BruteForce._fit`;
        reference `brutus/fitting.py:1803-2065`) yielding the
        reference's 13-tuple per star.  Lazy: batches are fitted as the
        generator is consumed, one group in flight."""
        kwargs.setdefault("save_file", None)
        kwargs.setdefault("verbose", False)
        kwargs.pop("return_results", None)
        for _lo, n, out in self.fit(data, data_err, data_mask,
                                    _yield_batches=True, **kwargs):
            for i in range(n):
                yield (out["model_idx"][i], out["scale"][i], out["av"][i],
                       out["rv"][i], out["cov_sar"][i], out["ndim"][i],
                       out["lnprob"][i], out["log_evidence"][i],
                       out["chi2min"][i], out["dist"][i], out["red"][i],
                       out["dred"][i], out["logwt"][i])


__all__ = ["BruteForce", "default_grid_lnprior", "loglike", "lnpost"]
