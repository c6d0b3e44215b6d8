"""
Grid arrays -> the port's device tables.

`from_numpy_grid` and `dense_tables` take the arrays
`brutus_tpu.BruteForce` takes (the `(M, F, 3)` magnitude coefficients,
the structured label array and its mask), so both packages fit the same
grid.

- The funnel's tables (`from_numpy_grid`): one `(3F + n_aux, Mp)`
  float32 table (row `k*F + f` holds coefficient `k` of filter `f`,
  then the aux rows `lnprior`, `feh`, `loga`), zero columns padding M
  to a multiple of `tile`, and a `(Mp,)` mask row that is -1e30 on the
  padding (the layout of `brutus_tpu.ops.pallas_loglike.prepare_screen`'s
  column-major table).
- The dense engine's tables (`dense_tables`): the `(3, F, Mp)`
  coefficients of `ops.fit.prepare_coeffs` and the `(Mp,)` grid rows
  `lnprior`, `feh`, `loga`, padded as `brutus_tpu.BruteForce.fit` pads
  them (`fitting.py:843-859`).
- The dense reference engine's tables (`reference_tables`): the
  `(M, F, 3)` coefficients and `(M,)` grid rows, unpadded, in the
  grid's dtype.

Sharded over a mesh's `model` axis (`n_shards`, `shard`), the funnel's
and the reference engine's tables are this shard's contiguous slice of
the grid, padded first so that the shards are equal (the funnel's to a
multiple of `tile * n_shards`, as `prepare_screen(n_shards=)` and
`prepare_screen_xla(n_shards=)` pad; the reference engine's as
`brutus_tpu.parallel.shard_grid` pads); only that slice is uploaded,
so no rank holds the whole grid on its device.  `n_real` stays the
grid's real model count.

The grid-generation objects from the arrays of the JAX package's own
(as numpy), so that both packages compute from identical tables:
`nn_from_numpy` (`FastNN.params`), `tracks_from_numpy`
(`MISTtracks.xgrid`, `ygrid`, `predictions`, `gridpoints`) and
`isochrone_from_numpy` (`Isochrone.tables` with its prediction index).
"""

import dataclasses

import numpy as np
import torch

from .ops.fit import prepare_coeffs
from .priors import imf_lnprior, ps1_MrLF_lnprior
from .utils import resolve_device


def default_grid_lnprior(models_labels, labels_mask=None,
                         apply_agewt=True, apply_grad=True):
    """Static per-model grid log-prior (mirrors
    `brutus_tpu.fitting.default_grid_lnprior`; reference
    `brutus/fitting.py:1334-1359`): Kroupa IMF over `mini` or the PS1
    M_r luminosity function, the `agewt` reweighting and the
    grid-spacing reweighting of the grid's input labels."""
    names = models_labels.dtype.names
    if "mini" in names:
        lnprior = imf_lnprior(torch.as_tensor(
            np.asarray(models_labels["mini"], float))).numpy()
    elif "Mr" in names:
        lnprior = ps1_MrLF_lnprior(torch.as_tensor(
            np.asarray(models_labels["Mr"], float))).numpy()
    else:
        lnprior = np.zeros(len(models_labels))
    if apply_agewt and "agewt" in names:
        with np.errstate(divide="ignore"):
            lnprior = lnprior + np.log(np.abs(models_labels["agewt"]))
    if apply_grad:
        grid_inputs = {"mini", "eep", "feh", "afe", "smf", "Mr"}
        for name in names:
            if labels_mask is not None:
                if name not in labels_mask.dtype.names \
                        or not labels_mask[name][0]:
                    continue
            elif name not in grid_inputs:
                continue
            vals = models_labels[name]
            uvals = np.unique(vals)
            if len(uvals) > 1:
                lngrad = np.log(np.gradient(uvals))
                lnprior = lnprior + np.interp(vals, uvals, lngrad)
    return lnprior


@dataclasses.dataclass(frozen=True)
class GridTables:
    """The funnel's device tables (see module docstring)."""

    table: torch.Tensor          # (3F + n_aux, Mp) float32
    maskrow: torch.Tensor        # (Mp,) float32
    n_real: int
    n_filt: int
    aux_names: tuple
    # (3F,) coefficient rows of the last real model, on every shard
    last: torch.Tensor = None


def _aux_rows(models_labels, labels_mask, lnprior, apply_dlabels):
    """The per-model rows that travel with the grid: `lnprior` (default
    `default_grid_lnprior`), and `feh` and `loga` when `apply_dlabels`
    and the labels carry them."""
    if lnprior is None:
        lnprior = default_grid_lnprior(models_labels, labels_mask)
    aux = {"lnprior": np.asarray(lnprior, np.float32)}
    names = models_labels.dtype.names
    for k in ("feh", "loga"):
        if apply_dlabels and k in names:
            aux[k] = np.asarray(models_labels[k], np.float32)
    return aux


def _shard(n, n_shards, shard):
    """Columns of shard `shard` of `n_shards` equal parts of `n`."""
    m = n // n_shards
    return slice(shard * m, (shard + 1) * m)


def from_numpy_grid(models, models_labels, labels_mask=None, device=None,
                    lnprior=None, apply_dlabels=True, tile=512, n_shards=1,
                    shard=0):
    """The funnel's device tables for `models (M, F, 3)` and its labels
    (`lnprior`, `feh`, `loga` rows as `_aux_rows` gives them); with
    `n_shards`, shard `shard`'s slice of them."""
    dev = resolve_device(device)
    mc = np.asarray(models, np.float32)
    M, F, _ = mc.shape
    aux = _aux_rows(models_labels, labels_mask, lnprior, apply_dlabels)
    q = tile * n_shards
    Mp = -(-M // q) * q
    C = 3 * F + len(aux)
    table = np.zeros((C, Mp), np.float32)
    table[:3 * F, :M] = mc.transpose(2, 1, 0).reshape(3 * F, M)
    for i, v in enumerate(aux.values()):
        table[3 * F + i, :M] = v
    maskrow = np.zeros(Mp, np.float32)
    maskrow[M:] = -1e30
    part = _shard(Mp, n_shards, shard)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return GridTables(up(table[:, part]), up(maskrow[part]), M, F,
                      tuple(aux), up(table[:3 * F, M - 1]))


@dataclasses.dataclass(frozen=True)
class DenseTables:
    """The dense engine's device tables (see module docstring)."""

    coeffs: torch.Tensor         # (3, F, Mp) float32; the reference
    #                              engine's: (M, F, 3) in the grid dtype
    lnprior: torch.Tensor        # (Mp,), -1e30 on the padding
    feh: torch.Tensor            # (Mp,), 0 on the padding, or None
    loga: torch.Tensor           # (Mp,), 9 on the padding, or None
    n_real: int


def dense_tables(models, models_labels, labels_mask=None, device=None,
                 lnprior=None, apply_dlabels=True, tile=512):
    """The dense engine's device tables for `models (M, F, 3)` and its
    labels: M padded to a multiple of `tile` with +60 mag models, whose
    grid prior is -1e30 (`brutus_tpu.BruteForce.fit`, fitting.py:
    843-859)."""
    dev = resolve_device(device)
    coeffs, M = prepare_coeffs(models, tile=tile, device=dev)
    pad = coeffs.shape[2] - M
    aux = _aux_rows(models_labels, labels_mask, lnprior, apply_dlabels)
    fill = dict(lnprior=-1e30, feh=0.0, loga=9.0)
    rows = {k: torch.from_numpy(np.concatenate(
        [v, np.full(pad, fill[k], np.float32)])).to(dev)
        for k, v in aux.items()}
    return DenseTables(coeffs, rows["lnprior"], rows.get("feh"),
                       rows.get("loga"), M)


def reference_tables(models, models_labels, labels_mask=None, device=None,
                     lnprior=None, apply_dlabels=True, n_shards=1, shard=0):
    """The dense reference engine's tables: the `(M, F, 3)` coefficients
    as given, unpadded and in their dtype (`optimize.loglike_grid`
    reads them as they are), and the grid rows in the same dtype
    (`brutus_tpu.BruteForce.fit`, fitting.py:959-964).  With
    `n_shards`, shard `shard`'s slice, padded as the JAX package pads a
    sharded grid (fitting.py:940-953): copies of the last model 60 mag
    fainter, whose grid prior is -1e30, and the label rows' last value
    repeated."""
    from .parallel.mesh import pad_grid, pad_to_multiple
    dev = resolve_device(device)
    mc = np.asarray(models)
    M = len(mc)
    dt = mc.dtype if mc.dtype in (np.float32, np.float64) else np.float64
    if lnprior is None:
        lnprior = default_grid_lnprior(models_labels, labels_mask)
    mc = pad_grid(np.asarray(mc, dt), n_shards)
    part = _shard(len(mc), n_shards, shard)
    row = lambda v: torch.from_numpy(np.ascontiguousarray(
        pad_to_multiple(np.asarray(v, dt), n_shards)[0][part])).to(dev)
    names = models_labels.dtype.names
    lab = lambda k: (row(models_labels[k]) if apply_dlabels and k in names
                     else None)
    lnprior = np.asarray(lnprior, dt)
    lnprior = np.concatenate([lnprior, np.full(len(mc) - M, -1e30, dt)])
    return DenseTables(torch.from_numpy(np.ascontiguousarray(mc[part])).to(
        dev), row(lnprior), lab("feh"), lab("loga"), M)


def nn_from_numpy(filters, params, device=None):
    """A `FastNNPredictor` from the stacked weights `(w1, b1, w2, b2, w3,
    b3, xmin, xmax)` of `brutus_tpu.models.nn.FastNN.params`."""
    from .models.nn import FastNNPredictor
    return FastNNPredictor(filters=filters, verbose=False, device=device,
                           arrays=[np.asarray(a) for a in params])


def tracks_from_numpy(xgrid, ygrid, predictions, gridpoints, device=None):
    """A `MISTtracks` on the finished tables of
    `brutus_tpu.models.tracks.MISTtracks` (its `xgrid`, `ygrid`,
    `predictions` and `gridpoints`)."""
    from .models.tracks import MISTtracks
    tracks = MISTtracks.__new__(MISTtracks)
    tracks._set_tables(gridpoints, [np.asarray(g) for g in xgrid],
                       np.asarray(ygrid), predictions,
                       resolve_device(device))
    return tracks


def isochrone_from_numpy(filters, xgrid, ygrid, predictions, nn_params,
                         device=None):
    """An `Isochrone` on the finished tables of
    `brutus_tpu.models.isochrone.Isochrone` (`tables = (xgrid, ygrid,
    nn_params)` and its `predictions`).  The EEP and age grids are the
    tables' axes; `afe_u` is the (padded) afe axis."""
    from .models.isochrone import Isochrone
    iso = Isochrone.__new__(Isochrone)
    iso.filters = list(filters)
    iso.pred_labels = iso.predictions = list(predictions)
    xgrid = [np.asarray(g, float) for g in xgrid]
    iso.feh_u, iso.afe_u, iso.loga_u, iso.eep_u = xgrid
    dev = resolve_device(device)
    iso._set_tables(xgrid, np.asarray(ygrid), dev)
    iso.FNNP = nn_from_numpy(filters, nn_params, dev)
    return iso


__all__ = ["from_numpy_grid", "dense_tables", "reference_tables",
           "default_grid_lnprior", "GridTables", "DenseTables",
           "nn_from_numpy", "tracks_from_numpy", "isochrone_from_numpy"]
