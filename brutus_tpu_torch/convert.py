"""
Grid arrays -> the port's device tables.

`from_numpy_grid` takes the arrays `brutus_tpu.BruteForce` takes (the
`(M, F, 3)` magnitude coefficients, the structured label array and its
mask) and builds the funnel's device tables, so both packages fit the
same grid: one `(3F + n_aux, Mp)` float32 table (row `k*F + f` holds
coefficient `k` of filter `f`, then the aux rows `lnprior`, `feh`,
`loga`), zero columns padding M to a multiple of `tile`, and a `(Mp,)`
mask row that is -1e30 on the padding (the layout of
`brutus_tpu.ops.pallas_loglike.prepare_screen`'s column-major table).
"""

import dataclasses

import numpy as np
import torch

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


def from_numpy_grid(models, models_labels, labels_mask=None, device=None,
                    lnprior=None, apply_dlabels=True, tile=512):
    """Device tables for `models (M, F, 3)` and its labels.

    `lnprior` (M,) defaults to `default_grid_lnprior`; `feh` and `loga`
    ride along when `apply_dlabels` and the labels carry them.
    """
    dev = resolve_device(device)
    mc = np.asarray(models, np.float32)
    M, F, _ = mc.shape
    if lnprior is None:
        lnprior = default_grid_lnprior(models_labels, labels_mask)
    aux = {"lnprior": np.asarray(lnprior, np.float32)}
    names = models_labels.dtype.names
    for k in ("feh", "loga"):
        if apply_dlabels and k in names:
            aux[k] = np.asarray(models_labels[k], np.float32)
    Mp = -(-M // tile) * tile
    C = 3 * F + len(aux)
    table = np.zeros((C, Mp), np.float32)
    table[:3 * F, :M] = mc.transpose(2, 1, 0).reshape(3 * F, M)
    for i, v in enumerate(aux.values()):
        table[3 * F + i, :M] = v
    maskrow = np.zeros(Mp, np.float32)
    maskrow[M:] = -1e30
    return GridTables(torch.from_numpy(table).to(dev),
                      torch.from_numpy(maskrow).to(dev), M, F,
                      tuple(aux))


__all__ = ["from_numpy_grid", "default_grid_lnprior", "GridTables"]
