"""
MIST isochrone interpolator and co-eval population SEDs (mirrors
`brutus_tpu/models/isochrone.py`).

Parity: reference `brutus/seds.py:1081-1502` (`Isochrone`): the MIST
isochrone tables over `(feh, afe, loga, eep)` with EEP hole filling,
the empirical Teff / radius corrections, and the SEDs of a whole co-eval
population (every EEP of the isochrone), unresolved binaries included,
parameterised by the secondary mass fraction.

`population_seds_multi` carries a leading batch axis (one entry per set
of cluster parameters, e.g. per walker of `cluster.fit_cluster`), where
the JAX function is mapped with `jax.vmap`.  h5py is imported only
inside the file reader and writer.
"""

import sys
from collections import namedtuple

import numpy as np
import torch

from ..ops.interp import interp, interpn
from ..utils import add_mag, resolve_device
from .nn import FastNNPredictor, sed_params
from .tracks import empirical_corrections

DEFAULT_PREDICTIONS = ["mini", "mass", "logl", "logt", "logr", "logg",
                       "feh_surf", "afe_surf"]

# Prediction-column indices of the pure-function path.
IsoIdx = namedtuple("IsoIdx", ["logt", "logl", "logg", "feh_surf",
                               "afe_surf", "mini"])


def iso_predictions(xgrid, ygrid, idx, eep, feh, afe, loga,
                    corr_params=None, apply_corr=True):
    """Isochrone predictions `(..., Npred)` at the EEPs `eep` (mirrors
    `brutus_tpu.models.isochrone.iso_predictions`; reference
    `brutus/seds.py:1218-1358`), with the empirical corrections.
    `eep`, `feh`, `afe`, `loga` and the correction parameters
    broadcast together."""
    t = lambda v: torch.as_tensor(v, dtype=ygrid.dtype, device=ygrid.device)
    eep, feh_v, afe_v, loga_v = torch.broadcast_tensors(
        t(eep), t(feh), t(afe), t(loga))
    labels = torch.stack([feh_v, afe_v, loga_v, eep], dim=-1)
    preds = interpn(xgrid, ygrid, labels)
    if apply_corr:
        mini = preds[..., idx.mini]
        dlogt, dlogr = empirical_corrections(mini, eep, feh_v, corr_params)
        preds = preds.clone()
        preds[..., idx.logt] += dlogt
        preds[..., idx.logl] += 2.0 * dlogr
        preds[..., idx.logg] += -2.0 * dlogr
    return preds


def _nn_sed(nn_params, idx, preds, av, rv, dist, mini_bound):
    """SEDs of prediction vectors through the BC networks, NaN below the
    `mini_bound` mass cut (mirrors `brutus_tpu.models.isochrone._nn_sed`)."""
    sed = sed_params(nn_params, logt=preds[..., idx.logt],
                     logg=preds[..., idx.logg],
                     feh_surf=preds[..., idx.feh_surf],
                     afe=preds[..., idx.afe_surf], logl=preds[..., idx.logl],
                     av=av, rv=rv, dist=dist)
    ok = preds[..., idx.mini] >= mini_bound
    return torch.where(ok[..., None], sed, torch.full_like(sed, torch.nan))


def population_seds_multi(xgrid, ygrid, nn_params, idx, eep, feh, afe,
                          loga, av, rv, dist, smf_vals, mini_bound,
                          eep_binary_max, corr_params=None):
    """Co-eval population SEDs at every EEP for every secondary mass
    fraction in `smf_vals` (mirrors `brutus_tpu.models.isochrone.
    population_seds_multi`, mapped over a batch): the primary is
    interpolated and evaluated once, the secondaries of every binary smf
    together.

    eep : (K,).  feh, afe, loga, av, rv, dist and each correction
        parameter : `(W,)` or scalars, one entry per set of cluster
        parameters.
    smf_vals : tuple of floats (0: single star; 1: equal-mass doubling
        on the main sequence; else mass-fraction binaries, reference
        `brutus/seds.py:1464-1496`).

    Returns `seds (W, Nsmf, K, F)` (NaN = invalid) and the primary
    initial masses `mini (W, K)`.
    """
    t = lambda v: torch.as_tensor(v, dtype=ygrid.dtype, device=ygrid.device)
    col = lambda v: t(v).reshape(-1, 1)         # (W, 1) or (1, 1)
    eep = t(eep)
    feh, afe, loga, av, rv, dist = (col(v) for v in
                                    (feh, afe, loga, av, rv, dist))
    corr = None if corr_params is None else tuple(col(c) for c in
                                                  corr_params)
    params = iso_predictions(xgrid, ygrid, idx, eep, feh, afe, loga, corr)
    mini = params[..., idx.mini]                                # (W, K)
    sed1 = _nn_sed(nn_params, idx, params, av, rv, dist, mini_bound)
    W = mini.shape[0]

    bin_smfs = tuple(s for s in smf_vals if 0.0 < s < 1.0)
    seds_bin = None
    if bin_smfs:
        # Invert the monotone mini(eep) relation once; every binary smf
        # queries it (reference seds.py:1467-1478).
        mini_sorted = torch.where(torch.isfinite(mini), mini,
                                  torch.full_like(mini, torch.inf))
        order = torch.argsort(mini_sorted, dim=-1, stable=True)
        mg = torch.gather(mini_sorted, -1, order)
        eg = eep[order]
        smf_arr = t(bin_smfs)[:, None]                           # (Nb, 1)
        q = (mini[:, None, :] * smf_arr).reshape(W, -1)          # (W, Nb*K)
        eep2 = interp(q, mg, eg, left=torch.nan,
                      right=torch.nan).reshape(W, len(bin_smfs), -1)
        eep2 = torch.where((eep2 > eep_binary_max)
                           | (eep > eep_binary_max),
                           torch.full_like(eep2, torch.nan), eep2)
        sub = lambda v: v[:, :, None]                            # (W,1,1)
        params2 = iso_predictions(
            xgrid, ygrid, idx, eep2, sub(feh), sub(afe), sub(loga),
            None if corr is None else tuple(sub(c) for c in corr))
        sed2 = _nn_sed(nn_params, idx, params2, sub(av), sub(rv), sub(dist),
                       mini_bound)
        seds_bin = add_mag(sed1[:, None], sed2)              # (W, Nb, K, F)

    out, k = [], 0
    for smf in smf_vals:
        if smf == 0.0:
            out.append(sed1)
        elif smf == 1.0:
            boost = torch.where((eep <= eep_binary_max)[:, None],
                                t(2.5 * np.log10(2.0)), t(0.0))
            out.append(sed1 - boost)
        else:
            out.append(seds_bin[:, k])
            k += 1
    return torch.stack(out, dim=1), mini


def read_isochrone_file(path):
    """`(feh, afe, loga, eep, predictions, labels)` of an isochrone-schema
    HDF5 (the arrays `Isochrone` is built from)."""
    import h5py
    with h5py.File(path, "r") as f:
        return (f["feh"][:], f["afe"][:], f["loga"][:], f["eep"][:],
                np.asarray(f["predictions"][:], dtype=float),
                [s.decode() if isinstance(s, bytes) else str(s)
                 for s in f["predictions"].attrs["labels"]])


def fill_eep_holes(pred_grid, eep_u):
    """Each isochrone's partly valid stretch filled by linear
    interpolation over EEP, NaN beyond its ends (reference
    `brutus/seds.py:1172-1187`); `pred_grid (feh, afe, loga, eep, Npred)`
    is filled in place and returned."""
    for i in range(pred_grid.shape[0]):
        for j in range(pred_grid.shape[1]):
            for k in range(pred_grid.shape[2]):
                sel = np.all(np.isfinite(pred_grid[i, j, k]), axis=1)
                if 2 <= sel.sum() < len(eep_u):
                    for p in range(pred_grid.shape[-1]):
                        pred_grid[i, j, k, :, p] = np.interp(
                            eep_u, eep_u[sel], pred_grid[i, j, k, sel, p],
                            left=np.nan, right=np.nan)
    return pred_grid


class Isochrone:
    """Isochrone SEDs over the `(feh, afe, loga, eep)` grid (mirrors
    `brutus_tpu.models.isochrone.Isochrone`).

    Built from an isochrone file (`mistfile`) or from its arrays
    (`arrays`, as `read_isochrone_file` returns them), both hole-filled
    and padded here; `convert.isochrone_from_numpy` takes finished
    tables.  The networks come from `nnfile` or a `FastNNPredictor`
    (`nn`).  The tables live on `device` (CUDA unless the caller names
    another) in float64.
    """

    def __init__(self, filters=None, nnfile=None, mistfile=None,
                 predictions=None, verbose=True, device=None,
                 arrays=None, nn=None):
        from ..filters import FILTERS
        self.filters = list(FILTERS if filters is None else filters)
        if verbose:
            sys.stderr.write(f"Filters: {self.filters}\n")
        dev = resolve_device(device)
        if arrays is None:
            if verbose:
                sys.stderr.write("Constructing MIST isochrones...")
            arrays = read_isochrone_file(
                mistfile or "data/DATAFILES/MIST_1.2_iso_vvcrit0.0.h5")
            if verbose:
                sys.stderr.write("done!\n")
        feh_grid, afe_grid, loga_grid, eep_grid, pred_grid, labels = arrays
        self.pred_labels = list(labels)
        self.predictions = (list(predictions) if predictions is not None
                            else self.pred_labels)
        self.feh_u = np.unique(feh_grid)
        self.afe_u = np.unique(afe_grid)
        self.loga_u = np.unique(loga_grid)
        self.eep_u = np.unique(eep_grid)
        pred_grid = fill_eep_holes(np.array(pred_grid, dtype=float),
                                   self.eep_u)
        # Pad a singleton afe axis (reference seds.py:1189-1201).
        xgrid = [self.feh_u.astype(float), self.afe_u.astype(float),
                 self.loga_u.astype(float), self.eep_u.astype(float)]
        if len(xgrid[1]) == 1:
            v = xgrid[1][0]
            xgrid[1] = np.array([v - 1e-5, v + 1e-5])
            pred_grid = np.concatenate([pred_grid, pred_grid], axis=1)
        self._set_tables(xgrid, pred_grid, dev)
        self.FNNP = nn if nn is not None else FastNNPredictor(
            filters=self.filters, nnfile=nnfile, verbose=verbose,
            device=dev)

    def _set_tables(self, xgrid, ygrid, device):
        self.device = device
        t = lambda a: torch.as_tensor(np.array(a, float), device=device)
        self.xgrid = tuple(t(g) for g in xgrid)
        self.ygrid = t(ygrid)
        for name in ("logt", "logl", "logg", "feh_surf", "afe_surf",
                     "mini"):
            setattr(self, f"{name}_idx", self.predictions.index(name))

    @property
    def iso_idx(self):
        """`IsoIdx` of the pure-function path."""
        return IsoIdx(self.logt_idx, self.logl_idx, self.logg_idx,
                      self.feh_surf_idx, self.afe_surf_idx, self.mini_idx)

    @property
    def tables(self):
        """`(xgrid, ygrid, nn_params)` of the pure-function path."""
        return (self.xgrid, self.ygrid, self.FNNP.params)

    def get_predictions(self, feh=0.0, afe=0.0, loga=8.5, eep=None,
                        apply_corr=True, corr_params=None):
        """Predictions `(Neep, Npred)` along the isochrone (reference
        `brutus/seds.py:1218-1358`)."""
        if eep is None:
            eep = self.eep_u
        return iso_predictions(self.xgrid, self.ygrid, self.iso_idx, eep,
                               feh, afe, loga, corr_params,
                               apply_corr=apply_corr)

    def get_corrections(self, mini=1.0, feh=0.0, eep=350.0,
                        corr_params=None):
        return empirical_corrections(mini, eep, feh, corr_params)

    def get_seds(self, feh=0.0, afe=0.0, loga=8.5, eep=None, av=0.0,
                 rv=3.3, smf=0.0, dist=1000.0, mini_bound=0.5,
                 eep_binary_max=480.0, apply_corr=True, corr_params=None,
                 return_dict=True, **kwargs):
        """SEDs `(Neep, Nfilt)` of the co-eval population at every EEP,
        with `params` and `params2` (mirrors `brutus_tpu.models.
        isochrone.Isochrone.get_seds`): a secondary of `0 < smf < 1`
        found by interpolating the monotone `mini(eep)` relation, `smf ==
        1` doubling the flux on the main sequence (reference
        seds.py:1464-1496)."""
        if eep is None:
            eep = self.eep_u
        eep = torch.as_tensor(eep, dtype=self.ygrid.dtype,
                              device=self.device)
        params = self.get_predictions(feh=feh, afe=afe, loga=loga, eep=eep,
                                      apply_corr=apply_corr,
                                      corr_params=corr_params)
        mini = params[:, self.mini_idx]

        def nn(p, ok):
            sed = self.FNNP.sed(
                logt=p[:, self.logt_idx], logg=p[:, self.logg_idx],
                feh_surf=p[:, self.feh_surf_idx],
                afe=p[:, self.afe_surf_idx], logl=p[:, self.logl_idx],
                av=av, rv=rv, dist=dist)
            return torch.where(ok[:, None], sed,
                               torch.full_like(sed, torch.nan))

        seds = nn(params, mini >= mini_bound)
        params2 = torch.full_like(params, torch.nan)
        if 0.0 < smf < 1.0:
            # Invert the monotone mini(eep) relation by interpolation
            # (reference seds.py:1467-1478).
            mini_sorted = torch.where(torch.isfinite(mini), mini,
                                      torch.full_like(mini, torch.inf))
            order = torch.argsort(mini_sorted, stable=True)
            eep2 = interp(mini * smf, mini_sorted[order], eep[order],
                          left=torch.nan, right=torch.nan)
            eep2 = torch.where((eep2 > eep_binary_max)
                               | (eep > eep_binary_max),
                               torch.full_like(eep2, torch.nan), eep2)
            params2 = self.get_predictions(feh=feh, afe=afe, loga=loga,
                                           eep=eep2, apply_corr=apply_corr,
                                           corr_params=corr_params)
            seds2 = nn(params2, params2[:, self.mini_idx] >= mini_bound)
            seds = add_mag(seds, seds2)
        elif smf == 1.0:
            boost = torch.where((eep <= eep_binary_max)[:, None],
                                seds.new_tensor(2.5 * np.log10(2.0)),
                                seds.new_tensor(0.0))
            seds = seds - boost
            params2 = params

        if return_dict:
            p1 = {n: params[:, i].cpu().numpy()
                  for i, n in enumerate(self.predictions)}
            p2 = {n: params2[:, i].cpu().numpy()
                  for i, n in enumerate(self.predictions)}
            return seds, p1, p2
        return seds, params, params2


def write_isochrone_file(path, feh_grid, afe_grid, loga_grid, eep_grid,
                         pred_grid, pred_labels):
    """Write an isochrone-schema HDF5 (mirrors `brutus_tpu.models.
    isochrone.write_isochrone_file`)."""
    import h5py
    with h5py.File(path, "w") as f:
        f.create_dataset("feh", data=feh_grid)
        f.create_dataset("afe", data=afe_grid)
        f.create_dataset("loga", data=loga_grid)
        f.create_dataset("eep", data=eep_grid)
        d = f.create_dataset("predictions", data=pred_grid)
        d.attrs["labels"] = [np.bytes_(s) for s in pred_labels]


__all__ = ["Isochrone", "write_isochrone_file", "read_isochrone_file",
           "fill_eep_holes", "DEFAULT_PREDICTIONS", "IsoIdx",
           "iso_predictions", "population_seds_multi"]
