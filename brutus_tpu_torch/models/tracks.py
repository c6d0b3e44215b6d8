"""
MIST stellar evolution track interpolator (mirrors
`brutus_tpu/models/tracks.py`).

Parity: reference `brutus/seds.py:49-384` (`MISTtracks`): the MIST v1.2
EEP-track library arranged on the rectilinear `(mini, eep, feh, afe)`
label grid, with d(age)/d(EEP) "age weights", serving multilinear
predictions of `[loga, logl, logt, logg, feh_surf, afe_surf(, agewt)]`
with optional empirical corrections below 1 Msun.

The one-time restructuring of the library runs on the host in numpy
(`tracks_tables`); the tables then live on the device and predictions
run through `ops.interp.interpn`.  h5py is imported only inside the
file reader and writer.
"""

import sys

import numpy as np
import torch

from ..ops.interp import interpn
from ..utils import _tensor, resolve_device

# HDF5 column names of each label / prediction
# (reference `brutus/seds.py:32-43`).
RENAME = {"mini": "initial_mass", "eep": "EEP", "feh": "initial_[Fe/H]",
          "afe": "initial_[a/Fe]", "mass": "star_mass",
          "feh_surf": "[Fe/H]", "afe_surf": "[a/Fe]", "loga": "log_age",
          "logt": "log_Teff", "logg": "log_g", "logl": "log_L",
          "logr": "log_R"}

LABELS = ["mini", "eep", "feh", "afe"]
DEFAULT_PREDICTIONS = ["loga", "logl", "logt", "logg",
                       "feh_surf", "afe_surf"]
DEFAULT_CORR_PARAMS = (0.09, -0.09, 30.0, 0.5)


def empirical_corrections(mini, eep, feh, corr_params=None):
    """Empirical `(dlogt, dlogr)` against mass, EEP and metallicity
    (mirrors `brutus_tpu.models.tracks.empirical_corrections`; reference
    `brutus/seds.py:314-384`): zero at and above 1 Msun, decaying past
    the MSTO (eep = 454), scaled by exp(feh_scale * feh).  The
    correction parameters may be numbers or tensors that broadcast."""
    dtdm, drdm, msto_smooth, feh_scale = (
        DEFAULT_CORR_PARAMS if corr_params is None else corr_params)
    mini, eep, feh = (_tensor(v) for v in (mini, eep, feh))
    dlogt = torch.log10(1.0 + (mini - 1.0) * dtdm)
    dlogr = torch.log10(1.0 + (mini - 1.0) * drdm)
    ecorr = 1.0 - 1.0 / (1.0 + torch.exp(-(eep - 454.0) / msto_smooth))
    fcorr = torch.exp(feh_scale * feh)
    on = mini < 1.0
    zero = torch.zeros((), dtype=dlogt.dtype, device=dlogt.device)
    dlogt = torch.where(on, dlogt * ecorr * fcorr, zero)
    dlogr = torch.where(on, dlogr * ecorr * fcorr, zero)
    return dlogt, dlogr


def apply_corrections(preds, dlogt, dlogr, logt_idx, logl_idx, logg_idx):
    """`preds` with `logt += dlogt`, `logl += 2 dlogr`, `logg -= 2 dlogr`
    (mirrors `brutus_tpu.models.tracks.apply_corrections`; reference
    `brutus/seds.py:299-311`)."""
    preds = preds.clone()
    preds[..., logt_idx] += dlogt
    preds[..., logl_idx] += 2.0 * dlogr
    preds[..., logg_idx] += -2.0 * dlogr
    return preds


def read_tracks_library(mistfile, predictions):
    """`(libparams, output)` of every track listed under the file's
    `index` (reference `brutus/seds.py:113-152` schema): the label
    columns by name, and the prediction columns `(rows, npred)`, with a
    missing `afe_surf` zero-filled (`seds.py:143-152`)."""
    import h5py
    with h5py.File(mistfile, "r") as f:
        names = [z for z in f["index"]]
        lab_cols = [RENAME[p] for p in LABELS]
        pred_cols = [RENAME[p] for p in predictions]
        lib, out = [], []
        for z in names:
            arr = f[z][:]
            lib.append(np.stack([arr[c] for c in lab_cols], axis=-1))
            row = []
            for c in pred_cols:
                if c in arr.dtype.names:
                    row.append(arr[c])
                elif c == RENAME["afe_surf"]:
                    row.append(np.zeros(len(arr)))
                else:
                    raise KeyError(c)
            out.append(np.stack(row, axis=-1))
    lib = np.concatenate(lib)
    return ({p: lib[:, i] for i, p in enumerate(LABELS)},
            np.concatenate(out))


def tracks_library(mini_grid, eep_grid, feh_grid, afe_grid, predict_fn,
                   predictions=None):
    """`(libparams, output)` of the tracks that `write_tracks_file` would
    write from the same generator, built in memory (for a host without
    h5py): one track per `(mini, feh, afe)`, every EEP of `eep_grid`."""
    predictions = list(predictions or DEFAULT_PREDICTIONS)
    mm, zz, aa = (v.ravel() for v in np.meshgrid(
        mini_grid, feh_grid, afe_grid, indexing="ij"))
    eep = np.asarray(eep_grid, float)
    n = len(eep)
    libparams = dict(mini=np.repeat(mm, n), eep=np.tile(eep, len(mm)),
                     feh=np.repeat(zz, n), afe=np.repeat(aa, n))
    cols = predict_fn(libparams["mini"], libparams["eep"], libparams["feh"],
                      libparams["afe"])
    zero = np.zeros(len(libparams["eep"]))

    def column(p):
        if RENAME[p] in cols:
            return np.broadcast_to(cols[RENAME[p]], zero.shape)
        if p == "afe_surf":
            return zero
        raise KeyError(RENAME[p])

    return libparams, np.stack([column(p) for p in predictions], axis=-1)


def _age_weights(ygrid, ageidx):
    """d(age)/d(EEP) along each track, `np.gradient` over its contiguous
    valid stretch (reference `brutus/seds.py:179-223`), appended as the
    last prediction."""
    age = 10.0 ** ygrid[..., ageidx]                 # (mini, eep, feh, afe)
    n_eep = age.shape[1]
    flat = age.transpose(0, 2, 3, 1).reshape(-1, n_eep)
    wflat = np.full_like(flat, np.nan)
    for i in range(flat.shape[0]):
        good = np.isfinite(flat[i])
        if good.sum() >= 2:
            wflat[i, good] = np.gradient(flat[i, good])
    agewt = wflat.reshape(age.shape[0], age.shape[2], age.shape[3],
                          n_eep).transpose(0, 3, 1, 2)
    return np.concatenate([ygrid, agewt[..., None]], axis=-1)


def tracks_tables(libparams, output, predictions, ageweight=True):
    """The host build of the interpolation tables from the library rows
    (mirrors `brutus_tpu.models.tracks.MISTtracks.__init__`): the rows
    scattered onto the rectilinear label grid (NaN where absent), the
    age weights, and a singleton afe axis padded to `v -+ 1e-5`
    (reference `brutus/seds.py:243-255`).  Returns `(gridpoints, xgrid,
    ygrid, predictions)` as numpy."""
    predictions = list(predictions)
    gridpoints = {p: np.unique(libparams[p]) for p in LABELS}
    dims = [len(gridpoints[p]) for p in LABELS]
    idx = tuple(np.searchsorted(gridpoints[p], libparams[p])
                for p in LABELS)
    ygrid = np.full(dims + [output.shape[1]], np.nan)
    ygrid[idx] = output
    if ageweight:
        ygrid = _age_weights(ygrid, predictions.index("loga"))
        predictions = predictions + ["agewt"]
    xgrid = [gridpoints[p].astype(float) for p in LABELS]
    if len(xgrid[3]) == 1:
        v = xgrid[3][0]
        xgrid[3] = np.array([v - 1e-5, v + 1e-5])
        ygrid = np.concatenate([ygrid, ygrid], axis=3)
    return gridpoints, xgrid, ygrid, predictions


class MISTtracks:
    """Multilinear interpolator over the MIST EEP-track library (mirrors
    `brutus_tpu.models.tracks.MISTtracks`).

    Built from a track file (`mistfile`) or from its rows
    (`library = (libparams, output)`, as `read_tracks_library` returns
    them), both through `tracks_tables`; `convert.tracks_from_numpy`
    takes finished tables.  The tables live on `device` (CUDA unless the
    caller names another) in float64.
    """

    def __init__(self, mistfile=None, predictions=None, ageweight=True,
                 verbose=True, device=None, library=None):
        predictions = list(predictions or DEFAULT_PREDICTIONS)
        dev = resolve_device(device)
        if library is None:
            mistfile = mistfile or "data/DATAFILES/MIST_1.2_EEPtrk.h5"
            if verbose:
                sys.stderr.write("Constructing MIST library...")
            library = read_tracks_library(mistfile, predictions)
            if verbose:
                sys.stderr.write("done!\n")
        self._set_tables(*tracks_tables(*library, predictions, ageweight),
                         dev)

    def _set_tables(self, gridpoints, xgrid, ygrid, predictions, device):
        self.labels = list(LABELS)
        self.predictions = list(predictions)
        self.gridpoints = {k: np.asarray(v) for k, v in gridpoints.items()}
        self.mini_bound = self.gridpoints["mini"].min()
        self.device = device
        t = lambda a: torch.as_tensor(np.array(a, float), device=device)
        self.xgrid = tuple(t(g) for g in xgrid)
        self.ygrid = t(ygrid)
        self._ageidx = self.predictions.index("loga")
        # loga alone, for the bisection of `SEDmaker.get_eep`
        self._loga_grid = self.ygrid[..., self._ageidx].contiguous()
        self.logt_idx = self.predictions.index("logt")
        self.logl_idx = self.predictions.index("logl")
        self.logg_idx = self.predictions.index("logg")
        self.ndim, self.npred = len(self.labels), len(self.predictions)

    def _labels(self, labels):
        return torch.as_tensor(labels, dtype=self.ygrid.dtype,
                               device=self.device)

    def get_predictions(self, labels, apply_corr=True, corr_params=None):
        """Interpolated predictions at `labels (..., 4)` in the order
        `(mini, eep, feh, afe)` (reference `brutus/seds.py:263-312`)."""
        labels = self._labels(labels)
        single = labels.dim() == 1
        preds = interpn(self.xgrid, self.ygrid, labels)
        if apply_corr:
            dlogt, dlogr = empirical_corrections(
                labels[..., 0], labels[..., 1], labels[..., 2], corr_params)
            preds = apply_corrections(preds, dlogt, dlogr, self.logt_idx,
                                      self.logl_idx, self.logg_idx)
        return preds[0] if single and preds.dim() > 1 else preds

    def get_corrections(self, labels, corr_params=None):
        labels = self._labels(labels)
        return empirical_corrections(labels[..., 0], labels[..., 1],
                                     labels[..., 2], corr_params)


def write_tracks_file(path, mini_grid, eep_grid, feh_grid, afe_grid,
                      predict_fn):
    """Write a MIST-EEP-track-schema HDF5 from a generator
    `predict_fn(mini, eep, feh, afe) -> {column: values}` (mirrors
    `brutus_tpu.models.tracks.write_tracks_file`)."""
    import h5py
    cols = ["initial_mass", "EEP", "initial_[Fe/H]", "initial_[a/Fe]",
            "star_mass", "[Fe/H]", "[a/Fe]", "log_age", "log_Teff",
            "log_g", "log_L", "log_R"]
    dt = np.dtype([(c, float) for c in cols])
    with h5py.File(path, "w") as f:
        names = []
        for m in mini_grid:
            for z in feh_grid:
                for a in afe_grid:
                    name = f"m{m:.3f}_z{z:+.2f}_a{a:+.2f}"
                    names.append(name)
                    arr = np.zeros(len(eep_grid), dtype=dt)
                    arr["initial_mass"] = m
                    arr["EEP"] = eep_grid
                    arr["initial_[Fe/H]"] = z
                    arr["initial_[a/Fe]"] = a
                    for k, v in predict_fn(m, np.asarray(eep_grid), z,
                                           a).items():
                        arr[k] = v
                    f.create_dataset(name, data=arr)
        f.create_dataset("index",
                         data=np.array(names, dtype=h5py.string_dtype()))


__all__ = ["MISTtracks", "empirical_corrections", "apply_corrections",
           "write_tracks_file", "read_tracks_library", "tracks_library",
           "tracks_tables",
           "DEFAULT_PREDICTIONS", "DEFAULT_CORR_PARAMS"]
