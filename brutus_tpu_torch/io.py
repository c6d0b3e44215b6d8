"""
Host-side I/O of the PyTorch port (mirrors `brutus_tpu/io.py`): the
model-grid file, photometric offsets, the results file and the
remote-data registry.

- `load_models` / `save_models`: the grid HDF5 with per-filter
  `mag_coeffs`, `labels` and `parameters` (reference
  `brutus/utils.py:520-662`).
- `load_offsets`: per-band flux zero-points (reference
  `brutus/utils.py:665-715`).
- `ResultsWriter`: the reference's 13-dataset results schema
  (`brutus/fitting.py:1632-1662`), written batch by batch, and
  reopened by `resume=True` at its `cursor`.  Files from both packages
  compare dataset by dataset.
- `fetch` and the `fetch_*` helpers: the Harvard Dataverse registry
  (reference `brutus/data.py`) on the standard library alone, with
  SHA256 checks, a local cache and symlinks into the caller's
  directory.
- `read_fits_table`: a numpy reader of FITS binary tables.

h5py is imported only inside the functions that open a file: a fit
with `save_file=None` never needs it.
"""

import hashlib
import os
import pathlib
import sys

import numpy as np

from .filters import FILTERS

DEFAULT_LABELS = ["mini", "feh", "eep", "smf",
                  "loga", "logl", "logt", "logg",
                  "Mr", "agewt"]

# Dataverse registry (reference brutus/data.py:7-44):
# file name -> (dataset DOI, SHA256 of the published file).
DATA_REGISTRY = {
    "MIST_1.2_iso_vvcrit0.0.h5": (
        "10.7910/DVN/FZMFQY/BKAG41",
        "ac46048acb9c9c1c10f02ac1bd958a8c4dd80498923297907fd64c5f3d82cb57"),
    "MIST_1.2_iso_vvcrit0.4.h5": (
        "10.7910/DVN/FZMFQY/PRGJIP",
        "25d97db9760df5e4e3b65c686a04d5247cae5027c55683e892acb7d1a05c30f7"),
    "MIST_1.2_EEPtrk.h5": (
        "10.7910/DVN/JV866N/FJ5NNO",
        "001558c1b32f4a85ea9acca3ad3f7332a565167da3f6164a565c3f3f05afc11b"),
    "bayestar2019_v1.h5": (
        "10.7910/DVN/G49MEI/Y9UZPG",
        "73064ab18f4d1d57b356f7bd8cbcc77be836f090f660cca6727da85ed973d1e6"),
    "grid_mist_v9.h5": (
        "10.7910/DVN/7BA4ZG/Z7MGA7",
        "7d128a5caded78ca9d1788a8e6551b4329aeed9ca74e7a265e531352ecb75288"),
    "grid_mist_v8.h5": (
        "10.7910/DVN/7BA4ZG/NKVZFT",
        "b07d9c19e7ff5e475b1b061af6d1bb4ebd13e0e894fd0703160206964f1084e0"),
    "grid_bayestar_v5.h5": (
        "10.7910/DVN/7BA4ZG/LLZP0B",
        "c5d195430393ebd6c8865a9352c8b0906b2c43ec56d3645bb9d5b80e6739fd0c"),
    "offsets_mist_v8.txt": (
        "10.7910/DVN/L7D1FY/QTNKKN",
        "35425281b5d828431ca5ef93262cb7c6f406814b649d7e7ca4866b8203408e5f"),
    "offsets_bs_v9.txt": (
        "10.7910/DVN/L7D1FY/W4O6NJ",
        "b5449c08eb7b894b6d9aa1449a351851ca800ef4ed461c987434a0c250cba386"),
    "nn_c3k.h5": (
        "10.7910/DVN/MSCY2O/XHU1VJ",
        "bc86d4bf55b2173b97435d24337579a2f337e80ed050c73f1e31abcd04163259"),
}

# Back-compat view of the registry (name -> DOI).
DATAVERSE_DOIS = {k: v[0] for k, v in DATA_REGISTRY.items()}

DATAVERSE_URL = ("https://dataverse.harvard.edu/api/access/datafile/"
                 ":persistentId?persistentId=doi:")

DATA_DIR_ENV = "ASTRO_BRUTUS_DATA_DIR"


def data_dir():
    """Local cache directory (mirrors `io.data_dir`; env-overridable,
    reference brutus/data.py:38)."""
    return os.environ.get(DATA_DIR_ENV,
                          os.path.join(os.path.expanduser("~"),
                                       ".cache", "brutus_tpu"))


def sha256sum(path, chunk=1 << 20):
    """Streaming SHA256 of a file."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _download(url, dest, verbose=True, chunk=1 << 20):
    """Stream `url` into `dest` with a stderr progress meter."""
    import urllib.request
    req = urllib.request.Request(url, headers={"User-Agent": "brutus-tpu"})
    with urllib.request.urlopen(req) as resp, open(dest, "wb") as f:
        total = int(resp.headers.get("Content-Length") or 0)
        done = 0
        while True:
            block = resp.read(chunk)
            if not block:
                break
            f.write(block)
            done += len(block)
            if verbose and total:
                sys.stderr.write(f"\rdownloading {os.path.basename(dest)}: "
                                 f"{100.0 * done / total:6.2f}%")
                sys.stderr.flush()
        if verbose and total:
            sys.stderr.write("\n")


def fetch(name, target_dir=None, verbose=True, retries=3):
    """Fetch a registered data file, verifying its SHA256.

    Parity: reference `brutus/data.py` + `brutus/utils.py:350-360`
    (`_fetch`), without the pooch dependency.  The file is cached at
    `data_dir()` (override with `ASTRO_BRUTUS_DATA_DIR`), downloaded
    from its Harvard Dataverse persistent DOI only when missing or
    corrupt, and symlinked into `target_dir` when given.

    Returns the path of the cached file (or of the symlink).
    """
    if name not in DATA_REGISTRY:
        raise KeyError(f"unknown data file {name!r}; known: "
                       f"{sorted(DATA_REGISTRY)}")
    doi, ref_hash = DATA_REGISTRY[name]
    cache = pathlib.Path(data_dir())
    cache.mkdir(parents=True, exist_ok=True)
    fpath = cache / name

    if not (fpath.exists() and sha256sum(fpath) == ref_hash):
        url = DATAVERSE_URL + doi
        tmp = fpath.with_name(fpath.name + ".part")
        last_err = None
        for attempt in range(retries):
            try:
                _download(url, tmp, verbose=verbose)
                got = sha256sum(tmp)
                if got != ref_hash:
                    raise IOError(
                        f"SHA256 mismatch for {name}: expected {ref_hash}, "
                        f"got {got}")
                os.replace(tmp, fpath)
                last_err = None
                break
            except OSError as err:     # network, disk or hash: retried
                last_err = err
                if tmp.exists():
                    tmp.unlink()
        if last_err is not None:
            raise RuntimeError(
                f"failed to fetch {name} (doi:{doi}) after {retries} "
                f"attempts: {last_err}") from last_err

    if target_dir is not None:
        target = pathlib.Path(target_dir).resolve() / name
        target.parent.mkdir(parents=True, exist_ok=True)
        if not target.exists():
            target.symlink_to(fpath)
        return str(target)
    return str(fpath)


def fetch_isos(target_dir=".", iso="MIST_1.2_vvcrit0.0"):
    """Fetch a MIST isochrone file (reference `utils.py:363-387`)."""
    names = {"MIST_1.2_vvcrit0.0": "MIST_1.2_iso_vvcrit0.0.h5",
             "MIST_1.2_vvcrit0.4": "MIST_1.2_iso_vvcrit0.4.h5"}
    if iso not in names:
        raise ValueError(f"unknown isochrone set {iso!r}")
    return fetch(names[iso], target_dir)


def fetch_tracks(target_dir=".", track="MIST_1.2_vvcrit0.0"):
    """Fetch the MIST EEP track file (reference `utils.py:390-410`)."""
    if track != "MIST_1.2_vvcrit0.0":
        raise ValueError(f"unknown track set {track!r}")
    return fetch("MIST_1.2_EEPtrk.h5", target_dir)


def fetch_dustmaps(target_dir=".", dustmap="bayestar19"):
    """Fetch the Bayestar19 3-D dust map (reference `utils.py:413-433`)."""
    if dustmap != "bayestar19":
        raise ValueError(f"unknown dust map {dustmap!r}")
    return fetch("bayestar2019_v1.h5", target_dir)


def fetch_grids(target_dir=".", grid="mist_v9"):
    """Fetch a pre-computed model grid (reference `utils.py:436-463`)."""
    names = {"mist_v8": "grid_mist_v8.h5", "mist_v9": "grid_mist_v9.h5",
             "bayestar_v5": "grid_bayestar_v5.h5"}
    if grid not in names:
        raise ValueError(f"unknown grid {grid!r}")
    return fetch(names[grid], target_dir)


def fetch_offsets(target_dir=".", offsets="mist_v8"):
    """Fetch a photometric offset table (reference `utils.py:466-493`)."""
    names = {"mist_v8": "offsets_mist_v8.txt", "bs_v9": "offsets_bs_v9.txt"}
    if offsets not in names:
        raise ValueError(f"unknown offsets table {offsets!r}")
    return fetch(names[offsets], target_dir)


def fetch_nns(target_dir=".", nns="c3k"):
    """Fetch the BC neural-network file (reference `utils.py:496-517`)."""
    if nns != "c3k":
        raise ValueError(f"unknown NN set {nns!r}")
    return fetch("nn_c3k.h5", target_dir)


def load_models(filepath, filters=None, labels=None,
                include_ms=True, include_postms=True, include_binaries=False,
                dtype=np.float32, verbose=True):
    """Load a model grid into `(Nmodel, Nfilt, 3)` coefficients + labels.

    Parity: reference `brutus/utils.py:520-662`, including the
    main-sequence/post-main-sequence split at `eep = 454` and the
    single-star cut `smf == 0` when binaries are excluded.

    Returns
    -------
    models : (Nmodel, Nfilt, 3) float array of `(mag, r0, dr)` coeffs.
    labels : structured array of per-model labels.
    label_mask : structured array marking grid inputs vs derived params.
    """
    if filters is None:
        filters = FILTERS
    if labels is None:
        labels = list(DEFAULT_LABELS)

    import h5py
    try:
        f = h5py.File(filepath, "r", libver="latest", swmr=True)
    except (OSError, ValueError):
        f = h5py.File(filepath, "r")

    with f:
        mag_coeffs = f["mag_coeffs"]
        n_models = len(mag_coeffs)
        avail = [f_ for f_ in filters if f_ in mag_coeffs.dtype.names]
        n_coef = len(mag_coeffs[avail[0]][0]) if avail else 3
        models = np.zeros((n_models, len(filters), n_coef), dtype=dtype)
        loaded = np.zeros(len(filters), dtype=bool)
        for i, filt in enumerate(filters):
            if filt in mag_coeffs.dtype.names:
                models[:, i] = mag_coeffs[filt]
                loaded[i] = True
                if verbose:
                    sys.stderr.write(f"\rReading filter {filt}          ")
                    sys.stderr.flush()
        if verbose:
            sys.stderr.write("\n")
        models = models[:, loaded, :]

        combined = np.full(n_models, np.nan,
                           dtype=np.dtype([(n, float) for n in labels]))
        label_mask = np.zeros(1, dtype=np.dtype([(n, bool) for n in labels]))
        if "labels" in f:
            flabels = f["labels"][:]
            for n in flabels.dtype.names:
                if n in labels:
                    combined[n] = flabels[n]
                    label_mask[n] = True
        if "parameters" in f:
            fparams = f["parameters"][:]
            for n in fparams.dtype.names:
                if n in labels:
                    combined[n] = fparams[n]

    present = [n for n in labels if not np.isnan(combined[n][0])]

    sel = np.ones(n_models, dtype=bool)
    if not include_ms and not include_postms:
        raise ValueError("cannot exclude both the MS and post-MS models")
    if include_postms and not include_ms and "eep" in present:
        sel = combined["eep"] > 454.0
    elif include_ms and not include_postms and "eep" in present:
        sel = combined["eep"] <= 454.0
    if not include_binaries and "smf" in present:
        sel &= combined["smf"] == 0.0
        present = [n for n in present if n != "smf"]

    return models[sel], combined[present][sel], label_mask[present]


def save_models(filepath, models, labels, filters, parameters=None):
    """Write a model grid with the same schema `load_models` reads.

    This is the grid "checkpoint" format produced by
    `models.sedmaker.SEDmaker.make_grid`.
    """
    stype = np.dtype([(f, np.float32, (models.shape[2],)) for f in filters])
    mc = np.zeros(len(models), dtype=stype)
    for i, filt in enumerate(filters):
        mc[filt] = models[:, i, :]
    import h5py
    with h5py.File(filepath, "w") as f:
        f.create_dataset("mag_coeffs", data=mc)
        f.create_dataset("labels", data=labels)
        if parameters is not None:
            f.create_dataset("parameters", data=parameters)


def load_offsets(filepath, filters=None, verbose=True):
    """Multiplicative per-band flux zero-points from a text table.

    Parity: reference `brutus/utils.py:665-715` (absent filters default
    to 1; duplicate rows are an error).
    """
    if filters is None:
        filters = FILTERS
    filts, vals = np.loadtxt(filepath, dtype=str).T
    vals = vals.astype(float)
    offsets = np.full(len(filters), np.nan)
    for i, filt in enumerate(filters):
        where = np.flatnonzero(filts == filt)
        if len(where) == 1:
            offsets[i] = vals[where[0]]
        elif len(where) == 0:
            offsets[i] = 1.0
        else:
            raise ValueError(f"duplicate offsets for filter {filt!r}")
    if verbose:
        for filt, zp in zip(filters, offsets):
            sys.stderr.write(f"{filt} ({100 * (zp - 1.0):3.2}%)\n")
    return offsets


RESULTS_DATASETS = [
    # (name, per-draw?, dtype, extra shape)
    ("model_idx", True, "int32", ()),
    ("ml_scale", True, "float32", ()),
    ("ml_av", True, "float32", ()),
    ("ml_rv", True, "float32", ()),
    ("ml_cov_sar", True, "float32", (3, 3)),
    ("obj_log_post", True, "float32", ()),
    ("obj_log_evid", False, "float32", ()),
    ("obj_chi2min", False, "float32", ()),
    ("obj_Nbands", False, "int16", ()),
]
DRAW_DATASETS = [
    ("samps_dist", True, "float32", ()),
    ("samps_red", True, "float32", ()),
    ("samps_dred", True, "float32", ()),
    ("samps_logp", True, "float32", ()),
]


class ResultsWriter:
    """Incremental writer of the results schema (mirrors
    `io.ResultsWriter`).  `model_idx` rows start at -99, the
    reference's unfitted-row marker (fitting.py:1635), which is also the
    resume cursor: `resume=True` reopens an existing file for update."""

    def __init__(self, path, n_data, n_draws, labels=None,
                 save_dar_draws=True, resume=False):
        import h5py
        self.path = path if path.endswith(".h5") else f"{path}.h5"
        self.n_data = n_data
        self.n_draws = n_draws
        self.save_dar_draws = save_dar_draws
        mode = "r+" if (resume and os.path.exists(self.path)) else "w-"
        self.file = h5py.File(self.path, mode)
        if mode == "r+":
            return
        if labels is not None:
            self.file.create_dataset("labels", data=labels)
        specs = RESULTS_DATASETS + (DRAW_DATASETS if save_dar_draws
                                    else [])
        for name, per_draw, dtype, extra in specs:
            shape = ((n_data, n_draws) + extra if per_draw
                     else (n_data,) + extra)
            fill = -99 if name == "model_idx" else 0
            self.file.create_dataset(name, shape=shape, dtype=dtype,
                                     data=np.full(shape, fill, dtype=dtype))

    @property
    def cursor(self):
        """The first row not yet written."""
        todo = np.flatnonzero(self.file["model_idx"][:, 0] == -99)
        return int(todo[0]) if len(todo) else self.n_data

    def write_batch(self, start, out, n_valid=None):
        """Write per-star outputs (leading batch axis) from row `start`."""
        n = n_valid if n_valid is not None else len(out["model_idx"])
        sl = slice(start, start + n)
        f = self.file
        f["model_idx"][sl] = out["model_idx"][:n]
        f["ml_scale"][sl] = out["scale"][:n]
        f["ml_av"][sl] = out["av"][:n]
        f["ml_rv"][sl] = out["rv"][:n]
        f["ml_cov_sar"][sl] = out["cov_sar"][:n]
        f["obj_log_post"][sl] = out["lnprob"][:n]
        f["obj_log_evid"][sl] = out["log_evidence"][:n]
        f["obj_chi2min"][sl] = out["chi2min"][:n]
        f["obj_Nbands"][sl] = out["ndim"][:n]
        if self.save_dar_draws:
            f["samps_dist"][sl] = out["dist"][:n]
            f["samps_red"][sl] = out["red"][:n]
            f["samps_dred"][sl] = out["dred"][:n]
            f["samps_logp"][sl] = out["logwt"][:n]
        f.flush()

    def close(self):
        self.file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_results(path):
    """Read a results file back as a dict of numpy arrays."""
    import h5py
    out = {}
    with h5py.File(path if path.endswith(".h5") else f"{path}.h5",
                   "r") as f:
        for k in f:
            out[k] = f[k][:]
    return out




# FITS TFORM letter -> big-endian numpy dtype (binary-table subset).
_FITS_DTYPES = {"L": "u1", "B": "u1", "I": ">i2", "J": ">i4", "K": ">i8",
                "E": ">f4", "D": ">f8"}


def read_fits_table(path, hdu=1):
    """Minimal FITS binary-table reader (stdlib + numpy only).

    The reference reads its demo catalogs (e.g. `demos/NGC_2682.fits`,
    a Gaia x PS1 cross-match feeding the cluster-fitting demo) with
    astropy, which is not installed here; this parses the standard
    BINTABLE format directly.  Supports the scalar and fixed-length
    vector column types used by those catalogs (`L B I J K E D` and
    `rA` strings); variable-length arrays are not supported.

    Returns a numpy structured array (big-endian fields; use
    `arr[col].astype(float)` for computation).
    """
    import re

    def read_header(f):
        cards = {}
        while True:
            block = f.read(2880)
            if len(block) < 2880:
                raise ValueError("truncated FITS header")
            done = False
            for i in range(0, 2880, 80):
                card = block[i:i + 80].decode("ascii", "replace")
                key = card[:8].strip()
                if key == "END":
                    done = True
                    break
                if card[8:10] != "= ":
                    continue
                val = card[10:].split("/")[0].strip()
                if val.startswith("'"):
                    val = val[1:val.rindex("'")].strip()
                cards[key] = val
            if done:
                return cards

    with open(path, "rb") as f:
        hdr = read_header(f)                      # primary HDU
        naxis = int(hdr.get("NAXIS", "0"))
        size = abs(int(hdr.get("BITPIX", "8"))) // 8 if naxis else 0
        for ax in range(1, naxis + 1):
            size *= int(hdr[f"NAXIS{ax}"])
        f.seek(-(-size // 2880) * 2880, 1)
        for _ in range(hdu - 1):                  # skip intermediate HDUs
            h = read_header(f)
            n = int(h["NAXIS1"]) * int(h["NAXIS2"])
            f.seek(-(-n // 2880) * 2880, 1)
        hdr = read_header(f)
        if hdr.get("XTENSION") != "BINTABLE":
            raise ValueError(f"HDU {hdu} is not a BINTABLE")
        nrow = int(hdr["NAXIS2"])
        fields = []
        for i in range(1, int(hdr["TFIELDS"]) + 1):
            name = hdr.get(f"TTYPE{i}", f"col{i}")
            m = re.match(r"(\d*)([LBIJKED])$|(\d*)A$",
                         hdr[f"TFORM{i}"].strip())
            if m is None:
                raise ValueError(
                    f"unsupported TFORM {hdr[f'TFORM{i}']!r} ({name})")
            if m.group(3) is not None or m.group(0).endswith("A"):
                n = int(m.group(3) or m.group(1) or 1)
                fields.append((name, f"S{n}"))
            else:
                n = int(m.group(1)) if m.group(1) else 1
                dt = _FITS_DTYPES[m.group(2)]
                fields.append((name, dt) if n == 1 else (name, dt, (n,)))
        dtype = np.dtype(fields)
        if dtype.itemsize != int(hdr["NAXIS1"]):
            raise ValueError(f"row size {dtype.itemsize} of the parsed "
                             f"columns != NAXIS1 {hdr['NAXIS1']}")
        return np.frombuffer(f.read(dtype.itemsize * nrow),
                             dtype=dtype, count=nrow)


__all__ = ["load_models", "save_models", "load_offsets", "fetch",
           "fetch_isos", "fetch_tracks", "fetch_dustmaps", "fetch_grids",
           "fetch_offsets", "fetch_nns", "data_dir", "sha256sum",
           "ResultsWriter", "load_results", "read_fits_table",
           "RESULTS_DATASETS", "DRAW_DATASETS", "DATAVERSE_DOIS",
           "DEFAULT_LABELS"]
