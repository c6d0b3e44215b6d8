"""
Results file of the PyTorch port: the reference's 13-dataset HDF5
schema (reference `brutus/fitting.py:1632-1662`), written batch by batch.

The port's own copy of `brutus_tpu.io.ResultsWriter`, with the same
dataset names, shapes, types and fill values, so files from both
packages compare dataset by dataset.  h5py is imported only when a file
is opened: a fit with `save_file=None` never needs it.
"""

import numpy as np

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
    """Incremental writer of the results schema.  `model_idx` rows start
    at -99, the reference's unfitted-row marker (fitting.py:1635)."""

    def __init__(self, path, n_data, n_draws, labels=None,
                 save_dar_draws=True):
        import h5py
        self.path = path if path.endswith(".h5") else f"{path}.h5"
        self.n_data = n_data
        self.n_draws = n_draws
        self.save_dar_draws = save_dar_draws
        self.file = h5py.File(self.path, "w-")
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


__all__ = ["ResultsWriter", "load_results", "RESULTS_DATASETS",
           "DRAW_DATASETS"]
