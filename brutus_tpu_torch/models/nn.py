"""
Bolometric-correction neural networks (mirrors `brutus_tpu/models/nn.py`).

Parity: reference `brutus/seds.py:860-1078` (`FastNN`,
`FastNNPredictor`): one 3-layer MLP per band (sigmoid, sigmoid, linear)
over the min-max-encoded inputs `[Teff, logg, feh_surf, afe, av, rv]`.
The bands' weights are stacked, `(F, h1, 6)`, `(F, h1)`, `(F, h2, h1)`,
`(F, h2)`, `(F, 1, h2)`, `(F,)`, the JAX package's layout, and every
evaluation is batched over arbitrary leading axes as three contractions.
The contractions run at full precision (no TF32), as the JAX package
asks `Precision.HIGHEST`.

h5py is imported only inside the file reader and writer.
"""

import numpy as np
import torch

from ..ops.optimize import highest_precision
from ..utils import resolve_device

NN_FIELDS = ("w1", "b1", "w2", "b2", "w3", "b3", "xmin", "xmax")


def nneval_params(params, x):
    """The stacked per-band MLPs at `x (..., 6)` for the weights
    `params = (w1, b1, w2, b2, w3, b3, xmin, xmax)` (mirrors
    `brutus_tpu.models.nn.nneval_params`).  NaN where any input lies
    outside the trained range or is not finite."""
    w1, b1, w2, b2, w3, b3, xmin, xmax = params
    xe = (x - xmin) / (xmax - xmin)
    with highest_precision():
        a1 = torch.sigmoid(torch.einsum("fho,...o->...fh", w1, xe) + b1)
        a2 = torch.sigmoid(torch.einsum("fgh,...fh->...fg", w2, a1) + b2)
        y = torch.einsum("fog,...fg->...fo", w3, a2)[..., 0] + b3
    ok = torch.all(torch.isfinite(x) & (x >= xmin) & (x <= xmax), dim=-1)
    return torch.where(ok[..., None], y, torch.full_like(y, torch.nan))


def sed_params(params, logt, logg, feh_surf, afe, logl, av, rv, dist):
    """Apparent magnitudes `m = -2.5 log L + 4.74 - BC + mu(dist)`
    (mirrors `brutus_tpu.models.nn.sed_params`; reference
    `brutus/seds.py:1072-1073`); every argument broadcasts."""
    ref = params[0]
    t = lambda a: torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
    logt, logg, feh_surf, afe, av, rv, logl, dist = torch.broadcast_tensors(
        *[t(a) for a in (logt, logg, feh_surf, afe, av, rv, logl, dist)])
    mu = 5.0 * torch.log10(dist) - 5.0
    x = torch.stack([10.0 ** logt, logg, feh_surf, afe, av, rv], dim=-1)
    bc = nneval_params(params, x)
    return (-2.5 * logl + 4.74)[..., None] - bc + mu[..., None]


def read_nn_file(nnfile, filters):
    """The stacked weight arrays `w1, b1, w2, b2, w3, b3, xmin, xmax` of
    the bands `filters` in an `nn_c3k.h5`-schema file (reference
    `brutus/seds.py:895-917`), as the file stores them."""
    import h5py
    with h5py.File(nnfile, "r") as f:
        return tuple(np.array([f[flt][k] for flt in filters])
                     for k in NN_FIELDS)


class FastNN:
    """Stacked per-band MLPs over encoded stellar / extinction inputs
    (mirrors `brutus_tpu.models.nn.FastNN`).

    Built from a file (`nnfile`) or from the weight arrays of the file's
    layout (`arrays`, as `read_nn_file` returns them; the JAX object's
    `params` through `convert.nn_from_numpy`).  The weights live on
    `device` (CUDA unless the caller names another) in float64.
    """

    def __init__(self, filters=None, nnfile=None, verbose=True, device=None,
                 arrays=None):
        from ..filters import FILTERS
        self.filters = list(FILTERS if filters is None else filters)
        self.device = resolve_device(device)
        if arrays is None:
            arrays = read_nn_file(nnfile or "data/DATAFILES/nn_c3k.h5",
                                  self.filters)
        w1, b1, w2, b2, w3, b3, xmin, xmax = (np.array(a, float)
                                              for a in arrays)
        if xmin.ndim == 2:
            if not (np.all(xmin == xmin[0]) and np.all(xmax == xmax[0])):
                raise ValueError("neural networks disagree on input ranges")
            xmin, xmax = xmin[0], xmax[0]
        t = lambda a: torch.as_tensor(a, dtype=torch.float64,
                                      device=self.device)
        self.xmin, self.xmax = t(xmin), t(xmax)
        self.xspan = self.xmax - self.xmin
        # (F, h1, 6), (F, h1), (F, h2, h1), (F, h2), (F, 1, h2), (F,)
        self.w1, self.w2, self.w3 = t(w1), t(w2), t(w3)
        self.b1 = t(b1[..., 0] if b1.ndim == 3 else b1)
        self.b2 = t(b2[..., 0] if b2.ndim == 3 else b2)
        self.b3 = t(b3.reshape(len(b3), -1)[:, 0])
        self.NFILT = len(self.filters)

    @property
    def params(self):
        """The weights `(w1, b1, w2, b2, w3, b3, xmin, xmax)` of
        `nneval_params` / `sed_params`."""
        return (self.w1, self.b1, self.w2, self.b2, self.w3, self.b3,
                self.xmin, self.xmax)

    def encode(self, x):
        """Min-max rescaled inputs (reference `brutus/seds.py:919-940`)."""
        return (x - self.xmin) / self.xspan

    def nneval(self, x):
        """Bolometric corrections `(..., NFILT)` at `x (..., 6)`; NaN out
        of the trained range (reference `brutus/seds.py:1067-1076`)."""
        x = torch.as_tensor(x, dtype=self.w1.dtype, device=self.device)
        return nneval_params(self.params, x)


class FastNNPredictor(FastNN):
    """SEDs from stellar parameters through the BC networks (mirrors
    `brutus_tpu.models.nn.FastNNPredictor`; reference
    `brutus/seds.py:978-1078`)."""

    def sed(self, logt=3.8, logg=4.4, feh_surf=0.0, logl=0.0, afe=0.0,
            av=0.0, rv=3.3, dist=1000.0, filt_idxs=slice(None)):
        """Apparent magnitudes `(..., NFILT)`; every argument broadcasts;
        NaN out of bounds."""
        m = sed_params(self.params, logt, logg, feh_surf, afe, logl, av,
                       rv, dist)
        return m[..., filt_idxs]


def write_nn_file(path, filters, w1, b1, w2, b2, w3, b3, xmin, xmax):
    """Write an `nn_c3k.h5`-schema network file (mirrors
    `brutus_tpu.models.nn.write_nn_file`)."""
    import h5py
    with h5py.File(path, "w") as f:
        for i, flt in enumerate(filters):
            g = f.create_group(flt)
            for k, v in zip(NN_FIELDS[:6], (w1, b1, w2, b2, w3, b3)):
                g.create_dataset(k, data=v[i])
            g.create_dataset("xmin", data=xmin)
            g.create_dataset("xmax", data=xmax)


__all__ = ["FastNN", "FastNNPredictor", "write_nn_file", "read_nn_file",
           "nneval_params", "sed_params"]
