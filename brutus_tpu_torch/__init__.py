"""
brutus_tpu_torch — the PyTorch + CUDA port of `brutus_tpu`, for one
NVIDIA H100.

Brute-force Bayesian inference of stellar distances, reddenings and
properties from photometry against a precomputed model grid.  This
package is written in PyTorch; every kernel the JAX package writes in
Pallas for the TPU is a CUDA C++ kernel here (`csrc/`), built with nvcc
at first use and loaded with ctypes, each beside a plain PyTorch version
of the same function that the CPU path runs.

It imports torch, numpy and scipy only (h5py where a file is read or
written) and nothing from `brutus_tpu`.  Entry points run on CUDA unless
the caller passes `device="cpu"`.

Ported so far: `BruteForce.fit` on one device, with all four engines:
the funnel (screen -> block top-k -> slab gather -> shortlist fit ->
select stage -> MC integration -> resampling), the dense engine (fit of
every grid model -> `lnpost_grid`), and the reference-semantics funnel
and dense engine (`engine="xla"`: the reference's convergence loops,
`ops/optimize.py`, `ops/screen_xla.py`); custom prior callables,
`lnprior_ext`, `scan_batches`, `resume`, `return_sel`, the `_fit`
generator; the foundations (`utils`, `priors`, `dustmap`, `io`); grid
generation (`ops/interp.py`, `models`: the BC networks, the MIST track
and isochrone interpolators, `SEDmaker.make_grid`); the samplers
(`sampling`) and the cluster fit (`cluster.isochrone_loglike`,
`fit_cluster`); the applications after a fit: line-of-sight clouds
(`los`), photometric offsets (`offsets`), binned distance-reddening
PDFs (`pdf`), the plots (`plotting`, matplotlib imported only to draw)
and the instrumentation (`profiling`).  Still to come (ROADMAP.md): the
device mesh, `fit(mesh=...)`.
"""

__version__ = "0.1.0"

from .config import (FitConfig, PosteriorConfig, GalPriorConfig,  # noqa
                     DustPriorConfig)
from .convert import from_numpy_grid  # noqa: F401
from .dustmap import DustMap, Bayestar, uniform_profile  # noqa: F401
from .fitting import BruteForce  # noqa: F401
from .filters import FILTERS  # noqa: F401


def __getattr__(name):
    """Lazy submodule access, as `brutus_tpu`'s (keeps `import
    brutus_tpu_torch` light)."""
    import importlib
    submodules = {"config", "utils", "io", "coords", "healpix", "dustmap",
                  "priors", "fitting", "models", "ops", "los", "cluster",
                  "offsets", "pdf", "plotting", "profiling", "sampling",
                  "convert"}
    if name in submodules:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
