"""The port's dense fit engine against `brutus_tpu`: `ops.fit` (K1 in
dense mode, its plain version on the CPU) against
`pallas_loglike.loglike_grid_fused` in Pallas interpret mode, and
`BruteForce.fit(screen_k=0)` against the JAX package's dense fused fit
and the float64 oracle.

Inputs come from a numpy seed; the JAX side gets explicit float32
arrays (conftest turns x64 on).  The CUDA kernel against this plain
version: `tests/test_torch_kernels_gpu.py`.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from brutus_tpu.config import FitConfig
from brutus_tpu.fitting import BruteForce as JBruteForce
from brutus_tpu.ops import pallas_loglike as PL
from brutus_tpu_torch import BruteForce
from brutus_tpu_torch.config import FitConfig as TFitConfig
from brutus_tpu_torch.ops import fit as TFD
from test_torch_fit import problem  # noqa: F401  (module fixture)
from test_torch_funnel import _problem

FIELDS = ("lnlike", "chi2", "scale", "av", "rv")


@pytest.mark.parametrize("M, tile", [(2000, 128), (1024, 512)])
def test_prepare_coeffs_matches(M, tile):
    """The `(3, F, Mp)` layout and its +60 mag padding, bit for bit."""
    mc = _problem(M, 8, 2, 3)["mc"]
    ref, n_ref = PL.prepare_coeffs(mc, tile=tile)
    out, n = TFD.prepare_coeffs(mc, tile=tile)
    assert n == n_ref == M
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _fields(res):
    return [np.asarray(res[k]) for k in FIELDS] + [
        np.asarray(x) for x in res["icov_parts"]]


@pytest.mark.parametrize("dim_prior", [True, False])
def test_dense_fit_matches(dim_prior):
    """K1's dense plain version against `loglike_grid_fused` in
    interpret mode: 2000 models padded to 2048 (tile 128), 12 stars
    (not a multiple of the TPU kernel's 8-star group), one star with
    half its bands masked and one with a single masked band.  On real
    models, the stacked mode's tolerances
    (`test_torch_funnel._assert_pack_close`):
    lnlike within 0.02 nats (plus 1e-5 relative) within 20 nats of each
    star's best, every field within 1e-3 relative (floored at 1e-3 of
    the field's scale) for all but 0.5% of models (the fixed-budget
    iterations branch on float comparisons that a last-bit difference
    can flip for a poorly fitting model), and the same best model; the
    padding models masked to the same values."""
    p = _problem(2000, 8, 12, 5, masked=True)
    cfg = FitConfig(dim_prior=dim_prior)
    ct, n_real = PL.prepare_coeffs(p["mc"], tile=128)
    ref = PL.loglike_grid_fused(jnp.asarray(p["flux"]),
                                jnp.asarray(p["err"]),
                                jnp.asarray(p["mask"]), ct, cfg=cfg,
                                tile=128, interpret=True, n_real=n_real)
    tct, _ = TFD.prepare_coeffs(p["mc"], tile=128)
    out = TFD.loglike_grid_fused(
        torch.as_tensor(p["flux"]), torch.as_tensor(p["err"]),
        torch.as_tensor(p["mask"]), tct,
        cfg=TFitConfig(dim_prior=dim_prior), tile=128, n_real=n_real)
    np.testing.assert_array_equal(out["ndim"].numpy(),
                                  np.asarray(ref["ndim"]))
    outs = _fields(out)
    refs = _fields(ref)
    for a, b in zip(outs[:2], refs[:2]):          # lnlike, chi2 padding
        np.testing.assert_array_equal(a[:, n_real:], b[:, n_real:])
    names = FIELDS + ("i00", "i11", "i22", "i01", "i02", "i12")
    for n, a, b in zip(names, outs, refs):
        a, b = a[:, :n_real], b[:, :n_real]
        ok = b > -1e29 if n == "lnlike" else np.isfinite(b)
        floor = 1e-3 * np.abs(b[ok]).max()
        rel = np.abs(a[ok] - b[ok]) / np.maximum(np.abs(b[ok]), floor)
        assert (rel > 1e-3).mean() < 5e-3, (n, (rel > 1e-3).mean())
    lnl, lnl_ref = outs[0][:, :n_real], refs[0][:, :n_real]
    near = lnl_ref > lnl_ref.max(1, keepdims=True) - 20.0
    np.testing.assert_allclose(lnl[near], lnl_ref[near], rtol=1e-5,
                               atol=0.02)
    np.testing.assert_array_equal(lnl.argmax(1), lnl_ref.argmax(1))
    np.testing.assert_array_equal(lnl.argmax(1)[2:], p["idx"][2:])


def test_fit_dense_matches_jax_and_oracle(problem):  # noqa: F811
    """`BruteForce.fit(screen_k=0)` against the JAX package's dense
    fused fit and the float64 oracle on `test_torch_fit.py`'s problem:
    posterior medians within 2% and log-evidences within 0.1 nats (the
    sum of two single-run MC envelopes of ~1% and ~0.05 nats), the
    same band counts and chi2 minima (1e-3, float32)."""
    p = problem
    kw = dict(p["kw"], screen_k=0)
    ref = JBruteForce(p["mc"], p["labels"]).fit(
        p["flux"], p["errs"], p["mask"], save_file=None,
        return_results=True, **kw)
    out = BruteForce(p["mc"], p["labels"], device="cpu").fit(
        p["flux"], p["errs"], p["mask"], return_results=True, **kw)
    for k, v in out.items():
        if v.dtype.kind == "f":
            assert np.isfinite(v).all(), k
    np.testing.assert_array_equal(out["ndim"], np.asarray(ref["ndim"]))
    np.testing.assert_allclose(out["chi2min"], np.asarray(ref["chi2min"]),
                               rtol=1e-3)
    med = np.median(out["dist"], 1)
    med_j = np.median(np.asarray(ref["dist"]), 1)
    lev = out["log_evidence"]
    assert np.max(np.abs(med / med_j - 1)) < 0.02
    assert np.max(np.abs(lev - np.asarray(ref["log_evidence"]))) < 0.1
    assert np.max(np.abs(med / p["med_o"] - 1)) < 0.02
    assert np.max(np.abs(lev - p["lev_o"])) < 0.1
