"""The port's reference-semantics engine (`brutus_tpu_torch.ops.sed`,
`ops.optimize`) against the float64 oracle and `brutus_tpu`.

Float64 throughout unless a case says otherwise; the oracle cases are
those of `tests/test_optimize.py` at its own tolerances.  The batched
engine is held against `jax.vmap` of the JAX engine star by star, with
equal iteration counts.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from brutus_tpu.config import FitConfig as JFitConfig
from brutus_tpu.ops import optimize as JO
from brutus_tpu_torch.config import FitConfig
from brutus_tpu_torch.ops import optimize as TO
from brutus_tpu_torch.ops.fit import icov_from_parts
from brutus_tpu_torch.ops.sed import get_seds

from oracle import (make_synthetic_grid, make_synthetic_star,
                    oracle_get_seds, oracle_loglike, oracle_optimize_mag,
                    oracle_sed_mle)

T = torch.as_tensor


def test_get_seds_matches_oracle():
    """Magnitude and flux SEDs with their reddening vectors, rtol 1e-12."""
    rng = np.random.default_rng(42)
    mc = make_synthetic_grid(rng, nmodel=32, nfilt=6)
    av = rng.uniform(0, 2, 32)
    rv = rng.uniform(2, 5, 32)
    for flux in (False, True):
        want = oracle_get_seds(mc, av, rv, return_flux=flux)
        got = get_seds(T(mc), T(av), T(rv), return_flux=flux,
                       return_rvec=True, return_drvec=True)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-12)


def test_sed_mle_matches_oracle():
    """Models, reddening vectors, scale, precision and residuals at rtol
    5e-9, atol 1e-20 (`test_optimize.py`'s limits)."""
    rng = np.random.default_rng(43)
    nmodel, nfilt = 48, 8
    mc = make_synthetic_grid(rng, nmodel, nfilt)
    flux, err, _ = make_synthetic_star(rng, mc, idx=5)
    av = rng.uniform(0, 2, nmodel)
    rv = rng.uniform(2, 5, nmodel)
    want = oracle_sed_mle(flux, np.tile(err ** 2, (nmodel, 1)), mc, av, rv)
    got = list(TO.sed_mle(T(flux), T(1.0 / err ** 2), T(mc), T(av), T(rv),
                          FitConfig()))
    got[4] = icov_from_parts(got[4])
    for name, g, w in zip(("models", "rvecs", "drvecs", "scale", "icov",
                           "resid"), got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=5e-9, atol=1e-20,
                                   err_msg=name)


def test_optimize_mag_matches_oracle():
    """The alternating magnitude-space solves from the prior means, rtol
    1e-8 / atol 1e-10 (`test_optimize.py`'s limits)."""
    rng = np.random.default_rng(44)
    nmodel, nfilt = 40, 8
    mc = make_synthetic_grid(rng, nmodel, nfilt)
    flux, err, _ = make_synthetic_star(rng, mc, av=0.8, rv=3.4, idx=11)
    tot_var = np.tile(err ** 2, (nmodel, 1))
    mags = -2.5 * np.log10(flux)
    mags_var = (2.5 / np.log(10)) ** 2 * tot_var / flux ** 2
    cfg = FitConfig()
    av0 = np.full(nmodel, cfg.av0)
    rv0 = np.full(nmodel, cfg.rv0)
    av_o, rv_o = oracle_optimize_mag(flux, tot_var, av0, rv0, mc, mags,
                                     mags_var, tol=cfg.mtol)
    av, rv, _ = TO.optimize_mag(T(mags), T(1.0 / mags_var[0]), T(mc),
                                T(av0), T(rv0), cfg)
    np.testing.assert_allclose(av.numpy(), av_o, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(rv.numpy(), rv_o, rtol=1e-8, atol=1e-10)


LOGLIKE_CASES = {
    "no_cull": dict(cfg=dict(apply_init_cull=False, dim_prior=False)),
    "cull": dict(cfg=dict(dim_prior=False)),
    "dim_prior": dict(cfg=dict()),
    "masked_band": dict(cfg=dict(dim_prior=False), drop_band=2),
    "negative_flux_band": dict(cfg=dict(dim_prior=False), negative_band=6),
    # true distance 1 kpc -> parallax 1 mas (scale s = p^2)
    "parallax_clip": dict(cfg=dict(dim_prior=False), parallax=1.0,
                          parallax_err=0.1),
}


@pytest.mark.parametrize("case", sorted(LOGLIKE_CASES))
def test_loglike_grid_matches_oracle(case):
    """`loglike_grid` in float64 against the oracle's dynamic-subset
    reference semantics: chi2 rtol 1e-6 / atol 1e-8, lnlike and
    av, rv rtol = atol = 1e-6, scale rtol 1e-6, the precision rtol
    1e-5 / atol 1e-6 (`test_optimize.py::_compare_loglike`)."""
    c = LOGLIKE_CASES[case]
    cfg = FitConfig(**c["cfg"])
    rng = np.random.default_rng(45)
    mc = make_synthetic_grid(rng, 96, 8)
    flux, err, mask = make_synthetic_star(rng, mc, av=0.5, rv=3.2, idx=17)
    if "drop_band" in c:
        mask = mask.copy()
        mask[c["drop_band"]] = False
    if "negative_band" in c:
        flux = flux.copy()
        flux[c["negative_band"]] = -abs(flux[c["negative_band"]])
    plx, plxe = c.get("parallax", np.nan), c.get("parallax_err", np.nan)
    o_lnl, o_ndim, o_chi2, o_s, o_av, o_rv, o_icov = oracle_loglike(
        flux, err, mask, mc, dim_prior=cfg.dim_prior,
        init_thresh=cfg.init_thresh if cfg.apply_init_cull else None,
        parallax=plx, parallax_err=plxe)
    out = TO.loglike_grid(T(flux), T(err), T(mask), T(mc), parallax=plx,
                          parallax_err=plxe, cfg=cfg)
    assert int(out["ndim"]) == o_ndim
    np.testing.assert_allclose(out["chi2"].numpy(), o_chi2, rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(out["lnlike"].numpy(), o_lnl, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(out["scale"].numpy(), o_s, rtol=1e-6)
    np.testing.assert_allclose(out["av"].numpy(), o_av, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(out["rv"].numpy(), o_rv, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(icov_from_parts(out["icov_parts"]).numpy(),
                               o_icov, rtol=1e-5, atol=1e-6)


def test_loglike_float32_close():
    """The float32 path tracks the float64 oracle: the relative lnlike of
    the models within 10 nats of the best within 0.05 nats
    (`test_optimize.py::test_loglike_float32_close`)."""
    rng = np.random.default_rng(46)
    mc = make_synthetic_grid(rng, 64, 8)
    flux, err, mask = make_synthetic_star(rng, mc, idx=3)
    cfg = FitConfig(dim_prior=False)
    o_lnl, *_ = oracle_loglike(flux, err, mask, mc, dim_prior=False)
    f32 = torch.float32
    out = TO.loglike_grid(T(flux, dtype=f32), T(err, dtype=f32), T(mask),
                          T(mc, dtype=f32), cfg=cfg)
    assert out["lnlike"].dtype == f32
    got = out["lnlike"].double().numpy()
    sel = o_lnl > o_lnl.max() - 10
    np.testing.assert_allclose(got[sel] - got[sel].max(),
                               o_lnl[sel] - o_lnl[sel].max(), atol=0.05)


def _stars(rng, mc, n):
    """`n` noisy stars from random models, one band masked on the first,
    one without parallax."""
    F = mc.shape[1]
    idx = rng.integers(0, len(mc), n)
    sed = mc[idx, :, 0] + rng.uniform(0.1, 1.2, (n, 1)) * (
        mc[idx, :, 1] + rng.uniform(2.8, 3.8, (n, 1)) * mc[idx, :, 2])
    dist = rng.uniform(0.5, 2.0, n)
    flux = 10 ** (-0.4 * sed) / dist[:, None] ** 2
    err = flux / 40.0
    flux = flux + rng.normal(size=flux.shape) * err
    mask = np.ones((n, F), bool)
    mask[0, 1] = False
    plx, plxe = 1.0 / dist, 0.1 / dist
    plx[-1] = plxe[-1] = np.nan
    return flux, err, mask, plx, plxe


BATCHED = {
    "shared_grid": dict(mag_direct_init=False),
    "direct_init": dict(mag_direct_init=True),
    "polish_k": dict(polish_k=40),
    "tight_ltol": dict(ltol=1e-3, ltol_subthresh=1e-3),
}


@pytest.mark.parametrize("case", sorted(BATCHED))
def test_batched_loglike_matches_vmapped_jax(case):
    """Four stars at once against `jax.vmap(brutus_tpu.ops.optimize.
    loglike_grid)` in float64: every star takes the same number of
    magnitude and flux iterations, and every field agrees to rtol 1e-9
    / atol 1e-9 (only the order of float64 sums differs).  `polish_k`
    polishes the best 40 of 120 models (the JAX package's
    `approx_max_k` is exact on the CPU, as the port's `topk`)."""
    rng = np.random.default_rng(47)
    mc = make_synthetic_grid(rng, 120, 8)
    flux, err, mask, plx, plxe = _stars(rng, mc, 4)
    cfg = BATCHED[case]
    jcfg, tcfg = JFitConfig(**cfg), FitConfig(**cfg)
    ref = jax.vmap(lambda f, e, m, p, pe: JO.loglike_grid(
        f, e, m, jnp.asarray(mc), parallax=p, parallax_err=pe, cfg=jcfg))(
        jnp.asarray(flux), jnp.asarray(err), jnp.asarray(mask),
        jnp.asarray(plx), jnp.asarray(plxe))
    got = TO.loglike_grid(T(flux), T(err), T(mask), T(mc), parallax=T(plx),
                          parallax_err=T(plxe), cfg=tcfg)
    np.testing.assert_array_equal(got["n_iter"].numpy(),
                                  np.asarray(ref["n_iter"]))
    assert (got["n_iter"].numpy() > 1).all()
    np.testing.assert_array_equal(got["ndim"].numpy(),
                                  np.asarray(ref["ndim"]))
    for k in ("lnlike", "chi2", "scale", "av", "rv"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-9, atol=1e-9, err_msg=k)
    for g, r in zip(got["icov_parts"], ref["icov_parts"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-9,
                                   atol=1e-9)


def test_per_star_shortlists_match_shared_grid():
    """Per-star `(B, M, F, 3)` coefficients that repeat one grid give
    the shared grid's iteration counts and values within rtol 1e-12
    (the two contractions sum in other orders), and seeds given per model
    (`av_init`/`rv_init`, reference fitting.py:583-585) reach the
    same optimum as the prior-mean start within 0.02 in Av, 0.05 in Rv
    and 0.1 nats at the best model (`test_optimize.py::
    test_per_model_init_arrays`)."""
    rng = np.random.default_rng(48)
    mc = make_synthetic_grid(rng, 64, 8)
    flux, err, mask, plx, plxe = _stars(rng, mc, 3)
    cfg = FitConfig()
    args = (T(flux), T(err), T(mask))
    kw = dict(parallax=T(plx), parallax_err=T(plxe), cfg=cfg)
    shared = TO.loglike_grid(*args, T(mc), **kw)
    per = TO.loglike_grid(*args, T(mc)[None].expand(3, 64, 8, 3), **kw)
    assert torch.equal(shared["n_iter"], per["n_iter"])
    for k in ("lnlike", "chi2", "av", "rv"):
        np.testing.assert_allclose(per[k].numpy(), shared[k].numpy(),
                                   rtol=1e-12, err_msg=k)
    warm = TO.loglike_grid(*args, T(mc), av_init=shared["av"],
                           rv_init=shared["rv"], **kw)
    w = shared["lnlike"].argmax(1)
    r = torch.arange(3)
    assert (warm["av"][r, w] - shared["av"][r, w]).abs().max() < 2e-2
    assert (warm["rv"][r, w] - shared["rv"][r, w]).abs().max() < 5e-2
    assert (warm["lnlike"][r, w] - shared["lnlike"][r, w]).abs().max() < 0.1


def test_optimize_flux_step_matches_jax():
    """One damped flux-space update from `sed_mle`'s state, with steps
    of mixed size and some models pushed against the bounds, equals the
    JAX package's `optimize_flux_step` at rtol 1e-12 (float64)."""
    rng = np.random.default_rng(49)
    mc = make_synthetic_grid(rng, 32, 8)
    flux, err, _ = make_synthetic_star(rng, mc, idx=4)
    av = rng.uniform(0, 2, 32)
    rv = rng.uniform(2, 5, 32)
    av[:4] = 19.99
    rv[4:8] = 1.0
    step = rng.uniform(0.2, 1.0, 32)
    wt = 1.0 / err ** 2
    cfg, jcfg = FitConfig(), JFitConfig()
    m, rvec, drvec, _, _, resid = TO.sed_mle(T(flux), T(wt), T(mc), T(av),
                                             T(rv), cfg)
    got = TO.optimize_flux_step(T(wt)[None], m[None], rvec[None],
                                drvec[None], resid[None], T(av)[None],
                                T(rv)[None], T(step)[None], cfg)
    want = JO.optimize_flux_step(jnp.asarray(wt), jnp.asarray(m.numpy()),
                                 jnp.asarray(rvec.numpy()),
                                 jnp.asarray(drvec.numpy()),
                                 jnp.asarray(resid.numpy()), jnp.asarray(av),
                                 jnp.asarray(rv), jnp.asarray(step), jcfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), rtol=1e-12)
