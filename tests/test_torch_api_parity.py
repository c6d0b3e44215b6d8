"""Public names and keywords of the JAX package that the port's mirrors
carry: `priors.gal_lnprior(return_components=)`, `healpix.lb2pix(
use_native=)`, the functional API `fitting.loglike` / `fitting.lnpost`
and the lazy re-exports of `brutus_tpu_torch.ops`, each against
`brutus_tpu` on the same inputs (float64 where the JAX side runs in
float64, conftest turning x64 on).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from brutus_tpu.config import FitConfig as JFitConfig
from brutus_tpu.config import PosteriorConfig as JPosteriorConfig
from brutus_tpu import fitting as JF
from brutus_tpu import healpix as JH
from brutus_tpu import priors as JP
from brutus_tpu_torch import fitting as TF
from brutus_tpu_torch import healpix as TH
from brutus_tpu_torch import priors as TP
from brutus_tpu_torch.config import FitConfig, PosteriorConfig

from oracle import make_synthetic_grid

COORD = np.array([204.7, -19.2])
T = torch.as_tensor


@pytest.mark.parametrize("labels", ["none", "feh", "loga", "both"])
def test_gal_lnprior_components_match_jax(labels):
    """`gal_lnprior(..., return_components=True)` at distances
    `linspace(0.1, 5, 5)` kpc in float64 at `(l, b) = (204.7, -19.2)`:
    the total and each component (the thin, thick and halo number
    densities, and the `feh` and `age` mixtures when their labels are
    given) within relative 1e-10 of the JAX package's, the same keys,
    and the total equal to the call without components."""
    d = np.linspace(0.1, 5.0, 5)
    rng = np.random.default_rng(3)
    feh = rng.uniform(-2.0, 0.3, 5) if labels in ("feh", "both") else None
    loga = rng.uniform(8.0, 10.1, 5) if labels in ("loga", "both") else None
    opt = lambda x, f: None if x is None else f(x)
    jl, jc = JP.gal_lnprior(jnp.asarray(d), jnp.asarray(COORD),
                            feh=opt(feh, jnp.asarray),
                            loga=opt(loga, jnp.asarray),
                            return_components=True)
    tl, tc = TP.gal_lnprior(T(d), T(COORD), feh=opt(feh, T),
                            loga=opt(loga, T), return_components=True)
    assert set(tc) == set(jc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-10)
    for k in jc:
        want = (jc[k] if k != "number_density" else jnp.stack(jc[k]))
        got = tc[k] if k != "number_density" else torch.stack(tc[k])
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-10, err_msg=k)
    plain = TP.gal_lnprior(T(d), T(COORD), feh=opt(feh, T),
                           loga=opt(loga, T))
    np.testing.assert_array_equal(plain.numpy(), tl.numpy())


@pytest.mark.parametrize("use_native", [True, False])
def test_lb2pix_use_native_matches_jax(use_native):
    """`lb2pix(64, [204.7], [-19.2], use_native=...)` takes the keyword
    and gives the JAX package's pixel, 44713, for both values."""
    got = TH.lb2pix(64, [204.7], [-19.2], use_native=use_native)
    want = JH.lb2pix(64, [204.7], [-19.2], use_native=use_native)
    np.testing.assert_array_equal(got, want)
    assert int(got[0]) == 44713


def test_ops_reexports():
    """`brutus_tpu_torch.ops` re-exports the names `brutus_tpu.ops`
    does, as the functions of `ops.sed` and `ops.optimize`."""
    from brutus_tpu import ops as jops
    from brutus_tpu_torch import ops
    from brutus_tpu_torch.ops import optimize, sed
    names = ("get_seds", "get_seds_mag", "get_seds_flux", "optimize_mag",
             "optimize_flux_step", "sed_mle", "loglike_grid")
    for n in names:
        assert hasattr(jops, n)
        mod = sed if n.startswith("get_seds") else optimize
        assert getattr(ops, n) is getattr(mod, n)
    assert TF.loglike is optimize.loglike_grid


def _star(seed=5):
    rng = np.random.default_rng(seed)
    mc = make_synthetic_grid(rng, 300, 8)
    idx = 37
    sed = mc[idx, :, 0] + 0.6 * (mc[idx, :, 1] + 3.2 * mc[idx, :, 2])
    flux = 10 ** (-0.4 * sed) / 1.3 ** 2
    err = flux / 50.0
    flux = flux + rng.normal(size=8) * err
    lab = dict(lnprior=rng.uniform(-1.0, 0.0, 300),
               feh=rng.uniform(-2.0, 0.3, 300),
               loga=rng.uniform(8.0, 10.1, 300))
    return mc, flux, err, np.ones(8, bool), 1 / 1.3, 0.1 / 1.3, lab


def test_loglike_matches_jax():
    """`fitting.loglike` (the port's `ops.optimize.loglike_grid`) on one
    star against `brutus_tpu.fitting.loglike` in float64, at
    `tests/test_torch_optimize.py`'s limits against the JAX package:
    the same iteration counts and band count, every field and precision
    part within rtol = atol = 1e-9."""
    mc, flux, err, mask, plx, plxe, _ = _star()
    cfg = dict(mag_direct_init=True)
    ref = JF.loglike(jnp.asarray(flux), jnp.asarray(err), jnp.asarray(mask),
                     jnp.asarray(mc), parallax=plx, parallax_err=plxe,
                     cfg=JFitConfig(**cfg))
    got = TF.loglike(T(flux), T(err), T(mask), T(mc), parallax=plx,
                     parallax_err=plxe, cfg=FitConfig(**cfg))
    np.testing.assert_array_equal(got["n_iter"].numpy(),
                                  np.asarray(ref["n_iter"]))
    assert int(got["ndim"]) == int(ref["ndim"])
    for k in ("lnlike", "chi2", "scale", "av", "rv"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-9, atol=1e-9, err_msg=k)
    for g, r in zip(got["icov_parts"], ref["icov_parts"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-9,
                                   atol=1e-9)


def test_lnpost_matches_jax():
    """`fitting.lnpost` on one star's `loglike` against `brutus_tpu.
    fitting.lnpost` with every built-in prior (Galactic with its feh and
    age mixtures, a dust profile, parallax): the selection does not
    depend on the random numbers, so the band count and `chi2min` agree
    on one seed (rtol 1e-6: the port's posterior runs in float32); the
    rest is held at the distributional limits of `tests/
    test_torch_lnpost_grid.py::
    test_fit_custom_priors_match` over six seeds each side (the port
    draws from Philox streams, the JAX package from its keys): the
    median of the pooled distance draws within 2%, and the mean
    log-evidences within 0.1 nats or 4 standard errors of their
    difference."""
    mc, flux, err, mask, plx, plxe, lab = _star()
    ladder = np.linspace(0.05, 10.0, 120)
    prof_mean = np.linspace(0.0, 1.5, 120)
    prof_std = np.full(120, 0.2)
    cfg = dict(n_mc_prior=20, n_draws=128, n_sel_max=128)
    jres = JF.loglike(jnp.asarray(flux), jnp.asarray(err), jnp.asarray(mask),
                      jnp.asarray(mc), parallax=plx, parallax_err=plxe,
                      cfg=JFitConfig(mag_direct_init=True))
    tres = TF.loglike(T(flux), T(err), T(mask), T(mc), parallax=plx,
                      parallax_err=plxe, cfg=FitConfig(mag_direct_init=True))
    refs = [JF.lnpost(jax.random.PRNGKey(s), jres, jnp.asarray(
        lab["lnprior"]), jnp.asarray(COORD), parallax=plx,
        parallax_err=plxe, feh=jnp.asarray(lab["feh"]),
        loga=jnp.asarray(lab["loga"]), dust_profile=(
            jnp.asarray(ladder), jnp.asarray(prof_mean),
            jnp.asarray(prof_std)), cfg=JPosteriorConfig(**cfg))
        for s in range(6)]
    outs = [TF.lnpost(s, tres, T(lab["lnprior"]), COORD, parallax=plx,
                      parallax_err=plxe, feh=T(lab["feh"]),
                      loga=T(lab["loga"]), dust_profile=(
                          ladder, prof_mean, prof_std),
                      cfg=PosteriorConfig(**cfg)) for s in range(6)]
    o, r = outs[0], refs[0]
    assert o["dist"].shape == (128,) and o["model_idx"].shape == (128,)
    assert int(o["ndim"]) == int(r["ndim"])
    np.testing.assert_allclose(float(o["chi2min"]), float(r["chi2min"]),
                               rtol=1e-6)
    for out in outs:
        assert all(torch.isfinite(v).all() for v in out.values()
                   if v.is_floating_point())
    med = np.median(np.concatenate([x["dist"].numpy() for x in outs]))
    med_j = np.median(np.concatenate([np.asarray(x["dist"]) for x in refs]))
    assert abs(med / med_j - 1) < 0.02, (med, med_j)
    lev = np.array([float(x["log_evidence"]) for x in outs])
    lev_j = np.array([float(x["log_evidence"]) for x in refs])
    se = np.sqrt((lev.var(ddof=1) + lev_j.var(ddof=1)) / len(lev))
    diff = abs(lev.mean() - lev_j.mean())
    assert diff < max(0.1, 4 * se), (diff, se)
