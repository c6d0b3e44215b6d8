"""The port's per-star posterior `lnpost_grid` (the dense engine's
posterior, and the posterior of both engines with custom prior
callables) against `brutus_tpu.ops.posterior.lnpost_grid`, vmapped over
the stars as the JAX package's dense engine runs it, on the same fit
results and the same random numbers (the JAX draws of
`split(key, 3)`: normals, inverse-CDF uniforms, Gumbel noise).

The fit results are the JAX package's dense fused fit in Pallas
interpret mode; inputs come from a numpy seed and reach the JAX side as
float32 arrays (conftest turns x64 on).
"""

from functools import partial

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from brutus_tpu.config import FitConfig, PosteriorConfig
from brutus_tpu.ops import pallas_loglike as PL
from brutus_tpu.ops.posterior import lnpost_grid as j_lnpost_grid
from brutus_tpu_torch import config as TC
from brutus_tpu_torch.ops import posterior as TP
from test_torch_funnel import _problem

B = 6
COORD = np.array([204.7, -19.2], np.float32)
LADDER = np.linspace(0.05, 10.0, 120, dtype=np.float32)


def j_lngal(dist, coord, feh=None, loga=None):
    """Toy Galactic prior: exponential in distance, with a metallicity
    term where labels are given."""
    lp = -dist / 0.7 + 2.0 * jnp.log(jnp.maximum(dist, 1e-10))
    return lp if feh is None else lp - 0.5 * ((feh + 0.5) / 0.4) ** 2


def t_lngal(dist, coord, feh=None, loga=None):
    lp = -dist / 0.7 + 2.0 * torch.log(torch.clamp(dist, min=1e-10))
    return lp if feh is None else lp - 0.5 * ((feh + 0.5) / 0.4) ** 2


def j_lndust(dist, av, av_dist, av_mean, av_std):
    mu = jnp.interp(dist, av_dist, av_mean)
    return -0.5 * ((av - mu) / 0.3) ** 2


def t_lndust(dist, av, av_dist, av_mean, av_std):
    """The same toy dust prior, with the linear interpolation on the
    uniform ladder written out (clamped at its ends, as `jnp.interp`)."""
    n = av_dist.shape[0]
    u = torch.clamp((dist - av_dist[0]) / (av_dist[1] - av_dist[0]), 0.0,
                    n - 1.0)
    lo = torch.clamp(torch.floor(u), max=n - 2).long()
    w = u - lo.to(u.dtype)
    mu = av_mean[lo] * (1.0 - w) + av_mean[lo + 1] * w
    return -0.5 * ((av - mu) / 0.3) ** 2


VARIANTS = {
    # all priors, prefilter on its bf16 key (the fit's defaults)
    "full": dict(cfg=dict(n_mc_prior=20, n_draws=64, n_sel_max=256,
                          prefilter_k=256), dust=True, plx=True,
                 labels=True),
    # no dust / labels / parallax, odd Nmc
    "minimal": dict(cfg=dict(n_mc_prior=13, n_draws=32, n_sel_max=128,
                             prefilter_k=128), dust=False, plx=False,
                    labels=False),
    # no prefilter: the culls over every model, then an exact top-K
    "no_prefilter": dict(cfg=dict(n_mc_prior=16, n_draws=48, n_sel_max=200,
                                  prefilter_k=0), dust=True, plx=True,
                         labels=True),
    # CDF culls instead of relative-weight culls (wt_thresh=None)
    "cdf_cull": dict(cfg=dict(n_mc_prior=16, n_draws=32, n_sel_max=256,
                              prefilter_k=256, wt_thresh=None),
                     dust=True, plx=True, labels=True),
    # custom Galactic and dust prior callables
    "callables": dict(cfg=dict(n_mc_prior=16, n_draws=48, n_sel_max=256,
                               prefilter_k=256), dust=True, plx=True,
                      labels=True, callables=True),
    # callables on per-star rows with a grid-index map, as the funnel
    # hands its shortlists to `lnpost_grid`
    "per_star_rows": dict(cfg=dict(n_mc_prior=16, n_draws=48, n_sel_max=256,
                                   prefilter_k=256), dust=True, plx=True,
                          labels=True, callables=True, per_star=True),
}


@pytest.fixture(scope="module")
def dense():
    """The JAX dense fused fit of 6 stars against a 2000-model grid
    (padded to 2048), and the padded grid rows, as `brutus_tpu.
    BruteForce.fit` pads them."""
    p = _problem(2000, 8, B, 9, masked=True)
    ct, n_real = PL.prepare_coeffs(p["mc"], tile=128)
    res = PL.loglike_grid_fused(jnp.asarray(p["flux"]),
                                jnp.asarray(p["err"]),
                                jnp.asarray(p["mask"]), ct, cfg=FitConfig(),
                                tile=128, interpret=True, n_real=n_real)
    pad = ct.shape[2] - n_real
    padded = lambda a, v: np.concatenate(
        [np.asarray(a, np.float32), np.full(pad, v, np.float32)])
    rows = dict(lnprior=padded(p["lnprior"], -1e30),
                feh=padded(p["lab"]["feh"], 0.0),
                loga=padded(p["lab"]["loga"], 9.0))
    return p, res, rows


def _jax_noise(keys, K, pcfg):
    nmc = pcfg.n_mc_prior
    zs, us, gs = [], [], []
    for key in keys:
        kmvn, kidx, kmc = jax.random.split(key, 3)
        zs.append(np.asarray(jax.random.normal(kmvn, (K, 3, nmc),
                                               jnp.float32)))
        us.append(np.asarray(jax.random.uniform(kidx, (pcfg.n_draws,),
                                                jnp.float32)))
        gs.append(np.asarray(jax.random.gumbel(
            kmc, (pcfg.n_draws, nmc), jnp.float32)))
    return TP.Noise(*(torch.as_tensor(np.stack(x)) for x in (zs, us, gs)))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_lnpost_grid_matches(dense, variant):
    """Same fit results, same random numbers: identical model draws,
    every float output within 1e-4 (relative and absolute, float32
    association)."""
    p, res, rows = dense
    v = VARIANTS[variant]
    pcfg = PosteriorConfig(**v["cfg"])
    M = res["lnlike"].shape[1]
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    coord = np.tile(COORD, (B, 1))
    plx = p["plx"] if v["plx"] else np.full(B, np.nan, np.float32)
    plxe = p["plxe"] if v["plx"] else np.full(B, np.nan, np.float32)
    dm = np.tile(np.linspace(0.0, 1.5, 120, dtype=np.float32), (B, 1))
    dm[1] *= 0.5                              # per-star dust ladders
    ds = np.full((B, 120), 0.2, np.float32)
    lnprior, feh, loga = rows["lnprior"], rows["feh"], rows["loga"]
    gidx = None
    if v.get("per_star"):
        shift = (np.arange(M)[None, :] + 97 * np.arange(B)[:, None]) % M
        lnprior, feh, loga = (np.ascontiguousarray(x[shift])
                              for x in (lnprior, feh, loga))
        gidx = (shift + 5000).astype(np.int32)
    if not v["labels"]:
        feh = loga = None
    custom = v.get("callables", False)
    fn = partial(j_lnpost_grid, cfg=pcfg,
                 lngalprior=j_lngal if custom else None,
                 lndustprior=j_lndust if custom else None)
    per = lambda x: x is not None and np.ndim(x) == 2
    ax = lambda x: 0 if per(x) else None
    j = lambda x: None if x is None else jnp.asarray(x)
    ref = jax.vmap(
        lambda k, r, lp, co, px, pe, fe, la, gi, m, s: fn(
            k, r, lp, co, parallax=px, parallax_err=pe, feh=fe, loga=la,
            global_idx=gi, dust_profile=(jnp.asarray(LADDER), m, s)
            if v["dust"] else None),
        in_axes=(0, 0, ax(lnprior), 0, 0, 0, ax(feh), ax(loga), ax(gidx),
                 0, 0))(keys, res, j(lnprior), j(coord), j(plx), j(plxe),
                        j(feh), j(loga), j(gidx), j(dm), j(ds))
    K = min(pcfg.n_sel_max, M)
    if pcfg.prefilter_k and pcfg.prefilter_k < M:
        K = min(K, pcfg.prefilter_k)
    noise = _jax_noise(keys, K, pcfg)
    t = lambda x: None if x is None else torch.as_tensor(np.array(x))
    results = {k: t(res[k]) for k in ("lnlike", "chi2", "scale", "av", "rv",
                                      "ndim")}
    results["icov_parts"] = tuple(t(x) for x in res["icov_parts"])
    out = TP.lnpost_grid(
        results, t(lnprior), t(coord), noise, parallax=t(plx),
        parallax_err=t(plxe), feh=t(feh), loga=t(loga),
        dust_profile=(t(LADDER), t(dm), t(ds)) if v["dust"] else None,
        global_idx=t(gidx), cfg=TC.PosteriorConfig(**v["cfg"]),
        lngalprior=t_lngal if custom else None,
        lndustprior=t_lndust if custom else None)
    np.testing.assert_array_equal(out["model_idx"].numpy(),
                                  np.asarray(ref["model_idx"]))
    np.testing.assert_array_equal(out["ndim"].numpy(),
                                  np.asarray(ref["ndim"]))
    for k in ("scale", "av", "rv", "cov_sar", "lnprob", "dist", "red",
              "dred", "logwt", "log_evidence", "chi2min"):
        np.testing.assert_allclose(out[k].numpy().astype(float),
                                   np.asarray(ref[k], float), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    if custom:       # the callables change the answer
        base = TP.lnpost_grid(
            results, t(lnprior), t(coord), noise, parallax=t(plx),
            parallax_err=t(plxe), feh=t(feh), loga=t(loga),
            dust_profile=(t(LADDER), t(dm), t(ds)), global_idx=t(gidx),
            cfg=TC.PosteriorConfig(**v["cfg"]))
        assert (base["log_evidence"] - out["log_evidence"]).abs().max() > 0.1


class _LadderMap:
    """A dust map with one 16-rung profile per star."""

    def query(self, coords):
        n = np.size(coords[0])
        return (np.linspace(0.05, 5.0, 16),
                np.tile(np.linspace(0.0, 1.0, 16), (n, 1)),
                np.full((n, 16), 0.2))


@pytest.mark.parametrize("engine", ["dense", "funnel"])
def test_fit_custom_priors_match(engine):
    """`BruteForce.fit` with custom Galactic and dust prior callables on
    each engine against `brutus_tpu.BruteForce.fit(engine="fused")`
    with the same callables in JAX, four seeds each (the two draw from
    different generators): posterior medians of the pooled draws within
    2%, and mean log-evidences within 0.1 nats or 4 standard errors of
    their difference, whichever is larger (one star of this problem
    scatters by ~0.08 nats from run to run)."""
    from brutus_tpu.fitting import BruteForce as JBruteForce
    from brutus_tpu_torch import BruteForce
    p = _problem(2048, 8, 6, 13)
    kw = dict(data_coords=np.tile(COORD, (6, 1)), parallax=p["plx"],
              parallax_err=p["plxe"], lnprior=p["lnprior"],
              dustmap=_LadderMap(), Nmc_prior=50, Ndraws=250, batch_size=6,
              n_sel_max=512, tile=512, verbose=False, return_results=True,
              screen_k=512 if engine == "funnel" else 0)
    args = (p["flux"], p["err"], p["mask"])
    jbf = JBruteForce(p["mc"], p["lab"])
    tbf = BruteForce(p["mc"], p["lab"], device="cpu")
    refs = [jbf.fit(*args, engine="fused", save_file=None, seed=s,
                    lngalprior=j_lngal, lndustprior=j_lndust, **kw)
            for s in range(4)]
    outs = [tbf.fit(*args, seed=s, lngalprior=t_lngal,
                    lndustprior=t_lndust, **kw) for s in range(4)]
    for out in outs:
        for k, v in out.items():
            if v.dtype.kind == "f":
                assert np.isfinite(v).all(), k
    pool = lambda runs, k: np.stack([np.asarray(r[k]) for r in runs])
    med = np.median(np.concatenate(pool(outs, "dist"), 1), 1)
    med_j = np.median(np.concatenate(pool(refs, "dist"), 1), 1)
    assert np.max(np.abs(med / med_j - 1)) < 0.02
    lev, lev_j = pool(outs, "log_evidence"), pool(refs, "log_evidence")
    se = np.sqrt((lev.var(0, ddof=1) + lev_j.var(0, ddof=1)) / 4)
    diff = np.abs(lev.mean(0) - lev_j.mean(0))
    assert (diff < np.maximum(0.1, 4 * se)).all(), (diff, se)
