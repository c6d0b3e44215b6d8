"""The port's line-of-sight cloud model (`brutus_tpu_torch.los`) against
`brutus_tpu.los`, on the sightlines of `tests/test_applications.py`.

The prior transforms and the likelihood are held against the JAX
functions in float64 on the same seeded numpy inputs.  `fit_clouds`
draws from other random streams than JAX's: given JAX's random numbers
it follows the JAX function's chain step for step; with its own, it is
held against the JAX function's posterior as a distribution and, as
`tests/test_torch_cluster.py` holds the samplers, against the truth of
the synthetic sightline: the recovered cloud, and the evidence choosing
two clouds over one.
"""

import numpy as np
import pytest
import torch

from brutus_tpu import los as JL
from brutus_tpu_torch import los as TL
from brutus_tpu_torch import sampling as TS

CPU = "cpu"
PB = (-3.0, 0.7, -np.inf, 0.0)
SP = (-3.0, 0.3, -np.inf, 0.0)


@pytest.fixture
def two_threads():
    """Two intra-op threads for the sampler tests' many small likelihood
    calls (a copy of `tests/test_torch_cluster.py`'s fixture): with one
    thread per core in each of the suite's worker processes, the threads
    oversubscribe the host and these tests run many times longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sightline(seed, n_obj=40, n_samp=30):
    """Draws of a one-cloud sightline at dm = 9 (one draw at a negative
    distance, outside every segment) and per-star template values."""
    r = np.random.default_rng(seed)
    ds = r.uniform(4, 19, (n_obj, n_samp))
    ds[0, 0] = -1.0
    template = r.uniform(0.5, 2.0, n_obj)
    rs = 0.2 + 1.2 * (ds > 9.0) + r.normal(0, 0.1, (n_obj, n_samp))
    return ds, rs, template


@pytest.mark.parametrize("dust_template", [False, True])
def test_prior_transforms_match_jax(dust_template):
    """The host transform equals JAX's bit for bit; the device transform
    (`ndtri` and the normal CDF, every walker at once) is within
    relative 1e-12 of `_prior_transform_jax` and of the host's scipy
    `truncnorm.ppf`."""
    u = np.random.default_rng(1).uniform(0, 1, (64, 4 + 2 * 3))
    host = np.array([TL.LOS_clouds_priortransform(
        x, dust_template=dust_template) for x in u])
    jhost = np.array([JL.LOS_clouds_priortransform(
        x, dust_template=dust_template) for x in u])
    np.testing.assert_array_equal(host, jhost)
    args = ((0.0, 6.0), (4.0, 19.0), PB, SP, dust_template, (0.2, 2.0))
    dev = TL._theta_from_u(u, *args, torch.device(CPU))
    jdev = np.asarray(JL._theta_from_u(u, *args))
    np.testing.assert_allclose(dev, jdev, rtol=1e-12)
    np.testing.assert_allclose(dev, host, rtol=1e-12)
    parts = TL._prior_transform(torch.as_tensor(u), *args)
    jparts = JL._prior_transform_jax(u, *args)
    for p, jp in zip(parts, jparts):
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-12)


THETAS = {"one_cloud": [0.02, 0.03, 0.05, 0.2, 9.0, 1.2],
          "two_clouds": [0.05, 0.05, 0.08, 0.3, 8.0, 1.0, 13.0, 2.0]}
MODES = {"plain": {}, "template": dict(template=True),
         "additive": dict(additive_foreground=True),
         "template_additive": dict(template=True,
                                   additive_foreground=True)}


@pytest.mark.parametrize("kernel", ["gauss", "tophat", "lorentz"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("theta", list(THETAS))
def test_loglike_samples_matches_jax(kernel, mode, theta):
    """`LOS_clouds_loglike_samples` within relative 1e-10 of JAX for each
    kernel, in template mode, additive mode and both."""
    ds, rs, template = _sightline(3)
    kw = dict(MODES[mode])
    if kw.pop("template", False):
        kw["template_reds"] = template
    th = np.array(THETAS[theta])
    got = TL.LOS_clouds_loglike_samples(th, ds, rs, kernel=kernel,
                                        device=CPU, **kw)
    want = JL.LOS_clouds_loglike_samples(th, ds, rs, kernel=kernel, **kw)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_loglike_callable_kernel_rejection_and_errors():
    """A callable kernel (arithmetic only, so the same function serves
    numpy and torch) matches JAX's callable path; a non-monotonic
    reddening profile gives -inf on both; unsorted distances and an
    unknown kernel name raise on both."""
    ds, rs, template = _sightline(4)
    kern = lambda r, p: -0.5 * ((r - p[0]) / p[1]) ** 2 - np.log(p[1])
    th = np.array(THETAS["two_clouds"])
    for kw in ({}, dict(template_reds=template, additive_foreground=True)):
        got = TL.LOS_clouds_loglike_samples(th, ds, rs, kernel=kern,
                                            device=CPU, **kw)
        want = JL.LOS_clouds_loglike_samples(th, ds, rs, kernel=kern, **kw)
        np.testing.assert_allclose(got, want, rtol=1e-10)
    bad = np.array([0.05, 0.05, 0.08, 0.3, 8.0, 2.0, 13.0, 1.0])
    assert TL.LOS_clouds_loglike_samples(bad, ds, rs, device=CPU) == -np.inf
    assert JL.LOS_clouds_loglike_samples(bad, ds, rs) == -np.inf
    assert np.isfinite(TL.LOS_clouds_loglike_samples(
        bad, ds, rs, monotonic=False, device=CPU))
    unsorted = np.array([0.05, 0.05, 0.08, 0.3, 13.0, 1.0, 8.0, 2.0])
    for mod, kw in ((TL, dict(device=CPU)), (JL, {})):
        with pytest.raises(ValueError, match="monotonically"):
            mod.LOS_clouds_loglike_samples(unsorted, ds, rs, **kw)
        with pytest.raises(ValueError, match="invalid kernel"):
            mod.LOS_clouds_loglike_samples(th, ds, rs, kernel="box", **kw)


def test_core_batches_walkers_like_single_calls(monkeypatch):
    """Walkers evaluated in one call, and in groups of two (a cut
    `BLOCK_ELEMENTS`), give each walker's `LOS_clouds_loglike_samples`
    value."""
    ds, rs, template = _sightline(5)
    r = np.random.default_rng(6)
    W = 5
    dists = np.sort(r.uniform(5, 17, (W, 2)), axis=1)
    reds = np.sort(r.uniform(0.1, 2.5, (W, 3)), axis=1)
    pb, s0, s = r.uniform(0.01, 0.2, (3, W))
    single = [TL.LOS_clouds_loglike_samples(
        np.r_[pb[w], s0[w], s[w], reds[w, 0],
              np.c_[dists[w], reds[w, 1:]].ravel()], ds, rs,
        template_reds=template, device=CPU) for w in range(W)]
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)
    args = (t(reds), t(dists), t(pb), t(s0 * 6.0), t(s * 6.0),
            t(ds[:, :25]), t(rs[:, :25]))
    whole = TL._los_loglike_core(*args, template_reds=t(template))
    monkeypatch.setattr(TL, "BLOCK_ELEMENTS", 2 * ds[:, :25].size)
    grouped = TL._los_loglike_core(*args, template_reds=t(template))
    np.testing.assert_allclose(whole.numpy(), single, rtol=1e-12)
    np.testing.assert_array_equal(grouped.numpy(), whole.numpy())


def _one_cloud_sightline():
    """`test_fit_clouds_recovers_cloud`'s sightline: 120 stars, one
    cloud at dm = 10 with dAv = 1 over a 0.2 foreground."""
    r = np.random.default_rng(3)
    n_obj, n_samp = 120, 25
    dm = r.uniform(4, 19, n_obj)
    av_true = 0.2 + 1.0 * (dm > 10.0)
    ds = dm[:, None] + r.normal(0, 0.3, (n_obj, n_samp))
    rs = av_true[:, None] + r.normal(0, 0.1, (n_obj, n_samp))
    return ds, rs


def test_fit_clouds_recovers_cloud(two_threads):
    """`fit_clouds` on `test_fit_clouds_recovers_cloud`'s sightline (one
    cloud at dm = 10 with dAv = 1 over a 0.2 foreground) at short
    settings: the MAP finds the cloud within that test's limits, the
    posterior reddening behind it is centred on the truth, the MAP fits
    better than a displaced cloud, and the outputs have the JAX
    function's shapes."""
    ds, rs = _one_cloud_sightline()
    out = TL.fit_clouds(ds, rs, n_clouds=1, n_walkers=32, n_steps=600,
                        n_burn=300, seed=1, return_chain=True, device=CPU)
    m = out["map_theta"]
    assert abs(m[4] - 10.0) < 1.0 and abs(m[5] - 1.2) < 0.2, m
    assert abs(m[3] - 0.2) < 0.15, m
    assert abs(np.median(out["samples"][:, 5]) - 1.2) < 0.2
    assert 0.05 < out["acceptance"] < 0.95
    assert out["samples"].shape[1] == 6 and len(out["samples"]) > 200
    assert out["chain"].shape == (300, 32, 6)
    assert out["chain_logl"].shape == (300, 32)
    assert out["tau"].shape == (6,) and np.isfinite(out["rhat"]).all()
    off = m.copy()
    off[4] = 6.0
    assert (TL.LOS_clouds_loglike_samples(m, ds, rs, device=CPU)
            > TL.LOS_clouds_loglike_samples(off, ds, rs, device=CPU))
    # The chain's log-posteriors are the likelihood at its thetas, in
    # float32 as the JAX sampler evaluates it (120 terms of relative
    # rounding ~6e-8 each).
    assert out["samples"].dtype == np.float32
    i = np.argmax(out["logl"])
    np.testing.assert_allclose(
        out["logl"][i], JL.LOS_clouds_loglike_samples(
            out["samples"][i], ds.astype(np.float32), rs.astype(np.float32)),
        rtol=1e-5)


def _two_cloud_sightline():
    """`test_fit_clouds_evidence_selects_cloud_count`'s sightline: 120
    stars, clouds at dm 8 (dAv 0.8) and 13 (dAv 0.7) over 0.2."""
    r = np.random.default_rng(7)
    n_obj, n_samp = 120, 25
    dm = r.uniform(4, 19, n_obj)
    av_true = 0.2 + 0.8 * (dm > 8.0) + 0.7 * (dm > 13.0)
    ds = dm[:, None] + r.normal(0, 0.25, (n_obj, n_samp))
    rs = av_true[:, None] + r.normal(0, 0.08, (n_obj, n_samp))
    return ds, rs


def test_fit_clouds_evidence_selects_two_clouds(two_threads):
    """Evidence on `test_fit_clouds_evidence_selects_cloud_count`'s
    two-cloud sightline (dm 8 and 13) at short settings: the two-cloud
    log-evidence beats the one-cloud one by more than 5 nats and 3
    sigma, and the two-cloud MAP puts its clouds within 1.5 of the
    truth, the limits of that test."""
    ds, rs = _two_cloud_sightline()
    outs = {nc: TL.fit_clouds(ds, rs, n_clouds=nc, n_walkers=32,
                              n_steps=400, n_burn=200, seed=3,
                              evidence=True, n_temps=8, device=CPU)
            for nc in (1, 2)}
    gap = outs[2]["logz"] - outs[1]["logz"]
    err = np.hypot(outs[1]["logz_err"], outs[2]["logz_err"])
    assert gap > 5.0 and gap > 3.0 * err, (gap, err)
    map2 = outs[2]["map_theta"]
    assert abs(map2[4] - 8.0) < 1.5 and abs(map2[6] - 13.0) < 1.5, map2
    assert np.isfinite(outs[2]["logz_ti"])


def _jax_stream(seed, W, ndim, n_steps, K=None):
    """The random numbers of the JAX samplers for `seed`, in the order
    the port's sampler asks for them: the walkers' start, then per
    half-step the partner offsets, the stretch uniforms and the
    acceptance uniforms, `(W,)` each (`(K, W)` on a ladder of K rungs)."""
    import jax
    import jax.numpy as jnp

    def half(k):
        ka, kz, ku = jax.random.split(k, 3)
        return (jax.random.randint(ka, (W,), 0, W // 2),
                jax.random.uniform(kz, (W,), jnp.float32),
                jax.random.uniform(ku, (W,), jnp.float32))

    @jax.jit
    def stream(key):
        key, k0 = jax.random.split(key)
        u0 = jax.random.uniform(k0, (W, ndim) if K is None
                                else (K, W, ndim), jnp.float32, 0.02, 0.98)
        steps = jax.vmap(jax.random.split)(jax.random.split(key, n_steps))
        if K is not None:
            steps = jax.vmap(jax.vmap(lambda k: jax.random.split(k, K)))(
                steps)
            return u0, jax.vmap(jax.vmap(jax.vmap(half)))(steps)
        return u0, jax.vmap(jax.vmap(half))(steps)

    u0, draws = stream(jax.random.PRNGKey(seed))
    draws = [np.asarray(v) for v in draws]
    return np.asarray(u0), [tuple(v[t, h] for v in draws)
                            for t in range(n_steps) for h in range(2)]


@pytest.mark.parametrize("evidence", [False, True])
def test_fit_clouds_follows_jax_step_for_step(monkeypatch, evidence,
                                              two_threads):
    """Given the JAX samplers' random numbers (the start and every
    half-step's draws), the port's `fit_clouds` follows the JAX
    function's chain step for step, with and without the evidence
    ladder: the samplers, the prior transform and the float32
    likelihood are one algorithm, and the packages' chains differ only
    through their random streams.  Two clouds on the two-cloud
    sightline, 32 walkers x 120 steps (6 rungs): every position within
    1e-5 (float32 rounding), the same acceptance, evidences within
    relative 1e-5."""
    ds, rs = _two_cloud_sightline()
    kw = dict(n_walkers=32, n_steps=120, n_burn=0, seed=5,
              return_chain=True, max_samples=0)
    if evidence:
        kw.update(evidence=True, n_temps=6)
    u0, draws = _jax_stream(5, 32, 8, 120, 6 if evidence else None)
    it = iter(draws)
    monkeypatch.setattr(TS, "_init_walkers", lambda shape, g, dtype, dev: (
        torch.tensor(u0, dtype=dtype, device=dev)))
    monkeypatch.setattr(TS, "_stretch_draws", lambda shape, half, g, dtype,
                        dev: tuple(torch.as_tensor(v, device=dev)
                                   for v in next(it)))
    want = JL.fit_clouds(ds, rs, 2, **kw)
    got = TL.fit_clouds(ds, rs, 2, device=CPU, **kw)
    assert next(it, None) is None
    assert 0.05 < want["acceptance"] < 0.95
    assert got["acceptance"] == want["acceptance"]
    np.testing.assert_allclose(got["chain"], want["chain"], rtol=0,
                               atol=1e-5)
    if evidence:
        np.testing.assert_allclose(got["logz"], want["logz"], rtol=1e-5)


def test_fit_clouds_matches_jax_as_a_distribution(two_threads):
    """With their own random streams, the port's and the JAX function's
    `fit_clouds` (one cloud on the one-cloud sightline, 64 walkers x
    1000 steps, 600 burn-in: the JAX package's own
    `test_fit_clouds_recovers_cloud` with a third of its steps) give
    the same posterior core: the foreground's, the cloud distance's and
    its reddening's medians within two standard deviations of each
    other, and their standard deviations within a factor 2 (seeds 1-4
    of both packages read at most 1.7 standard deviations and a factor
    1.7 apart).  The core is the samples within 15 nats of the best: at
    these settings most walkers of either package are still on their
    way or stay behind in other modes, tens of nats below it, and which
    ones depends on the stream (`test_fit_clouds_follows_jax_step_for_
    step` holds the rest of the algorithm)."""
    ds, rs = _one_cloud_sightline()
    kw = dict(n_walkers=64, n_steps=1000, n_burn=600, max_samples=0)
    outs = [TL.fit_clouds(ds, rs, 1, seed=1, device=CPU, **kw),
            JL.fit_clouds(ds, rs, 1, seed=1, **kw)]
    core = [np.asarray(o["samples"], np.float64)[
        o["logl"] > o["logl"].max() - 15.0, 3:6] for o in outs]
    assert all(len(c) > 0.1 * len(o["samples"])
               for c, o in zip(core, outs))
    med = [np.median(c, axis=0) for c in core]
    sd = [c.std(axis=0) for c in core]
    assert (np.abs(med[0] - med[1]) < 2 * np.maximum(*sd)).all(), (med, sd)
    assert (np.abs(med[1] - [0.2, 10.0, 1.2]) < [0.15, 1.0, 0.2]).all()
    ratio = sd[0] / sd[1]
    assert ((ratio > 0.5) & (ratio < 2.0)).all(), sd
