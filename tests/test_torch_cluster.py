"""The port's cluster fit against `brutus_tpu`: the samplers and chain
diagnostics of `sampling.py`, and `cluster.isochrone_loglike` /
`fit_cluster`, on the synthetic isochrones of `tests/test_torch_models.py`
(the layout of `tests/test_models.py`) and its network file.

`isochrone_loglike` is held against the JAX function in float64; the
samplers draw from other random streams than JAX's, so they are held
against analytic means, covariances and evidences, and `fit_cluster`
against the truth, within the limits of the JAX package's own tests.
"""

import numpy as np
import pytest
import torch

from brutus_tpu import sampling as JS
from brutus_tpu.cluster import isochrone_loglike as j_loglike
from brutus_tpu.models.isochrone import (Isochrone as JIsochrone,
                                         write_isochrone_file)
from brutus_tpu_torch import sampling as TS
from brutus_tpu.models.nn import write_nn_file
from brutus_tpu_torch import cluster as TC
from brutus_tpu_torch.cluster import (_chi2_cmd, _cluster_posterior,
                                      fit_cluster, isochrone_loglike)
from brutus_tpu_torch.models import FastNNPredictor, Isochrone

from test_torch_models import FILTERS, _iso_arrays, nnfile  # noqa: F401

CPU = "cpu"
TRUE = dict(feh=-0.3, loga=9.2, av=0.3, rv=3.3, dist=1000.0)


@pytest.fixture(scope="module")
def isofile(tmp_path_factory):
    """Ages every 0.1 dex (the grain at which the JAX package's cluster
    test recovers feh and loga, `tests/test_models.py::isofile_fine`)."""
    path = str(tmp_path_factory.mktemp("isof") / "iso_fine.h5")
    write_isochrone_file(path, *_iso_arrays(
        np.arange(-1.0, 0.51, 0.25), np.arange(8.6, 10.01, 0.1),
        np.arange(202.0, 606.0, 8.0)))
    return path


@pytest.fixture(scope="module")
def cluster(isofile, nnfile):  # noqa: F811
    """Both packages' isochrones from the same files, and 40 members at
    the truth with 0.5% photometry (one band missing on two stars) and
    1% parallaxes."""
    iso = Isochrone(filters=FILTERS, nnfile=nnfile, mistfile=isofile,
                    verbose=False, device=CPU)
    jiso = JIsochrone(filters=FILTERS, nnfile=nnfile, mistfile=isofile,
                      verbose=False)
    seds = iso.get_seds(eep=np.linspace(220, 550, 120), mini_bound=0.4,
                        **TRUE)[0].numpy()
    seds = seds[np.isfinite(seds).all(axis=1)]
    r = np.random.default_rng(5)
    pick = np.sort(r.choice(len(seds), 40, replace=False))
    phot = 10 ** (-0.4 * seds[pick])
    err = phot * 0.005
    phot = phot + r.normal(size=phot.shape) * err
    phot[3, 1] = np.nan
    err[7, 4] = np.nan
    return dict(iso=iso, jiso=jiso, phot=phot, err=err,
                plx=np.full(len(phot), 1.0), plxe=np.full(len(phot), 0.01))


THETA = np.array([-0.25, 9.25, 0.35, 3.2, 980.0, 0.05])
CASES = {
    "free": dict(theta=THETA),
    "fixed_free_offsets": dict(
        theta=np.r_[-0.25, 9.25, 0.35, 980.0,
                    1.0 + 0.01 * np.arange(len(FILTERS))],
        cluster_params=[None, None, None, 3.3, None, 0.05],
        offsets="free"),
    "free_corrections": dict(
        theta=np.r_[THETA, np.ones(len(FILTERS)), 0.05, -0.12, 40.0],
        corr_params=[None, None, None, 0.5], smf_grid=np.array([0.0])),
    "no_parallax": dict(theta=THETA, parallax=False, dim_prior=False,
                        offsets=[None, 1.02, None, None, 0.98, None]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_isochrone_loglike_matches_jax(cluster, case):
    """Free and fixed specs, free offsets, free corrections, parallaxes
    on and off (with the dimensionless prior and without): the total
    and every star's mixture term within relative 1e-8 of JAX, binaries
    of smf 0.5 and 1 included."""
    kw = dict(CASES[case])
    theta = kw.pop("theta")
    if kw.pop("parallax", True):
        kw.update(parallax=cluster["plx"], parallax_err=cluster["plxe"])
    if kw.get("offsets", "fixed") not in ("fixed", "free"):
        theta = np.r_[theta, 1.01, 0.99, 1.0, 1.03]
    kw.setdefault("smf_grid", np.array([0.0, 0.5, 1.0]))
    kw.update(eep_grid=np.linspace(202.0, 600.0, 300), mini_bound=0.4,
              return_lnls=True)
    tot, lnls = isochrone_loglike(theta, cluster["iso"], cluster["phot"],
                                  cluster["err"], device=CPU, **kw)
    jtot, jlnls = j_loglike(theta, cluster["jiso"], cluster["phot"],
                            cluster["err"], **kw)
    assert np.isfinite(tot) and lnls.shape == (40,)
    np.testing.assert_allclose(tot, jtot, rtol=1e-8)
    np.testing.assert_allclose(lnls, jlnls, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("group", [1, 3])
def test_walker_groups_do_not_change_results(cluster, monkeypatch, group):
    """`fit_cluster`'s posterior (`_cluster_posterior`, all six cluster
    parameters free, binaries of smf 0.5 and 1) at seven parameter sets
    in one call, with `BLOCK_ELEMENTS` cut so that the sets go through
    the chi-square in groups of `group`: every set's log-likelihood
    within relative 1e-12 of one group of all seven and of
    `isochrone_loglike` at that set alone."""
    kw = dict(smf_grid=np.array([0.0, 0.5, 1.0]),
              eep_grid=np.linspace(202.0, 600.0, 300), mini_bound=0.4,
              parallax=cluster["plx"], parallax_err=cluster["plxe"],
              cluster_prob=0.95, dim_prior=True)
    args = (cluster["iso"], cluster["phot"], cluster["err"])
    r = np.random.default_rng(4)
    thetas = THETA + r.normal(size=(7, 6)) * [0.05, 0.05, 0.03, 0.1, 10.0,
                                               0.01]

    def batch():
        post = _cluster_posterior(*args, "free", "fixed", "fixed",
                                  kw["mini_bound"], 480.0, kw["smf_grid"],
                                  kw["eep_grid"], kw["parallax"],
                                  kw["parallax_err"], 0.95, True, None, CPU)
        lo, hi = post["lo"].numpy(), post["hi"].numpy()
        u = torch.as_tensor((thetas - lo) / (hi - lo))
        return post["logpost"](u).numpy()

    whole = batch()
    per_set = 3 * 300 * len(cluster["phot"])
    monkeypatch.setattr(TC, "BLOCK_ELEMENTS", group * per_set)
    grouped = batch()
    single = [isochrone_loglike(th, *args, device=CPU, **kw)
              for th in thetas]
    assert np.isfinite(whole).all()
    np.testing.assert_allclose(grouped, whole, rtol=1e-12)
    np.testing.assert_allclose(single, whole, rtol=1e-12)


@pytest.fixture(scope="module")
def phase12_files(tmp_path_factory):
    """`chip_smoke.py` phase 12's isochrone tables at their rehearsal
    size and both of its networks (phase 11's and `smooth_nn_arrays`),
    as HDF5 files for the JAX package."""
    import chip_smoke as cs
    d = tmp_path_factory.mktemp("phase12")
    write_isochrone_file(str(d / "iso.h5"), *cs.synth_isochrone_arrays(True))
    for name, arrays in (("phase11", cs.synth_nn_arrays()),
                         ("smooth", cs.smooth_nn_arrays())):
        write_nn_file(str(d / f"{name}.h5"), cs.GRID_FILTERS, *arrays)
    return d


@pytest.mark.parametrize("network", ["phase11", "smooth"])
def test_phase12_landscape_matches_jax(phase12_files, network):
    """Phase 12's cluster (its generator, 100 members and 5 field stars,
    the rehearsal's tables, 300 EEPs) on each of its networks, through
    both packages from the same files: every star's term within
    relative 1e-8 of JAX at the truth and at Av + 0.05, [Fe/H] +- 0.2
    and Rv +- 0.1.  On phase 11's network every such move leaves every
    member at its outlier floor, so that the fit sees a plateau (phase
    12's control); on `smooth_nn_arrays` each costs at most 10 nats."""
    import chip_smoke as cs
    d = phase12_files
    nn, iso_file = str(d / f"{network}.h5"), str(d / "iso.h5")
    iso = Isochrone(filters=cs.GRID_FILTERS, nnfile=nn, mistfile=iso_file,
                    verbose=False, device=CPU)
    jiso = JIsochrone(filters=cs.GRID_FILTERS, nnfile=nn, mistfile=iso_file,
                      verbose=False)
    data = cs.synth_cluster(iso, 100)
    kw = dict(parallax=data["parallax"], parallax_err=data["parallax_err"],
              eep_grid=np.linspace(202.0, 808.0, 300), return_lnls=True)
    t = cs.CLUSTER_TRUTH
    truth = np.array([t["feh"], t["loga"], t["av"], t["rv"], t["dist"],
                      0.05])
    member = data["member"]
    # A star's outlier floor: the mixture's outlier term alone.
    floor = (TC._prepare_cluster_data(data["phot"], data["err"],
                                      data["parallax"], data["parallax_err"],
                                      True)[4]
             + np.log1p(-0.95 * (1.0 - 0.05)))
    base = None
    for axis, step in ((None, 0.0), (2, 0.05), (0, 0.2), (0, -0.2),
                       (3, 0.1), (3, -0.1)):
        th = truth.copy()
        if axis is not None:
            th[axis] += step
        tot, lnls = isochrone_loglike(th, iso, data["phot"], data["err"],
                                      device=CPU, **kw)
        jtot, jlnls = j_loglike(th, jiso, data["phot"], data["err"], **kw)
        np.testing.assert_allclose(lnls, jlnls, rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(tot, jtot, rtol=1e-8)
        if base is None:
            base = tot
            # at the truth three in four members stand above the floor
            assert np.mean(lnls[member] > floor[member] + 1.0) > 0.75, \
                np.mean(lnls[member] > floor[member] + 1.0)
        elif network == "phase11":
            np.testing.assert_allclose(jlnls[member], floor[member],
                                       atol=1e-3)
        else:
            assert tot > base - 10.0, (axis, step, tot - base)


def test_chi2_f32_envelope():
    """The decomposed chi-square (`cluster._chi2_cmd`) in float32 against
    the explicit residual in float64 from the same inputs, at the limits
    of `tests/test_applications.py::test_cluster_chi2_f32_envelope`: an
    error below 0.2 at SNR 100 and 1.5 at SNR 300, growing ~SNR**2 (at
    SNR 3000 more than 5x that at 300)."""
    r = np.random.default_rng(11)
    n_pts, n_obj, F = 64, 16, 8
    model = r.uniform(0.5, 2.0, (n_pts, F))
    data = model[r.integers(0, n_pts, n_obj)] \
        * (1.0 + r.normal(0, 1e-3, (n_obj, F)))
    m32 = torch.as_tensor(model, dtype=torch.float32)[None]
    d32 = torch.as_tensor(data, dtype=torch.float32)[None]
    errs = {}
    for snr in (100.0, 300.0, 3000.0):
        w = torch.as_tensor((snr / data) ** 2, dtype=torch.float32)[None]
        chi2 = _chi2_cmd(m32, torch.ones_like(m32), w, d32 * w,
                         d32 ** 2 * w)[0].double().numpy()
        m64, d64, w64 = (x[0].double().numpy() for x in (m32, d32, w))
        ref = ((d64[None] - m64[:, None]) ** 2 * w64[None]).sum(-1)
        errs[snr] = float(np.max(np.abs(chi2 - ref)))
    assert errs[100.0] < 0.2, errs
    assert errs[300.0] < 1.5, errs
    assert errs[3000.0] > 5 * errs[300.0], errs


def test_chain_diagnostics_match_jax():
    """`chain_diagnostics`, `split_rhat` and `integrated_autocorr_time`
    on one AR(1) ensemble chain: within 1e-10 of JAX."""
    r = np.random.default_rng(2)
    n, w, d = 600, 16, 3
    x = np.zeros((n, w, d))
    for t in range(1, n):
        x[t] = 0.9 * x[t - 1] + r.normal(size=(w, d))
    acc = r.uniform(size=(n, w)) < 0.4
    got, ref = TS.chain_diagnostics(x, acc), JS.chain_diagnostics(x, acc)
    for k in ("tau", "ess", "rhat", "acceptance"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-10)
    np.testing.assert_allclose(TS.split_rhat(x[:, :, :2]),
                               JS.split_rhat(x[:, :, :2]), rtol=1e-10)
    np.testing.assert_allclose(TS.integrated_autocorr_time(x, c=3.0),
                               JS.integrated_autocorr_time(x, c=3.0),
                               rtol=1e-10)
    np.testing.assert_allclose(TS.default_beta_ladder(9, 4.0),
                               JS.default_beta_ladder(9, 4.0), rtol=1e-12)


def test_ensemble_sample_correlated_gaussian():
    """The stretch-move sampler on a correlated 3-D Gaussian in the unit
    cube: the mean within 4 Monte-Carlo standard errors (the chain's own
    effective sample size), the variances within 20% and the
    correlation within 0.06 of the truth."""
    mu = np.array([0.5, 0.4, 0.6])
    sd = np.array([0.05, 0.08, 0.04])
    corr = np.array([[1.0, 0.8, -0.3], [0.8, 1.0, 0.0], [-0.3, 0.0, 1.0]])
    cov = corr * sd[:, None] * sd[None]
    icov = torch.as_tensor(np.linalg.inv(cov))
    mu_t = torch.as_tensor(mu)

    def logpost(u):
        inb = torch.all((u > 0) & (u < 1), dim=-1)
        d = u - mu_t
        lp = -0.5 * ((d @ icov) * d).sum(-1)
        return torch.where(inb, lp, torch.full_like(lp, -torch.inf))

    run = TS.ensemble_sample(logpost, 3, n_walkers=32, n_steps=2000,
                             seed=3, device=CPU)
    assert run["chain"].shape == (2000, 32, 3)
    chain = run["chain"][500:].numpy()
    diag = TS.chain_diagnostics(chain, run["accept"][500:].numpy())
    assert 0.2 < diag["acceptance"] < 0.8
    flat = chain.reshape(-1, 3)
    se = sd / np.sqrt(diag["ess"])
    assert (np.abs(flat.mean(0) - mu) < 4 * se).all(), (flat.mean(0), se)
    c = np.cov(flat.T)
    np.testing.assert_allclose(np.diag(c), sd ** 2, rtol=0.2)
    rho = c / np.sqrt(np.outer(np.diag(c), np.diag(c)))
    np.testing.assert_allclose(rho, corr, atol=0.06)


def test_evidence_ladder_analytic_gaussian():
    """`tempered_ensemble_sample` + `evidence_from_ladder` on the case of
    `tests/test_applications.py::test_evidence_ladder_analytic_gaussian`
    (a sigma = 0.1 bump in the unit cube, lnZ ~= 0), at its limits."""
    nd = 3

    def logl(u):
        inb = torch.all((u > 0) & (u < 1), dim=-1)
        ll = (-0.5 * torch.sum(((u - 0.5) / 0.1) ** 2, -1)
              - nd * np.log(0.1 * np.sqrt(2 * np.pi)))
        return torch.where(inb, ll, torch.full_like(ll, -torch.inf))

    betas = TS.default_beta_ladder(12)
    run = TS.tempered_ensemble_sample(logl, nd, betas, n_walkers=64,
                                      n_steps=1200, seed=0, device=CPU)
    assert run["chain"].shape == (12, 1200, 64, nd)
    ev = TS.evidence_from_ladder(betas, run["logl"][:, 400:].numpy())
    assert abs(ev["logz"]) < max(0.15, 4 * ev["logz_err"]), ev
    assert ev["logz_err"] < 0.1
    last = run["chain"][-1, 400:].reshape(-1, nd).numpy()
    np.testing.assert_allclose(last.mean(axis=0), 0.5, atol=0.02)
    assert np.isfinite(ev["logz_ti"]) and ev["logz_ti"] <= ev["logz"]


@pytest.fixture(scope="module")
def smooth_cluster():
    """A cluster the likelihood can resolve: the isochrones of `isofile`
    built in memory, on a network of the JAX package's cluster-test
    scales whose first layer is weighted toward Teff (colours change
    along the isochrone, magnitudes smoothly with Av and [Fe/H]); 80
    members at the truth, uniform in initial mass (the likelihood's own
    mass measure), 0.5% photometry and 1% parallaxes."""
    rng = np.random.default_rng(21)
    nf, h = len(FILTERS), 8
    arrays = (rng.normal(size=(nf, h, 6)) * [3.0, 0.5, 0.5, 0.5, 0.5, 0.5],
              rng.normal(size=(nf, h, 1)) * 0.1,
              rng.normal(size=(nf, h, h)) * 0.5,
              rng.normal(size=(nf, h, 1)) * 0.1,
              rng.normal(size=(nf, 1, h)) * 0.5,
              rng.normal(size=(nf, 1, 1)) * 0.1,
              np.array([2000.0, 0.0, -3.0, -0.3, 0.0, 1.0]),
              np.array([20000.0, 6.0, 1.0, 0.7, 2.5, 6.0]))
    iso = Isochrone(filters=FILTERS, verbose=False, device=CPU,
                    arrays=_iso_arrays(np.arange(-1.0, 0.51, 0.25),
                                       np.arange(8.6, 10.01, 0.1),
                                       np.arange(202.0, 606.0, 8.0)),
                    nn=FastNNPredictor(filters=FILTERS, arrays=arrays,
                                       device=CPU))
    seds, p1, _ = iso.get_seds(eep=np.linspace(202.0, 606.0, 2000),
                               mini_bound=0.4, **TRUE)
    seds = seds.numpy()
    ok = np.isfinite(seds).all(1)
    mini, seds = p1["mini"][ok], seds[ok]
    r = np.random.default_rng(5)
    pick = np.clip(np.searchsorted(mini, r.uniform(mini.min(), mini.max(),
                                                   80)), 0, len(mini) - 1)
    phot = 10 ** (-0.4 * seds[pick])
    err = phot * 0.005
    phot = phot + r.normal(size=phot.shape) * err
    return dict(iso=iso, phot=phot, err=err, plx=np.full(80, 1.0),
                plxe=np.full(80, 0.01))


@pytest.fixture
def two_threads():
    """Two intra-op threads for the sampler's 1600 small likelihood
    calls: with one per core in each of several test processes, the
    threads oversubscribe the host and the test runs ten times longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_fit_cluster_recovers_params(smooth_cluster, two_threads):
    """`fit_cluster` with the settings of `tests/test_applications.py::
    test_fit_cluster_recovers_params` (feh, loga, av and distance free,
    Rv and the outlier fraction fixed, its bounds, 32 walkers, 800
    steps, 500 burn-in): the posterior medians within that test's
    limits of the truth, the MAP at least as likely as the truth less
    2, and the diagnostics present."""
    c = smooth_cluster
    kw = dict(cluster_params=[None, None, None, 3.3, None, 0.02],
              smf_grid=np.array([0.0]),
              eep_grid=np.linspace(202.0, 600.0, 300), mini_bound=0.4,
              parallax=c["plx"], parallax_err=c["plxe"], device=CPU)
    out = fit_cluster(c["iso"], c["phot"], c["err"],
                      bounds=dict(av=(0.0, 2.0), dist=(600.0, 1600.0)),
                      n_walkers=32, n_steps=800, n_burn=500, seed=1, **kw)
    assert out["names"] == ["feh", "loga", "av", "dist"]
    assert 0.02 < out["acceptance"] < 0.95
    med = np.median(out["samples"], axis=0)
    assert abs(med[0] - TRUE["feh"]) < 0.15, med
    assert abs(med[1] - TRUE["loga"]) < 0.15, med
    assert abs(med[2] - TRUE["av"]) < 0.15, med
    assert abs(med[3] - TRUE["dist"]) < 60.0, med
    tf = out["theta_full"]
    assert tf["cluster"][3] == 3.3 and tf["cluster"][5] == 0.02
    ll = lambda th: isochrone_loglike(np.asarray(th), c["iso"], c["phot"],
                                      c["err"], **kw)
    truth = [TRUE["feh"], TRUE["loga"], TRUE["av"], TRUE["dist"]]
    assert ll(out["map_theta"]) >= ll(truth) - 2.0
    assert out["tau"].shape == (4,) and np.isfinite(out["rhat"]).all()


def test_cluster_entry_points_need_a_card_unless_told_cpu(cluster):
    """`isochrone_loglike` and `fit_cluster` run on CUDA by default and
    raise without a card; `cluster_params="fixed"` is refused."""
    args = (cluster["iso"], cluster["phot"], cluster["err"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            isochrone_loglike(THETA, *args)
        with pytest.raises(RuntimeError, match="CUDA"):
            fit_cluster(*args, n_steps=2, n_burn=1)
    with pytest.raises(ValueError, match="cluster_params"):
        fit_cluster(*args, cluster_params="fixed", offsets="free",
                    n_steps=4, n_burn=2, device=CPU)
