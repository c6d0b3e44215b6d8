"""`brutus_tpu_torch.BruteForce.fit` (the funnel main path, on the CPU
with the kernels' plain versions) against `brutus_tpu.BruteForce.fit`
and the float64 oracle, on the correlated grid of
`test_fitting.py::test_production_composition_matches_oracle`; the
options the port does not have yet; and the card-free import.  The
dense engine on the same problem: `test_torch_dense.py`."""

import functools
import types
import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp

from oracle import oracle_loglike, oracle_lnpost
from brutus_tpu.priors import gal_lnprior
from brutus_tpu.fitting import BruteForce as JBruteForce
from brutus_tpu.io import load_results as j_load_results
from brutus_tpu_torch import BruteForce
from brutus_tpu_torch.io import load_results

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COORD = np.array([204.7, -19.2])


@pytest.fixture(scope="module")
def problem():
    """The production-composition problem: an 8192-model locally dense
    correlated grid, 8 stars (one masked band on a third of them, one
    without parallax), its float64 oracle posterior medians and
    evidences, and the JAX package's fit written to HDF5."""
    rng = np.random.default_rng(77)
    F = 8
    t1 = np.linspace(0, 1, 16)
    t2 = np.linspace(0, 1, 512)
    uu, vv = [x.ravel() for x in np.meshgrid(t1, t2, indexing="ij")]
    M = len(uu)

    def surf(lo, hi):
        acc = 0.0
        for k in range(1, 4):
            acc = acc + (
                rng.normal(size=F)[None] * np.sin(2 * np.pi * k * uu)[:, None]
                + rng.normal(size=F)[None]
                * np.cos(2 * np.pi * k * vv)[:, None]
                + rng.normal(size=F)[None]
                * np.sin(2 * np.pi * k * (uu + vv))[:, None])
        acc = (acc - acc.min()) / (acc.max() - acc.min() + 1e-9)
        return lo + (hi - lo) * acc

    mc = np.stack([surf(8.0, 15.0), surf(0.4, 1.1), surf(0.05, 0.2)], -1)
    feh = surf(-2.0, 0.3)[:, 0].copy()
    loga = surf(8.0, 10.1)[:, 1].copy()
    lnprior = rng.uniform(-1.0, 0.0, M)
    labels = np.zeros(M, [("mini", float), ("feh", float), ("loga", float)])
    labels["mini"] = rng.uniform(0.5, 2.0, M)
    labels["feh"] = feh
    labels["loga"] = loga
    n_star = 8
    idx = rng.integers(0, M, n_star)
    av_t = rng.uniform(0.1, 1.0, n_star)
    rv_t = rng.uniform(2.9, 3.7, n_star)
    d_t = rng.uniform(0.7, 1.5, n_star)
    sed = mc[idx, :, 0] + av_t[:, None] * (
        mc[idx, :, 1] + rv_t[:, None] * mc[idx, :, 2])
    flux = 10 ** (-0.4 * sed) / d_t[:, None] ** 2
    errs = flux / 15.0
    flux = flux + rng.normal(size=flux.shape) * errs
    mask = np.ones((n_star, F), bool)
    mask[::3, 2] = False
    plx = 1.0 / d_t
    plxe = 0.10 * plx
    plx[1] = np.nan
    plxe[1] = np.nan
    coords = np.tile(COORD, (n_star, 1))

    med_o, lev_o = [], []
    for b in range(n_star):
        results = oracle_loglike(flux[b], errs[b], mask[b], mc,
                                 parallax=plx[b], parallax_err=plxe[b])
        z = np.random.default_rng(100 + b).normal(size=(M, 3, 256))

        def gal_fn(dists, s, _b=b):
            fe, la = feh[s], loga[s]
            if np.ndim(dists) == 2:
                fe, la = fe[:, None], la[:, None]
            return np.asarray(gal_lnprior(
                jnp.asarray(dists), jnp.asarray(coords[_b]),
                feh=jnp.asarray(fe), loga=jnp.asarray(la)))

        _, _, lnp_o, dist_o, _, _, logwt_o, levid_o = oracle_lnpost(
            results, z, parallax=plx[b], parallax_err=plxe[b],
            lnprior=lnprior, gal_fn=gal_fn)
        wk = np.exp(lnp_o - lnp_o.max())
        wk /= wk.sum()
        wmc = np.exp(logwt_o - logwt_o.max(axis=1, keepdims=True))
        wmc /= wmc.sum(axis=1, keepdims=True)
        wj = (wk[:, None] * wmc).ravel()
        order = np.argsort(dist_o.ravel())
        cdf = np.cumsum(wj[order])
        med_o.append(dist_o.ravel()[order][np.searchsorted(cdf, 0.5)])
        lev_o.append(levid_o)
    kw = dict(data_coords=coords, parallax=plx, parallax_err=plxe,
              lnprior=lnprior, engine="fused", tile=512, screen_k=2048,
              batch_size=n_star, Nmc_prior=50, Ndraws=250, verbose=False)
    return dict(mc=mc, labels=labels, flux=flux, errs=errs, mask=mask,
                kw=kw, med_o=np.array(med_o), lev_o=np.array(lev_o))


def test_fit_lands_in_the_oracle_envelope(problem, tmp_path):
    """The JAX package's shipped composition lands within 0.79% of the
    float64 oracle's posterior medians and 0.022 nats of its evidence
    (one MC realization).  The port's posterior, pooled over 8 seeds to
    take its own MC noise (~0.5% and ~0.05 nats per star and run) down
    below that envelope, must land inside it."""
    p = problem
    bf = BruteForce(p["mc"], p["labels"], device="cpu")
    outs = [bf.fit(p["flux"], p["errs"], p["mask"], seed=s,
                   return_results=True, **p["kw"]) for s in range(8)]
    dist = np.concatenate([o["dist"] for o in outs], axis=1)
    lev = np.mean([o["log_evidence"] for o in outs], axis=0)
    worst_med = np.max(np.abs(np.median(dist, 1) - p["med_o"]) / p["med_o"])
    worst_lev = np.max(np.abs(lev - p["lev_o"]))
    assert worst_med < 0.0079, worst_med
    assert worst_lev < 0.022, worst_lev
    for o in outs:
        for k, v in o.items():
            if v.dtype.kind == "f":
                assert np.isfinite(v).all(), k


def test_fit_hdf5_matches_the_jax_package(problem, tmp_path):
    """Both packages fit the same grid and write the 13-dataset file:
    same datasets, shapes and dtypes, the same band counts and chi2
    minima (float32 rounding, 1e-3), and posterior medians and
    evidences within the sum of two single-run MC envelopes (2% and
    0.1 nats: each run lies within ~1% and ~0.05 nats of the exact
    posterior); the file holds what `return_results` returns."""
    p = problem
    fj, ft = str(tmp_path / "jax.h5"), str(tmp_path / "torch.h5")
    JBruteForce(p["mc"], p["labels"]).fit(p["flux"], p["errs"], p["mask"],
                                          save_file=fj, **p["kw"])
    out = BruteForce(p["mc"], p["labels"], device="cpu").fit(
        p["flux"], p["errs"], p["mask"], save_file=ft, return_results=True,
        **p["kw"])
    rj, rt = j_load_results(fj), load_results(ft)
    assert sorted(rj) == sorted(rt) and len(rt) == 13
    for k in rj:
        assert rt[k].shape == rj[k].shape and rt[k].dtype == rj[k].dtype, k
    np.testing.assert_array_equal(rt["obj_Nbands"], rj["obj_Nbands"])
    np.testing.assert_allclose(rt["obj_chi2min"], rj["obj_chi2min"],
                               rtol=1e-3)
    med_t = np.median(rt["samps_dist"], 1)
    med_j = np.median(rj["samps_dist"], 1)
    assert np.max(np.abs(med_t / med_j - 1)) < 0.02
    assert np.max(np.abs(rt["obj_log_evid"] - rj["obj_log_evid"])) < 0.1
    np.testing.assert_array_equal(rt["samps_dist"], out["dist"])
    np.testing.assert_array_equal(rt["model_idx"], out["model_idx"])
    assert (rt["model_idx"] >= 0).all()


ENGINES = {"dense": 0, "funnel": 2048}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_fit_rows_do_not_depend_on_batch_size(problem, engine):
    """Each star draws from its own stream keyed by `(seed, row)`, as the
    JAX package keys it by `fold_in(PRNGKey(seed), row)`: the same stars
    fitted in batches of 8 and of 3 (the rows then sit at other batch
    positions, and the last batch is short) give the same model draws,
    and distances within rtol = 1e-5 (`test_fitting.py`'s
    `test_fit_scan_batches_identical_rows` holds the JAX package to
    the same)."""
    p = problem
    bf = BruteForce(p["mc"], p["labels"], device="cpu")
    kw = dict(p["kw"], screen_k=ENGINES[engine], seed=3,
              return_results=True)
    outs = [bf.fit(p["flux"], p["errs"], p["mask"],
                   **dict(kw, batch_size=n)) for n in (8, 3)]
    np.testing.assert_array_equal(outs[0]["model_idx"],
                                  outs[1]["model_idx"])
    np.testing.assert_allclose(outs[0]["dist"], outs[1]["dist"], rtol=1e-5)


def test_funnel_draws_alike_with_and_without_kernel_rng(problem,
                                                        monkeypatch):
    """K4 makes its normals from the star keys (`kernel_rng`, the
    default) or is fed `rng.normals` of the same keys: on the CPU both
    run the same plain arithmetic, so the fits are equal bit for bit."""
    from brutus_tpu_torch import config, fitting
    p = problem
    bf = BruteForce(p["mc"], p["labels"], device="cpu")
    outs = []
    for kernel_rng in (True, False):
        monkeypatch.setattr(fitting, "PosteriorConfig", functools.partial(
            config.PosteriorConfig, kernel_rng=kernel_rng))
        outs.append(bf.fit(p["flux"], p["errs"], p["mask"], seed=5,
                           return_results=True, **p["kw"]))
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)


NOT_PORTED = {
    # a mesh whose model axis would shard the dense fused engine's grid
    # (`brutus_tpu/fitting.py:763-768`); the mesh is read before any
    # collective, so its shape alone stands for one here
    "mesh": (dict(mesh=types.SimpleNamespace(shape={"data": 1, "model": 2}),
                  engine="fused", screen_k=0), ValueError, "funnel"),
    "unknown_engine": (dict(engine="pallas"), ValueError, "engine"),
}


@pytest.mark.parametrize("case", sorted(NOT_PORTED))
def test_unported_options_raise(case):
    """A model-sharded mesh on the dense fused engine raises
    `ValueError` naming the funnel, as the JAX package's does; an
    engine neither 'fused' nor 'xla' raises `ValueError`."""
    rng = np.random.default_rng(0)
    M, F = 600, 5
    mc = np.stack([rng.uniform(8, 16, (M, F)), rng.uniform(0.4, 1.1, (M, F)),
                   rng.uniform(0.05, 0.2, (M, F))], -1)
    labels = np.zeros(M, [("feh", float)])
    flux = 10 ** (-0.4 * mc[:2, :, 0])
    kw = dict(screen_k=256, verbose=False)
    opts, exc, match = NOT_PORTED[case]
    kw.update(opts)
    with pytest.raises(exc, match=match):
        BruteForce(mc, labels, device="cpu").fit(
            flux, flux / 30, np.ones((2, F), bool), **kw)


def test_card_free_import_and_cpu_rehearsal():
    """With jax, h5py and brutus_tpu made unimportable, the package
    imports and `chip_smoke.py --cpu --tiny` runs its funnel paths, its
    dense path, the reference-semantics engines, the rest of
    `BruteForce`, the integer grid-index path and the device mesh (two
    gloo worlds of spawned processes) to the end (no module of the card
    path needs them)."""
    code = (
        "import sys, runpy\n"
        "for m in ('jax', 'h5py', 'brutus_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import brutus_tpu_torch, brutus_tpu_torch.fitting\n"
        "sys.argv = ['chip_smoke.py', '--cpu', '--tiny']\n"
        "try:\n"
        "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    sys.exit(e.code)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "phase 4 main path" in r.stdout
    assert "phase 5 funnel, fed normals" in r.stdout
    assert "phase 6 dense path" in r.stdout
    assert "phase 8 reference-semantics funnel" in r.stdout
    assert "phase 9 rest of BruteForce on the funnel" in r.stdout
    assert "phase 10 fallback past 2**24 models" in r.stdout
    assert "phase 14 device mesh" in r.stdout
    assert "phase 7 rehearsal done on the CPU" in r.stdout
    assert '"platform": "gpu"' not in r.stdout
