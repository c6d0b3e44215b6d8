"""CPU tests of the benchmark's inputs, counting functions and
reference (no card needed).

    python -m pytest -q -p no:cacheprovider gpubench/tests
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from gpubench import cell, counts, reference as ref, traffic  # noqa: E402

CELLS = ("funnel.survey16k", "funnel.sightline")
SEED = 2 ** 31 + 12345


def small(mix, n=None):
    out = dict(mix)
    if "fixed" in out["call_stars"]:
        out["call_stars"] = {"fixed": n or 300}
        out["pool_calls"] = 3
    return out


@pytest.mark.parametrize("name", CELLS)
def test_calls_repeat_per_seed_and_follow_the_mix(name):
    s = cell.spec(name)
    mix = small(s["traffic"])
    mc, _ = traffic.correlated_grid(4000, 8, seed=3)
    dmap = traffic.DustMap(4, **s["config"]["dust_map"])
    a = traffic.calls(mc, dmap, mix, SEED)
    b = traffic.calls(mc, dmap, mix, SEED)
    c = traffic.calls(mc, dmap, mix, SEED + 1)
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert any(not np.array_equal(x["flux"], y["flux"])
               for x, y in zip(a, c) if x["flux"].shape == y["flux"].shape)
    sizes = [len(x["flux"]) for x in a]
    if "fixed" in mix["call_stars"]:
        assert sizes == [mix["call_stars"]["fixed"]] * mix["pool_calls"]
    else:
        lo, hi = mix["call_stars"]["log_uniform"]
        assert len(sizes) == mix["call_stars"]["distinct"]
        assert min(sizes) >= lo and max(sizes) <= hi
        # every seed fits the same set of sizes, in its own order
        assert sorted(sizes) == sorted(len(x["flux"]) for x in c)
    cat = {k: np.concatenate([x[k] for x in a]) for k in a[0]}
    lo, hi = mix["dist_kpc"]
    assert cat["dist"].min() >= lo and cat["dist"].max() <= hi
    assert (cat["rv"] >= mix["rv"][0]).all() and (cat["rv"] <= mix["rv"][1]).all()
    assert (cat["av"] >= 0).all()
    lack = ~cat["mask"][:, mix["missing_bands"][0]]
    assert abs(lack.mean() - mix["missing_share"]) < 0.05
    assert np.isnan(cat["flux"][lack][:, mix["missing_bands"]]).all()
    assert np.isfinite(cat["flux"][~lack]).all()
    snr = cat["flux"][~lack] / cat["err"][~lack]
    assert snr.min() > 0.5 * mix["snr"][0] and np.median(snr) < 2 * mix["snr"][1]
    assert (cat["plxe"] >= mix["plx_err_mas"][0]).all()
    assert (cat["plxe"] <= mix["plx_err_mas"][1]).all()
    pix = dmap.pixel(cat["coords"][:, 0], cat["coords"][:, 1])
    if mix["sky"] == "uniform":
        assert len(np.unique(pix)) > 0.5 * len(pix) or len(pix) < 3072
    else:
        for x in a:
            assert len(np.unique(dmap.pixel(x["coords"][:, 0],
                                            x["coords"][:, 1]))) == 1


def test_dust_map_has_3072_sightlines_on_bayestar_ladder():
    m = traffic.DustMap(1)
    assert m.av_mean.shape == (3072, 120)
    assert np.isclose(5 * np.log10(m.dists[0] * 100), 4.0)
    assert np.isclose(5 * np.log10(m.dists[-1] * 100), 19.0)
    theta, phi = traffic.pix_centres(16)
    pix = traffic.ang2pix_ring(16, theta, phi)
    np.testing.assert_array_equal(pix, np.arange(3072))
    assert (np.diff(m.av_mean, axis=1) >= 0).all()
    d, mean, std = m.query((np.array([10.0, 200.0]), np.array([5.0, -60.0])))
    assert mean.shape == (2, 120) and (std > 0).all()


def test_counting_functions_by_hand():
    # K2: 2 stars (8 and 5 bands) x 512 models, blocks of 256
    b, o = counts.screen_work([8, 5], 512, 8, 256)
    assert b == 4 * (3 * 8 * 512 + 512 + 2 * 2 + 2 * 21)
    assert o == 512 * (24 * 8 + 70) + 512 * (24 * 5 + 70) + 512 * 56
    pair, move, model = counts.fit_ops(8)
    assert pair == 8 * (23 + 126 + 11 + 34 + 41) + 55 + 222 + 4 + 144 + 17
    assert move == 6 * (34 * 8 + 7) and model == 16
    b, o = counts.fit_work([8], 1024, 27, 15)
    assert b == 4 * (27 * 1024 + 1024 + 15 * 1024)
    assert o == 1024 * (pair + model)
    t, by = counts.bound(3.35e12, 0)
    assert by == "bytes" and abs(t - 1.0) < 1e-12
    t, by = counts.bound(0, 67e12)
    assert by == "operations" and abs(t - 1.0) < 1e-12


def _star(mc, i, av, rv, dist, snr=1e6):
    c = mc[i].astype(float)
    sed = c[:, 0] + av * (c[:, 1] + rv * c[:, 2])
    flux = 10 ** (-0.4 * sed) / dist ** 2
    return flux[None], flux[None] / snr


def test_reference_fit_recovers_a_noiseless_star():
    mc, _ = traffic.correlated_grid(2000, 8, seed=5)
    fit = dict(avlim=[0.0, 20.0], rvlim=[1.0, 8.0], rv_gauss=[3.32, 0.18])
    flux, err = _star(mc, 17, 0.8, 3.32, 1.7)
    F = ref.Fit(mc[[17]], flux, err, np.ones((1, 8), bool), fit)
    s, av, rv = F.brutus_fit()
    assert abs(s.item() - 1 / 1.7 ** 2) < 1e-6 * s.item()
    assert abs(av.item() - 0.8) < 1e-6 and abs(rv.item() - 3.32) < 1e-5
    C = ref.covariance(F.precision(av, rv), s)
    assert torch.linalg.eigvalsh(C).min() > 0


def test_reference_covariance_inverts_a_positive_precision():
    p = tuple(torch.tensor([x], dtype=torch.float64)
              for x in (4.0, 3.0, 2.0, 0.5, 0.2, 0.1))
    C = ref.covariance(p, torch.tensor([1.0], dtype=torch.float64))
    P = torch.tensor([[4.0, 0.5, 0.2], [0.5, 3.0, 0.1], [0.2, 0.1, 2.0]],
                     dtype=torch.float64)
    torch.testing.assert_close(C[0], torch.linalg.inv(P), rtol=1e-12,
                               atol=1e-12)


def test_reference_priors_by_hand():
    # the parallax prior is a normalised Gaussian
    v = ref.parallax_lnprior(torch.tensor(1.0, dtype=torch.float64),
                             torch.tensor(1.5, dtype=torch.float64),
                             torch.tensor(0.5, dtype=torch.float64))
    assert abs(v.item() - (-0.5 * (1.0 + math.log(2 * math.pi * 0.25)))) \
        < 1e-12
    # the Galactic prior at the Sun's distance toward the pole is finite
    # and grows as d**2 close by (the volume term)
    d = torch.tensor([0.01, 0.02], dtype=torch.float64)
    z = torch.zeros(2, dtype=torch.float64)
    g = ref.gal_lnprior(d, z, z + 90.0, z - 0.2, z + 9.5)
    assert abs((g[1] - g[0]).item() - 2 * math.log(2)) < 0.05
    # the grid prior: the Kroupa slope over mini
    lab = np.zeros(3, [("mini", float), ("feh", float), ("loga", float)])
    lab["mini"] = [1.0, 2.0, 3.0]
    lnp = ref.grid_lnprior(lab)
    assert abs(lnp[1] - lnp[0] - (-2.3 * math.log(2))) < 1e-12


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -12, 3.14159265])
    r = ref.rnd(x, "tf32")
    assert r[0].item() == 1.0 + 2 ** -10
    assert r[1].item() == 1.0
    assert abs(r[2].item() - 3.14159265) < 2 ** -9


FIT = dict(avlim=[0.0, 20.0], rvlim=[1.0, 8.0], rv_gauss=[3.32, 0.18],
           screen_k=512, screen_block=256, n_sel_max=64)


def test_converged_fit_reaches_a_brute_force_minimum():
    """`converged` finds the least objective that a dense (Av, Rv) grid
    with the scale in closed form finds, from a far start."""
    mc, _ = traffic.correlated_grid(2000, 8, seed=5)
    flux, err = _star(mc, 17, 1.3, 3.0, 1.2, snr=30)
    flux = flux * (1 + np.random.default_rng(1).normal(0, 1 / 30, 8))
    F = ref.Fit(mc[[17]], flux, err, np.ones((1, 8), bool), FIT)
    one = lambda x: torch.tensor([x], dtype=torch.float64)
    J = ref.converged(F, [(one(0.3), one(0.2), one(4.5))])
    av, rv = torch.meshgrid(torch.linspace(0.8, 1.8, 201, dtype=torch.float64),
                            torch.linspace(2.0, 4.0, 201, dtype=torch.float64),
                            indexing="ij")
    av, rv = av.reshape(-1), rv.reshape(-1)
    G = ref.Fit(np.repeat(mc[[17]], len(av), 0), np.repeat(flux, len(av), 0),
                np.repeat(err, len(av), 0), np.ones((len(av), 8), bool), FIT)
    m = torch.exp(ref.FLUXFAC * (G.c0 + av[:, None] * (G.c1 + rv[:, None]
                                                        * G.c2)))
    s = (m * G.flux * G.w).sum(-1) / (m * m * G.w).sum(-1)
    assert J.item() <= ref.objective(G, s, av, rv).min().item() + 1e-6
    # and never above its start
    s0, a0, r0 = F.brutus_fit()
    assert ref.converged(F, [(s0, a0, r0)]).item() <= \
        ref.objective(F, s0, a0, r0).item()


def test_screen_puts_the_true_models_block_first():
    """A star made from one model (at high SNR) finds that model's block
    first in the screen's shortlist of two blocks."""
    mc, labels = traffic.correlated_grid(4096, 8, seed=6)
    grid = ref.Grid(mc, labels, "f64", "cpu")
    flux, err = _star(mc, 1000, 0.7, 3.32, 0.9, snr=1e4)
    plx = torch.tensor(1 / 0.9, dtype=torch.float64)
    idx = ref.screen_shortlist(grid, flux, err, np.ones((1, 8), bool), plx,
                               torch.tensor(0.01, dtype=torch.float64), FIT,
                               256, 2)
    assert idx.shape == (512,)
    assert 1000 in set(idx[:256].tolist())


@pytest.mark.parametrize("screen_k", [512, 0])
def test_posterior_and_draws_follow_the_weights(screen_k):
    """The reference's posterior of a star (on a screened shortlist, or
    every model): selected models with finite log-posteriors and an
    evidence that is their log-sum-exp; its draws take models in
    proportion to their weights."""
    mc, labels = traffic.correlated_grid(4096, 8, seed=6)
    dmap = traffic.DustMap(3)
    grid = ref.Grid(mc, labels, "f64", "cpu")
    flux, err = _star(mc, 1000, 0.7, 3.32, 0.9, snr=20)
    ladder, mean, std = ref.uniform_ladder(*dmap.query((np.array([30.0]),
                                                        np.array([10.0]))))
    t = lambda x: torch.as_tensor(np.asarray(x, float))
    stars = dict(flux=flux, err=err, mask=np.ones((1, 8), bool),
                 l=t([30.0]), b=t([10.0]), plx=t([1 / 0.9]), plxe=t([0.1]),
                 ladder=ladder, mean=t(mean), std=t(std), avlim=FIT["avlim"],
                 rvlim=FIT["rvlim"])
    gen = torch.Generator().manual_seed(4)
    p, = ref.posterior(grid, stars, dict(FIT, screen_k=screen_k), 50,
                       gen=gen)
    lnp = p["lnp"][p["keep"]]
    assert 1 < len(lnp) <= FIT["n_sel_max"]
    assert abs(torch.logsumexp(lnp, 0).item() - p["logz"].item()) < 1e-9
    d, = ref.draw([p], 20000, gen)
    w = torch.softmax(p["lnp"], 0).numpy()
    top = int(np.argmax(w))
    share = np.mean(d["model_idx"] == p["idx"][top].item())
    assert abs(share - w[top]) < 4 * math.sqrt(w[top] * (1 - w[top]) / 20000)
    assert np.isfinite(d["logwt"]).all() and (d["dist"] > 0).all()
