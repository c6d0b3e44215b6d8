"""The port's photometric offsets (`brutus_tpu_torch.offsets`) and binned
distance-reddening PDFs (`brutus_tpu_torch.pdf`) against `brutus_tpu`,
on the set-ups of `tests/test_applications.py`.

The model fluxes and leave-one-band-out weights are held against JAX in
float64; the bootstrap draws from other random streams than JAX's, so
`photometric_offsets` is held against the injected offset.  The binned
PDFs are float32 (as JAX's): they are held against JAX's within
float32 rounding, and the regenerated mode on the same draws on both
sides (`draw_sar` replaced in the test by a table of draws).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from brutus_tpu import offsets as JO
from brutus_tpu import pdf as JP
from brutus_tpu.ops.sed import get_seds as j_get_seds
from brutus_tpu_torch import offsets as TO
from brutus_tpu_torch import pdf as TP

CPU = "cpu"


def _offsets_setup(n_filt=6, seed=17):
    """`test_photometric_offsets`' catalogue: 40 stars whose data are
    their first draw's model, band 0 made 10% fainter (ratio ~1.1)."""
    rng = np.random.default_rng(seed)
    n_model, n_obj, n_samp = 200, 40, 20
    mc = np.stack([rng.uniform(8, 14, (n_model, n_filt)),
                   rng.uniform(0.4, 1.1, (n_model, n_filt)),
                   rng.uniform(0.05, 0.2, (n_model, n_filt))], axis=-1)
    idxs = rng.integers(0, n_model, (n_obj, n_samp))
    reds = rng.uniform(0.1, 0.8, (n_obj, n_samp))
    dreds = rng.uniform(2.8, 3.8, (n_obj, n_samp))
    dists = rng.uniform(0.8, 1.5, (n_obj, n_samp))
    sed0 = (mc[idxs[:, 0], :, 0]
            + reds[:, :1] * (mc[idxs[:, 0], :, 1]
                             + dreds[:, :1] * mc[idxs[:, 0], :, 2]))
    phot = 10 ** (-0.4 * sed0) / dists[:, :1] ** 2
    phot[:, 0] /= 1.1
    err = np.abs(phot) * 0.05
    mask = np.ones((n_obj, n_filt), bool)
    return phot, err, mask, mc, idxs, reds, dreds, dists


def test_model_fluxes_and_band_weights_match_jax():
    """The draws' model fluxes within relative 1e-10 of JAX's `get_seds`
    path, and every band's leave-one-band-out weights (one band missing
    on one star; with and without the dimensionless prior) within
    relative 1e-10 where they exceed 1e-12 (below that, within 1e-12:
    the log-likelihoods reach -1e8, whose float64 rounding moves the
    far tail)."""
    phot, err, mask, mc, idxs, reds, dreds, dists = _offsets_setup()
    mask[3, 2] = False
    n_obj, n_samp = idxs.shape
    got = TO._model_fluxes(mc, idxs, reds, dreds, dists,
                           torch.device(CPU)).numpy()
    want = np.asarray(j_get_seds(
        jnp.asarray(mc[idxs.ravel()]), av=jnp.asarray(reds.ravel()),
        rv=jnp.asarray(dreds.ravel()), return_flux=True))
    want = (want / dists.ravel()[:, None] ** 2).reshape(got.shape)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    t = torch.as_tensor
    for band in range(phot.shape[1]):
        for dim_prior in (True, False):
            w = TO._band_weights(t(phot), t(err), t(mask), t(want), band,
                                 dim_prior).numpy()
            jw = JO._band_weights(phot, err, mask, want, band, dim_prior)
            np.testing.assert_allclose(w, jw, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n", [1, 2, 7, 8, 150])
def test_median_averages_the_two_middle_values(n):
    """`_median` is `jnp.median` on odd and even counts (`torch.median`
    takes the lower middle value), along either axis."""
    x = np.random.default_rng(n).normal(size=(5, n))
    np.testing.assert_array_equal(
        TO._median(torch.as_tensor(x), 1).numpy(),
        np.asarray(jnp.median(x, axis=1)))
    np.testing.assert_array_equal(
        TO._median(torch.as_tensor(x.T), 0).numpy(),
        np.asarray(jnp.median(x.T, axis=0)))


def test_draw_samples_follow_the_weights():
    """The inverse-CDF bootstrap draw: no sample of zero weight is ever
    drawn, and each object's draws follow its weights (chi-square over
    20,000 draws per object)."""
    r = np.random.default_rng(2)
    wt = r.uniform(0, 1, (4, 6)) * (r.uniform(size=(4, 6)) > 0.4)
    wt[:, 0] = 0.0
    wt[1] = [0, 0, 0, 0, 0, 1.0]
    wt /= wt.sum(1, keepdims=True)
    g = torch.Generator().manual_seed(0)
    ridx = torch.arange(4).repeat_interleave(20000).view(1, -1)
    midx = TO._draw_samples(torch.as_tensor(wt), ridx, g).numpy()[0]
    for j in range(4):
        counts = np.bincount(midx[ridx[0].numpy() == j], minlength=6)
        assert (counts[wt[j] == 0] == 0).all()
        exp = 20000 * wt[j][wt[j] > 0]
        chi2 = ((counts[wt[j] > 0] - exp) ** 2 / exp).sum()
        assert chi2 < 25.0, (j, counts, exp)


def test_photometric_offsets_recovers_injected_offset():
    """`photometric_offsets` finds `test_photometric_offsets`' injected
    1.1 in band 0 and 1 elsewhere, as JAX's does on the same data; with
    a per-star selection, old offsets, `mask_fit` off in one band and
    the Gaussian prior combination, the same counts and ratios within
    the bootstrap errors."""
    phot, err, mask, mc, idxs, reds, dreds, dists = _offsets_setup()
    args = (phot, err, mask, mc, idxs, reds, dreds, dists)
    ratios, ratios_err, nratio = TO.photometric_offsets(
        *args, Nmc=40, verbose=False, device=CPU)
    jr, jre, jn = JO.photometric_offsets(*args, Nmc=40, verbose=False)
    assert nratio.min() == len(phot)
    np.testing.assert_array_equal(nratio, jn)
    assert abs(ratios[0] - 1.1) < 0.05
    np.testing.assert_allclose(ratios[1:], 1.0, atol=0.06)
    np.testing.assert_allclose(ratios, jr, atol=0.01)
    sel = np.arange(len(phot)) % 4 != 0
    kw = dict(sel=sel, old_offsets=np.r_[1.05, np.ones(5)],
              mask_fit=np.r_[True, False, np.ones(4, bool)], Nmc=40,
              prior_mean=np.ones(6), prior_std=np.full(6, 0.5),
              verbose=False)
    got = TO.photometric_offsets(*args, device=CPU, **kw)
    want = JO.photometric_offsets(*args, **kw)
    np.testing.assert_array_equal(got[2], want[2])
    # Band 1 without its leave-one-out weights draws every sample alike:
    # its bootstrap spreads by ~0.6, so the two streams agree within
    # their errors there.
    assert (np.abs(got[0] - want[0])
            <= 0.01 + 3.0 * np.hypot(got[1], want[1])).all()
    assert np.abs(got[0] - want[0])[[0, 2, 3, 4, 5]].max() < 0.01


def _draws(n_obj=5, n_samp=500, seed=1):
    rng = np.random.default_rng(seed)
    dists = rng.uniform(0.5, 2.0, (n_obj, 1)) * np.exp(
        rng.normal(0, 0.05, (n_obj, n_samp)))
    reds = np.abs(rng.normal(0.8, 0.1, (n_obj, n_samp)))
    dreds = rng.uniform(2.5, 4.0, (n_obj, n_samp))
    return dists, reds, dreds


PDF_CASES = {
    "default": {},
    "ebv": dict(ebv=True),
    "cdf": dict(cdf=True),
    "parallax": dict(parallaxes=np.array([1.0, 0.5, np.nan, 2.0, 0.8]),
                     parallax_errors=np.array([0.1, 0.01, 0.1, 0.5, 0.0])),
    "wide_smoothing": dict(smooth=(0.5, 0.9), bins=(40, 20)),
    "radius_past_axis": dict(smooth=(30, 2.0), bins=(40, 20)),
}


@pytest.mark.parametrize("case", list(PDF_CASES))
@pytest.mark.parametrize("dist_type", TP.DIST_TYPES)
def test_bin_pdfs_saved_draws_match_jax(dist_type, case):
    """Saved draws: the edges equal JAX's, and the PDFs agree within
    float32 rounding (rtol 1e-6, atol 1e-7: JAX stores float32 between
    its passes, the port smooths in float64), for every `dist_type`,
    with `ebv`, `cdf`, per-star parallaxes (one missing, one with zero
    error), a wide smoothing, and a smoothing radius (120 bins) past
    its 40-bin axis, which scipy reflects again and again."""
    kw = dict(dict(bins=(80, 60)), **PDF_CASES[case])
    data = _draws()
    got, xe, ye = TP.bin_pdfs_distred(data, dist_type=dist_type,
                                      device=CPU, **kw)
    want, jxe, jye = JP.bin_pdfs_distred(data, dist_type=dist_type, **kw)
    np.testing.assert_array_equal(xe, jxe)
    np.testing.assert_array_equal(ye, jye)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_histogram_edge_rule_matches_numpy():
    """Draws on every edge, on the last edge, outside the span and NaN
    fall in `np.histogram2d`'s bins."""
    xe = np.linspace(4.0, 19.0, 16)
    ye = np.linspace(0.0, 6.0, 7)
    x = np.r_[xe, 3.9, 19.1, np.nan, 10.5, 19.0]
    y = np.r_[np.resize(ye, len(xe)), 0.5, 0.5, 0.5, 6.0, 6.0]
    want = np.histogram2d(x, y, bins=(xe, ye))[0]
    t = lambda v: torch.as_tensor(v)[None]
    got = TP._histogram(t(x), t(y), None, torch.as_tensor(xe),
                        torch.as_tensor(ye))[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_bin_pdfs_regenerated_mode_matches_jax(monkeypatch):
    """Regenerated draws: `draw_sar` replaced on both sides by the same
    table of draws, so both weight and bin the same draws by the
    Galactic and parallax priors (one star without a parallax); the
    port in blocks of two stars (a cut `BLOCK_ELEMENTS`)."""
    n_obj, n_sel, Nr = 3, 12, 40
    r = np.random.default_rng(9)
    scales = r.uniform(0.25, 1.0, (n_obj, n_sel))
    avs = r.uniform(0.2, 1.0, (n_obj, n_sel))
    rvs = r.uniform(2.8, 3.8, (n_obj, n_sel))
    covs = np.tile(np.diag([1e-4, 0.01, 0.04]), (n_obj, n_sel, 1, 1))
    table = [np.abs(v[..., None] + r.normal(0, sd, (n_obj, n_sel, Nr)))
             for v, sd in ((scales, 0.05), (avs, 0.1), (rvs, 0.2))]
    coord = np.tile([204.7, -19.2], (n_obj, 1))
    kw = dict(coord=coord, Nr=Nr, bins=(60, 40),
              parallaxes=np.array([1.0, np.nan, 0.7]),
              parallax_errors=np.array([0.1, 0.1, 0.1]))

    calls = {"j": 0, "t": 0}

    def j_draws(key, s, a, rv, cov, ndraws, avlim, rvlim):
        i = calls["j"]
        calls["j"] += 1
        assert ndraws == Nr and np.allclose(np.asarray(s), scales[i])
        return tuple(jnp.asarray(v[i]) for v in table)

    def t_draws(gen, s, a, rv, cov, ndraws, avlim, rvlim):
        n = len(s) // n_sel
        i = calls["t"]
        calls["t"] += n
        np.testing.assert_array_equal(s.numpy(),
                                      scales[i:i + n].ravel())
        return tuple(torch.as_tensor(v[i:i + n].reshape(-1, Nr))
                     for v in table)

    monkeypatch.setattr(JP, "draw_sar", j_draws)
    monkeypatch.setattr(TP, "draw_sar", t_draws)
    monkeypatch.setattr(TP, "BLOCK_ELEMENTS", 2 * (60 * 60 + n_sel * Nr))
    data = (scales, avs, rvs, covs)
    want = JP.bin_pdfs_distred(data, **kw)[0]
    got = TP.bin_pdfs_distred(data, device=CPU, **kw)[0]
    assert calls == {"j": n_obj, "t": n_obj}
    assert np.isfinite(got).all() and got.sum() > 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="coord"):
        TP.bin_pdfs_distred(data, device=CPU, Nr=Nr)


def test_bin_pdfs_regenerated_mode_draws():
    """Regenerated mode with the port's own `draw_sar`: finite,
    non-negative PDFs whose mass is the in-span share of the weighted
    draws (at most 1), and the same for any block size."""
    n_obj, n_sel = 2, 30
    r = np.random.default_rng(4)
    data = (r.uniform(0.25, 1.0, (n_obj, n_sel)),
            r.uniform(0.2, 1.0, (n_obj, n_sel)),
            r.uniform(2.8, 3.8, (n_obj, n_sel)),
            np.tile(np.diag([1e-4, 0.01, 0.04]), (n_obj, n_sel, 1, 1)))
    kw = dict(coord=np.tile([204.7, -19.2], (n_obj, 1)), Nr=50,
              bins=(60, 40), parallaxes=np.array([1.0, 0.7]),
              parallax_errors=np.array([0.1, 0.1]), device=CPU)
    pdfs = TP.bin_pdfs_distred(data, **kw)[0]
    assert pdfs.shape == (n_obj, 60, 40)
    assert np.isfinite(pdfs).all() and (pdfs >= 0).all()
    mass = pdfs.sum(axis=(1, 2))
    assert (mass > 0.5).all() and (mass < 1.0 + 1e-5).all()
