"""The rest of the port's foundations against `brutus_tpu`: the
photometric transforms, stacked 3x3 algebra, pdfs, quantiles and MVN
draws of `utils`, `priors.parallax_to_scale` and
`priors.dust_lnprior_interp`, `dustmap.write_bayestar_file`, and the
grid, offsets, results, registry and FITS readers of `io` (the cases of
`tests/test_utils.py`, `test_priors.py` and `test_io.py`, without the
`real_orion` catalogue, which is not in the repository).

Float64 unless a case says otherwise.  No case touches the network: the
registry's download is replaced by a local stand-in.
"""

import os
import pickle

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from scipy import stats

from brutus_tpu import utils as JU, priors as JP, io as JIO
from brutus_tpu.config import DustPriorConfig
from brutus_tpu.dustmap import Bayestar as JBayestar
from brutus_tpu.healpix import lb2pix
from brutus_tpu_torch import utils as TU, priors as TP, io as TIO
from brutus_tpu_torch.dustmap import Bayestar, write_bayestar_file

T = torch.as_tensor


def _spd(rng, n, scale=3.0):
    A = rng.normal(size=(n, 3, 3))
    return A @ np.swapaxes(A, -1, -2) + scale * np.eye(3)


def test_photometric_transforms_match():
    """magnitude <-> inv_magnitude and luptitude <-> inv_luptitude round
    trips (rtol 1e-12 / 1e-10, `test_utils.py`), each equal to the JAX
    function's value at rtol 1e-12, and `add_mag`."""
    rng = np.random.default_rng(7)
    phot = rng.uniform(1e-8, 1e-3, size=(5, 9))
    err = phot * 0.05
    mag, magerr = TU.magnitude(T(phot), T(err))
    p2, e2 = TU.inv_magnitude(mag, magerr)
    np.testing.assert_allclose(p2.numpy(), phot, rtol=1e-12)
    np.testing.assert_allclose(e2.numpy(), err, rtol=1e-12)
    jp, je = JU.inv_magnitude(np.asarray(mag), np.asarray(magerr))
    np.testing.assert_allclose(p2.numpy(), np.asarray(jp), rtol=1e-12)
    np.testing.assert_allclose(e2.numpy(), np.asarray(je), rtol=1e-12)
    sky = 1e-6
    lm, le = TU.luptitude(T(phot), T(err), skynoise=sky)
    jm, jle = JU.luptitude(phot, err, skynoise=sky)
    np.testing.assert_allclose(lm.numpy(), np.asarray(jm), rtol=1e-12)
    np.testing.assert_allclose(le.numpy(), np.asarray(jle), rtol=1e-12)
    p3, e3 = TU.inv_luptitude(lm, le, skynoise=sky)
    np.testing.assert_allclose(p3.numpy(), phot, rtol=1e-10)
    np.testing.assert_allclose(e3.numpy(), err, rtol=1e-10)
    expect = -2.5 * np.log10(10 ** (-0.4 * 5.0) + 10 ** (-0.4 * 6.0))
    np.testing.assert_allclose(float(TU.add_mag(5.0, 6.0)), expect,
                               rtol=1e-12)
    np.testing.assert_allclose(
        TU.add_mag(T(phot), T(phot + 1), 0.3, 0.7).numpy(),
        np.asarray(JU.add_mag(phot, phot + 1, 0.3, 0.7)), rtol=1e-12)


STACKED = ("adjoint3", "inverse_transpose3", "inverse3", "inverse3_stable",
           "cholesky3", "cholesky3_stable", "is_psd3", "equilibrate3")


@pytest.mark.parametrize("name", STACKED)
def test_stacked_3x3_algebra_matches(name):
    """Each stacked 3x3 function equals the JAX package's on SPD,
    ill-scaled and indefinite matrices (rtol 1e-12 / atol 1e-12 where
    both are finite, the same NaNs and booleans), and `inverse3`
    equals numpy's inverse at rtol 1e-9 (`test_utils.py`)."""
    rng = np.random.default_rng(9)
    A = _spd(rng, 40, 0.1)
    A[:8] *= (np.array([1e6, 1.0, 1e-3])[None, :, None]
              * np.array([1e6, 1.0, 1e-3])[None, None, :])
    A[8:16] -= 10.0 * np.eye(3)
    got = getattr(TU, name)(T(A))
    want = getattr(JU, name)(jnp.asarray(A))
    if name == "equilibrate3":
        got, want = got[0], want[0]
    got, want = got.numpy(), np.asarray(want)
    if got.dtype == bool:
        np.testing.assert_array_equal(got, want)
        expect = np.array([np.all(np.linalg.eigvalsh(m) > 0) for m in A])
        np.testing.assert_array_equal(got, expect)
        return
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-12, atol=1e-12)
    if name == "inverse3":
        B = _spd(rng, 20)
        np.testing.assert_allclose(TU.inverse3(T(B)).numpy(),
                                   np.linalg.inv(B), rtol=1e-9, atol=1e-12)


def test_truncnorm_pdf_matches_scipy():
    """`truncnorm_pdf` against scipy at rtol 1e-9 / atol 1e-12
    (`test_utils.py::test_truncnorm_logpdf`), zero outside the cut."""
    rng = np.random.default_rng(10)
    a, b, loc, scale = -1.5, 2.0, 0.3, 1.7
    x = rng.uniform(-3, 4, size=200)
    got = TU.truncnorm_pdf(T(x), a, b, loc=loc, scale=scale).numpy()
    np.testing.assert_allclose(got, stats.truncnorm.pdf(x, a, b, loc=loc,
                                                        scale=scale),
                               rtol=1e-9, atol=1e-12)


def test_quantile_matches():
    """Unweighted quantiles equal numpy's percentiles, weighted ones the
    JAX package's interpolated weighted CDF (rtol 1e-12), and equal
    weights approximate the unweighted quantiles within 0.02
    (`test_utils.py::test_quantile_weighted`)."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=1000)
    q = np.array([0.1, 0.5, 0.9])
    np.testing.assert_allclose(TU.quantile(T(x), q).numpy(),
                               np.percentile(x, 100 * q), rtol=1e-12)
    w = rng.uniform(0.1, 2.0, 1000)
    np.testing.assert_allclose(TU.quantile(T(x), q, weights=T(w)).numpy(),
                               np.asarray(JU.quantile(x, q, weights=w)),
                               rtol=1e-12)
    np.testing.assert_allclose(
        TU.quantile(T(x), q, weights=T(np.ones_like(x))).numpy(),
        np.percentile(x, 100 * q), atol=2e-2)


def test_sample_multivariate_normal_moments():
    """40000 draws from each of 4 Gaussians (the reference's `(d, size,
    N)` layout) have their means within 0.05 and covariances within
    0.08 (`test_utils.py`); a generator with the same seed gives the
    same draws."""
    rng = np.random.default_rng(12)
    N, d, S = 4, 3, 40000
    mean = rng.normal(size=(N, d))
    A = rng.normal(size=(N, d, d)) * 0.3
    cov = A @ np.swapaxes(A, -1, -2) + 0.2 * np.eye(d)
    g = lambda: torch.Generator().manual_seed(0)
    samps = TU.sample_multivariate_normal(g(), T(mean), T(cov), size=S)
    assert samps.shape == (d, S, N)
    s = samps.numpy()
    for i in range(N):
        np.testing.assert_allclose(s[:, :, i].mean(axis=1), mean[i],
                                   atol=0.05)
        np.testing.assert_allclose(np.cov(s[:, :, i]), cov[i], atol=0.08)
    again = TU.sample_multivariate_normal(g(), T(mean), T(cov), size=S)
    assert torch.equal(samps, again)


def test_draw_sar_bounds():
    """Draws of `(s, Av, Rv)` respect the bounds and centre on the
    untruncated Av within 0.15 (`test_utils.py::test_draw_sar_bounds`)."""
    rng = np.random.default_rng(13)
    N = 8
    scales = np.abs(rng.normal(1.0, 0.1, N))
    avs = rng.uniform(0.5, 1.5, N)
    rvs = rng.uniform(2.5, 4.0, N)
    cov = np.tile(np.diag([0.05, 0.3, 0.5]) ** 2, (N, 1, 1))
    s, a, r = TU.draw_sar(torch.Generator().manual_seed(1), T(scales),
                          T(avs), T(rvs), T(cov), ndraws=256,
                          avlim=(0.0, 2.0), rvlim=(1.0, 5.0))
    s, a, r = s.numpy(), a.numpy(), r.numpy()
    assert s.shape == (N, 256)
    assert (s >= 0).all()
    assert (a >= 0).all() and (a <= 2.0).all()
    assert (r >= 1.0).all() and (r <= 5.0).all()
    np.testing.assert_allclose(a.mean(axis=1), avs, atol=0.15)


@pytest.mark.parametrize("dim_prior", [False, True])
def test_phot_loglike_matches(dim_prior):
    """The masked chi-square log-likelihood equals the JAX package's at
    rtol 1e-10, and without the dimensionality prior the manual formula
    (`test_utils.py::test_phot_loglike_matches_manual`)."""
    rng = np.random.default_rng(14)
    data = rng.uniform(1e-7, 1e-5, 9)
    err = data * 0.05
    mask = np.ones(9, bool)
    mask[3] = False
    models = rng.uniform(1e-7, 1e-5, size=(12, 9))
    got = TU.phot_loglike(T(data), T(err), T(mask), T(models),
                          dim_prior=dim_prior).numpy()
    want = np.asarray(JU.phot_loglike(jnp.asarray(data), jnp.asarray(err),
                                      jnp.asarray(mask),
                                      jnp.asarray(models),
                                      dim_prior=dim_prior))
    np.testing.assert_allclose(got, want, rtol=1e-10)
    if not dim_prior:
        m = mask
        chi2 = np.sum((data[m] - models[:, m]) ** 2 / err[m] ** 2, axis=1)
        expect = -0.5 * (chi2 + m.sum() * np.log(2 * np.pi)
                         + np.sum(np.log(err[m] ** 2)))
        np.testing.assert_allclose(got, expect, rtol=1e-10)


def _square(x, k=2.0):
    return k * x * x


def test_function_wrapper_pickles_and_reraises(capsys):
    """The bound closure survives pickling, calls through, and re-raises
    a failure after printing its inputs."""
    f = pickle.loads(pickle.dumps(TU.function_wrapper(_square, [3.0],
                                                      name="sq")))
    assert f(2.0) == 12.0
    with pytest.raises(TypeError):
        f("x")
    assert "sq function" in capsys.readouterr().out


def test_parallax_to_scale_matches():
    """Scale-space moments above the SNR gate, and the 1e-20 / 1e20
    stand-ins below it or for missing values, equal the JAX package's
    (rtol 1e-12)."""
    p = np.array([1.0, 0.3, 2.0, np.nan, 1.0])
    e = np.array([0.05, 0.1, 0.1, 0.1, np.nan])
    got = TP.parallax_to_scale(T(p), T(e))
    want = JP.parallax_to_scale(jnp.asarray(p), jnp.asarray(e))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
    assert got[0][1].item() == 1e-20 and got[1][3].item() == 1e20


def test_dust_lnprior_interp_matches():
    """On a non-uniform ladder, `np.interp`'s interpolation of the
    profile gives the JAX package's log-prior (rtol 1e-12) and the
    direct formula (rtol 1e-8, `test_priors.py::test_dust_lnprior`);
    an uncovered sightline gives 0."""
    av_dist = np.geomspace(0.1, 10, 20)
    av_mean = np.linspace(0, 2, 20)
    av_std = np.linspace(0.05, 0.3, 20)
    dists = np.array([0.05, 0.5, 2.0, 20.0])
    avs = np.array([0.1, 0.2, 0.5, 2.2])
    cfg = DustPriorConfig()
    args = [T(x) for x in (dists, avs, av_dist, av_mean, av_std)]
    got = TP.dust_lnprior_interp(*args, cfg).numpy()
    want = np.asarray(JP.dust_lnprior_interp(
        *[jnp.asarray(x) for x in (dists, avs, av_dist, av_mean, av_std)],
        cfg))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    m = np.interp(dists, av_dist, av_mean)
    e = np.sqrt(np.interp(dists, av_dist, av_std) ** 2 + cfg.scatter ** 2)
    expect = -0.5 * ((avs - m) ** 2 / e ** 2 + np.log(2 * np.pi * e ** 2))
    np.testing.assert_allclose(got, expect, rtol=1e-8)
    args[3] = T(np.full(20, np.nan))
    assert (TP.dust_lnprior_interp(*args, cfg) == 0).all()


def test_bayestar_roundtrip(tmp_path):
    """A map written by the port's `write_bayestar_file` reads back
    through both packages' `Bayestar` with the same profiles (float32
    storage, rtol 1e-6) and NaN for an uncovered sightline
    (`test_priors.py::test_bayestar_roundtrip`)."""
    rng = np.random.default_rng(15)
    nside = 64
    l = np.array([30.0, 120.0, 250.0])
    b = np.array([5.0, -10.0, 40.0])
    pix = lb2pix(nside, l, b)
    dists = np.linspace(0.1, 10.0, 12)
    av_mean = rng.uniform(0, 2, size=(3, 12)).cumsum(axis=1) / 6
    av_std = rng.uniform(0.05, 0.3, size=(3, 12))
    path = str(tmp_path / "dust.h5")
    write_bayestar_file(path, np.full(3, nside), pix, dists, av_mean, av_std)
    for cls in (Bayestar, JBayestar):
        d, m, s = cls(path).query((l[1], b[1]))
        np.testing.assert_allclose(d, dists)
        np.testing.assert_allclose(m, av_mean[1], rtol=1e-6)
        np.testing.assert_allclose(s, av_std[1], rtol=1e-6)
        _, m2, _ = cls(path).query((200.0, -60.0))
        assert np.all(np.isnan(m2))


def test_load_offsets(tmp_path):
    """Zero-points by filter, 1 for absent filters, duplicates an error,
    as the JAX package reads them (`test_io.py::test_load_offsets`)."""
    path = str(tmp_path / "offsets.txt")
    with open(path, "w") as f:
        f.write("PS_g 1.02\nPS_r 0.98\n2MASS_J 1.01\n")
    filters = ["PS_g", "PS_r", "PS_i", "2MASS_J"]
    offs = TIO.load_offsets(path, filters=filters, verbose=False)
    np.testing.assert_allclose(offs, [1.02, 0.98, 1.0, 1.01])
    np.testing.assert_array_equal(
        offs, JIO.load_offsets(path, filters=filters, verbose=False))
    with open(path, "a") as f:
        f.write("PS_g 1.05\n")
    with pytest.raises(ValueError):
        TIO.load_offsets(path, filters=filters, verbose=False)


def test_results_writer_cursor(tmp_path):
    """The cursor is the first unwritten row; `resume=True` reopens the
    file at it without clearing it (`test_io.py::
    test_results_writer_cursor`)."""
    path = str(tmp_path / "res")
    w = TIO.ResultsWriter(path, n_data=5, n_draws=4)
    assert w.cursor == 0
    out = dict(model_idx=np.ones((2, 4), np.int32),
               scale=np.ones((2, 4)), av=np.zeros((2, 4)),
               rv=np.zeros((2, 4)), cov_sar=np.zeros((2, 4, 3, 3)),
               lnprob=np.zeros((2, 4)), log_evidence=np.zeros(2),
               chi2min=np.zeros(2), ndim=np.ones(2, np.int16),
               dist=np.ones((2, 4)), red=np.zeros((2, 4)),
               dred=np.zeros((2, 4)), logwt=np.zeros((2, 4)))
    w.write_batch(0, out)
    assert w.cursor == 2
    w.close()
    w2 = TIO.ResultsWriter(path, n_data=5, n_draws=4, resume=True)
    assert w2.cursor == 2
    w2.close()
    assert JIO.ResultsWriter(path, 5, 4, resume=True).cursor == 2
    res = TIO.load_results(path)
    assert (res["model_idx"][:2] == 1).all()
    assert (res["model_idx"][2:] == -99).all()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_grid_file_roundtrip(tmp_path, writer):
    """A grid written by either package's `save_models` reads back
    through both `load_models` alike: coefficients, labels and label
    mask, the main-sequence / post-main-sequence split at eep 454 and
    the binary cut on `smf`."""
    rng = np.random.default_rng(16)
    M, filters = 40, ["PS_g", "PS_r", "2MASS_J"]
    models = rng.uniform(0, 10, (M, 3, 3)).astype(np.float32)
    lab = np.zeros(M, [("mini", float), ("feh", float), ("eep", float),
                       ("smf", float)])
    lab["mini"] = rng.uniform(0.5, 2, M)
    lab["feh"] = rng.uniform(-1, 0.3, M)
    lab["eep"] = rng.uniform(300, 600, M)
    lab["smf"] = np.where(np.arange(M) % 4 == 0, 0.5, 0.0)
    par = np.zeros(M, [("logt", float)])
    par["logt"] = rng.uniform(3.5, 4.0, M)
    path = str(tmp_path / "grid.h5")
    save = TIO.save_models if writer == "port" else JIO.save_models
    save(path, models, lab, filters, parameters=par)
    for kw in (dict(), dict(include_postms=False),
               dict(include_ms=False), dict(include_binaries=True)):
        kw = dict(kw, filters=["PS_g", "2MASS_J", "PS_z"], verbose=False,
                  labels=["mini", "feh", "eep", "smf", "logt", "Mr"])
        got = TIO.load_models(path, **kw)
        want = JIO.load_models(path, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1].dtype == want[1].dtype and got[2].dtype == want[2].dtype
        for n in got[1].dtype.names:
            np.testing.assert_array_equal(got[1][n], want[1][n])
            np.testing.assert_array_equal(got[2][n], want[2][n])
    with pytest.raises(ValueError):
        TIO.load_models(path, include_ms=False, include_postms=False,
                        verbose=False)


def test_fetch_registry_and_errors():
    """The registry names every file with its Dataverse DOI and SHA256,
    the same as the JAX package's, and an unknown name raises."""
    assert TIO.DATA_REGISTRY == JIO.DATA_REGISTRY
    assert "grid_mist_v9.h5" in TIO.DATAVERSE_DOIS
    for name, (doi, sha) in TIO.DATA_REGISTRY.items():
        assert doi.startswith("10.7910/DVN/")
        assert len(sha) == 64 and int(sha, 16) >= 0
    with pytest.raises(KeyError):
        TIO.fetch("nonexistent.h5")
    with pytest.raises(ValueError):
        TIO.fetch_grids(grid="mist_v1")
    assert isinstance(TIO.data_dir(), str)


def test_fetch_cache_hit_download_and_symlink(tmp_path, monkeypatch):
    """A cached file with the right SHA256 is served and symlinked into
    the target directory; a corrupt cache is downloaded again, and a
    download that keeps failing its hash raises after `retries`
    attempts.  The download is a local stand-in (`_download` replaced),
    so nothing leaves the machine."""
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setenv(TIO.DATA_DIR_ENV, str(cache))
    payload = b"synthetic offsets file\n"
    name = "offsets_mist_v8.txt"
    (cache / name).write_bytes(payload)
    good = TIO.sha256sum(cache / name)
    monkeypatch.setitem(TIO.DATA_REGISTRY, name,
                        ("10.7910/DVN/L7D1FY/QTNKKN", good))
    served = []

    def download(url, dest, verbose=True):
        served.append(url)
        with open(dest, "wb") as f:
            f.write(payload if len(served) == 1 else b"bad")

    monkeypatch.setattr(TIO, "_download", download)
    target = tmp_path / "work"
    out = TIO.fetch(name, str(target), verbose=False)
    assert os.path.islink(out) and open(out, "rb").read() == payload
    assert TIO.fetch_offsets(str(target)) == out
    assert served == []
    (cache / name).write_bytes(b"corrupted")
    assert TIO.fetch(name, verbose=False) == str(cache / name)
    assert served[0].endswith("10.7910/DVN/L7D1FY/QTNKKN")
    assert (cache / name).read_bytes() == payload
    (cache / name).write_bytes(b"corrupted")
    with pytest.raises(RuntimeError, match="failed to fetch"):
        TIO.fetch(name, verbose=False, retries=2)
    assert len(served) == 3
    assert not (cache / f"{name}.part").exists()


def _fits_bintable(path, rows):
    """A minimal FITS file: an empty primary HDU and one BINTABLE of
    columns J (int32), E (float32), 3D (3 x float64) and 4A."""
    def header(cards):
        text = "".join(f"{c:<80}" for c in cards + ["END"])
        return text.encode("ascii").ljust(-(-len(text) // 2880) * 2880)

    fmt = lambda k, v: f"{k:<8}= {v:>20}"
    prim = header([fmt("SIMPLE", "T"), fmt("BITPIX", 8), fmt("NAXIS", 0)])
    dt = np.dtype([("ID", ">i4"), ("FLUX", ">f4"), ("POS", ">f8", (3,)),
                   ("NAME", "S4")])
    data = np.zeros(len(rows), dt)
    for i, r in enumerate(rows):
        data[i] = r
    ext = header([fmt("XTENSION", "'BINTABLE'"), fmt("BITPIX", 8),
                  fmt("NAXIS", 2), fmt("NAXIS1", dt.itemsize),
                  fmt("NAXIS2", len(rows)), fmt("PCOUNT", 0),
                  fmt("GCOUNT", 1), fmt("TFIELDS", 4),
                  fmt("TTYPE1", "'ID'"), fmt("TFORM1", "'J'"),
                  fmt("TTYPE2", "'FLUX'"), fmt("TFORM2", "'E'"),
                  fmt("TTYPE3", "'POS'"), fmt("TFORM3", "'3D'"),
                  fmt("TTYPE4", "'NAME'"), fmt("TFORM4", "'4A'")])
    body = data.tobytes()
    with open(path, "wb") as f:
        f.write(prim + ext + body.ljust(-(-len(body) // 2880) * 2880,
                                        b"\0"))
    return data


def test_read_fits_table_matches(tmp_path):
    """A binary table reads back column by column, the same array as the
    JAX package's reader."""
    path = str(tmp_path / "cat.fits")
    data = _fits_bintable(path, [(1, 2.5, (0.1, 0.2, 0.3), b"ab"),
                                 (-7, -1.0, (1.0, 2.0, 3.0), b"wxyz")])
    got = TIO.read_fits_table(path)
    want = JIO.read_fits_table(path)
    assert got.dtype == want.dtype == data.dtype
    for n in data.dtype.names:
        np.testing.assert_array_equal(got[n], data[n])
        np.testing.assert_array_equal(got[n], want[n])
