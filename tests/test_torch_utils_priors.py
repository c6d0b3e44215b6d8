"""The port's foundations (`brutus_tpu_torch` utils, coords, priors,
star-data hygiene, dust map, results file) against `brutus_tpu`.

Inputs are made with numpy from a seed and fed to both packages.  The
JAX side gets explicit float32 arrays where the comparison is in
float32 (conftest turns x64 on) and float64 where it is in float64.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from brutus_tpu import utils as JU, priors as JP, coords as JC
from brutus_tpu.config import FitConfig, GalPriorConfig, DustPriorConfig
from brutus_tpu.ops.optimize import prepare_star_data as j_prepare
from brutus_tpu.dustmap import (Bayestar as JBayestar, uniform_profile
                                as j_uniform, write_bayestar_file)
from brutus_tpu.fitting import default_grid_lnprior as j_grid_lnprior
from brutus_tpu.io import RESULTS_DATASETS as J_RESULTS, \
    DRAW_DATASETS as J_DRAWS, ResultsWriter as JWriter
from brutus_tpu_torch import utils as TU, priors as TP, coords as TC
from brutus_tpu_torch import config as TCFG
from brutus_tpu_torch.ops.optimize import prepare_star_data as t_prepare
from brutus_tpu_torch.dustmap import Bayestar as TBayestar, uniform_profile
from brutus_tpu_torch.convert import default_grid_lnprior
from brutus_tpu_torch.io import ResultsWriter as TWriter, \
    RESULTS_DATASETS, DRAW_DATASETS

F32 = np.float32
F64 = torch.float64


def _parts(rng, n, pd=True):
    """Six parts of random symmetric 3x3 matrices at mixed scales (the
    (s, Av, Rv) precisions span ~8 decades); `pd` adds a dominant
    diagonal so every matrix is positive definite."""
    a = rng.normal(size=(n, 3, 3))
    A = a @ np.swapaxes(a, 1, 2)
    A = A + 2.0 * np.eye(3) if pd else A - 1.5 * np.eye(3)
    s = 10.0 ** rng.uniform(-4, 4, (n, 3))
    A = A * s[:, :, None] * s[:, None, :]
    return tuple(A[:, i, j] for i, j in
                 ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)))


def _cmp(t_out, j_out, rtol, atol=0.0):
    for t, j in zip(t_out, j_out):
        np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_parts_toolkit_matches(dtype):
    """inverse / PD test / Cholesky on parts: same formulas, same order.
    Tolerance: 1e-4 relative in float32 (equilibrated 3x3 inverses of
    condition ~1e3 lose ~3 digits to rounding order), 1e-10 in float64."""
    rng = np.random.default_rng(0)
    p = tuple(x.astype(dtype) for x in _parts(rng, 500))
    rtol = 1e-4 if dtype == np.float32 else 1e-10
    tp = tuple(torch.as_tensor(x) for x in p)
    jp = tuple(jnp.asarray(x) for x in p)
    _cmp(TU.inverse3_sym_parts(tp), JU.inverse3_sym_parts(jp), rtol)
    _cmp(TU.cholesky3_parts(tp), JU.cholesky3_parts(jp), rtol)
    _cmp(TU.equilibrate3_parts(tp)[0], JU.equilibrate3_parts(jp)[0], rtol)
    q = tuple(x.astype(dtype) for x in _parts(rng, 500, pd=False))
    np.testing.assert_array_equal(
        TU.is_psd3_parts(tuple(torch.as_tensor(x) for x in q)).numpy(),
        np.asarray(JU.is_psd3_parts(tuple(jnp.asarray(x) for x in q))))
    np.testing.assert_array_equal(
        TU.sym3_from_parts(tp).numpy(), np.asarray(JU.sym3_from_parts(jp)))


def test_psd_repair_matches_on_definite_and_flags_indefinite():
    """PSD repair on float64 parts.  On positive-definite precisions the
    repair is the plain inverse and must agree to 1e-10; indefinite ones
    go through the escalating repair, whose fixed passes amplify rounding
    differences chaotically (README), so there only the repaired output's
    positive definiteness is compared."""
    rng = np.random.default_rng(1)
    for pd in (True, False):
        p = _parts(rng, 400, pd=pd)
        scale = rng.uniform(0.1, 2.0, 400)
        valid = rng.uniform(size=400) > 0.1
        t = TU.psd_repair_parts(tuple(torch.as_tensor(x) for x in p),
                                torch.as_tensor(scale),
                                torch.as_tensor(valid), 0.02, 8, 1e-30)
        j = JU.psd_repair_parts(tuple(jnp.asarray(x) for x in p),
                                jnp.asarray(scale), jnp.asarray(valid),
                                0.02, 8, mvn_eps=1e-30)
        if pd:
            _cmp(t, j, 1e-10)
        else:
            np.testing.assert_array_equal(
                TU.is_psd3_parts(t).numpy(),
                np.asarray(JU.is_psd3_parts(j)))


def test_stat_pdfs_and_mvn_transform():
    rng = np.random.default_rng(2)
    x = rng.uniform(0.1, 40.0, 300)
    df = rng.integers(1, 40, 300).astype(float)
    np.testing.assert_allclose(
        TU.chi2_logpdf(torch.as_tensor(x), torch.as_tensor(df)).numpy(),
        np.asarray(JU.chi2_logpdf(jnp.asarray(x), jnp.asarray(df))),
        rtol=1e-12)
    age = rng.uniform(-1.0, 15.0, 300)
    np.testing.assert_allclose(
        TU.truncnorm_logpdf(torch.as_tensor(age), -1.3, 2.0, 5.0, 3.0)
        .numpy(),
        np.asarray(JU.truncnorm_logpdf(jnp.asarray(age), -1.3, 2.0, 5.0,
                                       3.0)), rtol=1e-12)
    mean = rng.normal(size=(50, 3))
    L = np.tril(rng.normal(size=(50, 3, 3)))
    z = rng.normal(size=(50, 3, 7))
    np.testing.assert_allclose(
        TU.mvn3_transform(torch.as_tensor(mean), torch.as_tensor(L),
                          torch.as_tensor(z)).numpy(),
        np.asarray(JU.mvn3_transform(jnp.asarray(mean), jnp.asarray(L),
                                     jnp.asarray(z))), rtol=1e-12)
    phot = 10 ** rng.uniform(-6, -2, 40)
    for t, j in zip(TU.magnitude(phot, phot / 30),
                    JU.magnitude(phot, phot / 30)):
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-12)


def test_coords_constants_and_transform():
    """The numpy-built affine map equals the JAX package's exactly."""
    np.testing.assert_array_equal(TC._M, JC._M)
    np.testing.assert_array_equal(TC._T, JC._T)
    d = np.linspace(0.05, 20.0, 64)
    R, Z = TC.galactic_to_cylindrical(204.7, -19.2, torch.as_tensor(d))
    Rj, Zj = JC.galactic_to_cylindrical(204.7, -19.2, jnp.asarray(d))
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), rtol=1e-12)
    np.testing.assert_allclose(Z.numpy(), np.asarray(Zj), rtol=1e-12)


def test_grid_and_parallax_priors():
    rng = np.random.default_rng(3)
    m = rng.uniform(0.05, 3.0, 500)
    np.testing.assert_allclose(
        TP.imf_lnprior(torch.as_tensor(m)).numpy(),
        np.asarray(JP.imf_lnprior(jnp.asarray(m))), rtol=1e-12)
    Mr = rng.uniform(-6.0, 20.0, 500)     # beyond both table ends
    np.testing.assert_allclose(
        TP.ps1_MrLF_lnprior(torch.as_tensor(Mr)).numpy(),
        np.asarray(JP.ps1_MrLF_lnprior(jnp.asarray(Mr))), rtol=1e-12)
    s = rng.uniform(0.01, 4.0, 500)
    se = rng.uniform(0.001, 0.5, 500)
    for pm, pe in ((1.2, 0.1), (0.3, 0.2), (np.nan, np.nan), (1.0, 0.0)):
        np.testing.assert_allclose(
            TP.scale_parallax_lnprior(torch.as_tensor(s),
                                      torch.as_tensor(se),
                                      torch.tensor(pm, dtype=F64),
                                      torch.tensor(pe, dtype=F64)).numpy(),
            np.asarray(JP.scale_parallax_lnprior(
                jnp.asarray(s), jnp.asarray(se), jnp.asarray(pm),
                jnp.asarray(pe))), rtol=1e-12)
        np.testing.assert_allclose(
            TP.parallax_lnprior(torch.as_tensor(s),
                                torch.tensor(pm, dtype=F64),
                                torch.tensor(pe, dtype=F64)).numpy(),
            np.asarray(JP.parallax_lnprior(jnp.asarray(s), jnp.asarray(pm),
                                           jnp.asarray(pe))),
            rtol=1e-12)


@pytest.mark.parametrize("with_labels", [False, True])
def test_gal_lnprior_matches(with_labels):
    """float64: the same closed-form Galactic model, 1e-10 relative."""
    rng = np.random.default_rng(4)
    d = rng.uniform(0.05, 30.0, (6, 40))
    feh = rng.uniform(-2.5, 0.5, (6, 40)) if with_labels else None
    loga = rng.uniform(7.0, 10.2, (6, 40)) if with_labels else None
    cfg = GalPriorConfig(f_halo=0.01)
    for coord in ((204.7, -19.2), (10.0, 80.0)):
        j = JP.gal_lnprior(jnp.asarray(d), jnp.asarray(coord),
                           feh=None if feh is None else jnp.asarray(feh),
                           loga=None if loga is None else jnp.asarray(loga),
                           cfg=cfg)
        t = TP.gal_lnprior(torch.as_tensor(d), torch.tensor(coord, dtype=F64),
                           feh=None if feh is None else torch.as_tensor(feh),
                           loga=None if loga is None
                           else torch.as_tensor(loga),
                           cfg=TCFG.GalPriorConfig(f_halo=0.01))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-10)


def test_dust_lnprior_matches_hat_interpolation():
    """The port reads only the two rungs whose hat weights can be
    non-zero; the JAX package sums all rungs.  Same values to float64
    rounding, including the clamped ends, exact rungs and an uncovered
    (NaN) profile."""
    rng = np.random.default_rng(5)
    ladder = np.linspace(0.05, 10.0, 120)
    mean = np.linspace(0.0, 1.5, 120)
    std = np.full(120, 0.2)
    d = np.concatenate([rng.uniform(-1.0, 12.0, 300), ladder[[0, 7, 119]]])
    av = rng.uniform(0.0, 3.0, d.size)
    for m in (mean, np.full(120, np.nan)):
        t = TP.dust_lnprior(torch.as_tensor(d), torch.as_tensor(av),
                            torch.as_tensor(ladder), torch.as_tensor(m),
                            torch.as_tensor(std))
        j = JP.dust_lnprior(jnp.asarray(d), jnp.asarray(av),
                            jnp.asarray(ladder), jnp.asarray(m),
                            jnp.asarray(std), DustPriorConfig())
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-10)


def test_prepare_star_data_matches():
    """float32, with masked, NaN, zero-error and negative-flux bands."""
    rng = np.random.default_rng(6)
    flux = (10 ** rng.uniform(-6, -3, (9, 8))).astype(F32)
    err = (flux / rng.uniform(5, 80, flux.shape)).astype(F32)
    flux[0, 1] = np.nan
    err[1, 2] = 0.0
    flux[2, 3] = -flux[2, 3]
    mask = rng.uniform(size=flux.shape) > 0.1
    t = t_prepare(torch.as_tensor(flux), torch.as_tensor(err),
                  torch.as_tensor(mask), TCFG.FitConfig())
    j = j_prepare(jnp.asarray(flux), jnp.asarray(err), jnp.asarray(mask),
                  FitConfig())
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy().astype(float),
                                   np.asarray(b, float), rtol=2e-6)


def test_config_defaults_match():
    """Every field of the port's configs is a field of the JAX package's
    with the same default (the port keeps only those it reads); the
    prior configs are whole copies."""
    import dataclasses
    from brutus_tpu import config as JCFG
    for name in ("FitConfig", "PosteriorConfig", "GalPriorConfig",
                 "DustPriorConfig"):
        port = dataclasses.asdict(getattr(TCFG, name)())
        ref = dataclasses.asdict(getattr(JCFG, name)())
        assert port == {k: ref[k] for k in port}, name
        if name.endswith("PriorConfig"):
            assert port == ref, name
    # K4 makes its own normals by default in both packages
    assert TCFG.PosteriorConfig().kernel_rng is True
    assert JCFG.PosteriorConfig().kernel_rng is True
    assert TCFG.LN2PI == JCFG.LN2PI


def test_default_grid_lnprior_matches():
    rng = np.random.default_rng(7)
    lt = np.dtype([("mini", float), ("eep", float), ("feh", float),
                   ("agewt", float), ("logt", float)])
    lab = np.zeros(300, lt)
    lab["mini"] = np.repeat(np.linspace(0.1, 2.5, 30), 10)
    lab["eep"] = np.tile(np.linspace(202, 600, 10), 30)
    lab["feh"] = rng.choice([-1.0, -0.5, 0.0, 0.25], 300)
    lab["agewt"] = rng.uniform(0.1, 2.0, 300)
    lab["logt"] = rng.uniform(3.5, 4.0, 300)
    np.testing.assert_allclose(default_grid_lnprior(lab),
                               j_grid_lnprior(lab), rtol=1e-12)
    lab2 = np.zeros(50, [("Mr", float)])
    lab2["Mr"] = np.linspace(-3, 15, 50)
    np.testing.assert_allclose(default_grid_lnprior(lab2),
                               j_grid_lnprior(lab2), rtol=1e-12)


def test_dustmap_query_and_uniform_profile(tmp_path):
    """The port's Bayestar reader (numpy HEALPix, lazy h5py) finds the
    same pixels as the JAX package's on a two-level map file."""
    rng = np.random.default_rng(8)
    nside = np.array([16] * 20 + [32] * 20)
    pix = np.concatenate([rng.choice(12 * 16 ** 2, 20, replace=False),
                          rng.choice(12 * 32 ** 2, 20, replace=False)])
    dists = np.linspace(0.06, 60.0, 31)
    av_mean = rng.uniform(0, 3, (40, 31)).astype(F32)
    av_std = rng.uniform(0.05, 0.5, (40, 31)).astype(F32)
    path = str(tmp_path / "map.h5")
    write_bayestar_file(path, nside, pix, dists, av_mean, av_std)
    l = rng.uniform(0, 360, 500)
    b = np.degrees(np.arcsin(rng.uniform(-1, 1, 500)))
    tq = TBayestar(path).query((l, b))
    jq = JBayestar(path).query((l, b))
    for a, c in zip(tq, jq):
        np.testing.assert_array_equal(a, c)
    assert np.isfinite(tq[1]).any(axis=1).sum() > 0
    for a, c in zip(uniform_profile(*tq, n=128), j_uniform(*jq, n=128)):
        np.testing.assert_array_equal(a, c)


def test_results_writer_schema_matches(tmp_path):
    """Same 13 datasets, shapes, dtypes and fill values as the JAX
    package's writer."""
    import h5py
    assert RESULTS_DATASETS == J_RESULTS and DRAW_DATASETS == J_DRAWS
    files = []
    for W, name in ((TWriter, "t"), (JWriter, "j")):
        w = W(str(tmp_path / name), 5, 7)
        w.close()
        files.append(h5py.File(str(tmp_path / name) + ".h5", "r"))
    t, j = files
    assert sorted(t) == sorted(j) and len(t) == 13
    for k in j:
        assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k][:], j[k][:])
    for f in files:
        f.close()


def test_cuda_requested_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TU.resolve_device(None)
    assert TU.resolve_device("cpu").type == "cpu"
