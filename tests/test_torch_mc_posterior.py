"""The port's posterior stage against `brutus_tpu`: the MC-integration
kernel K4 (`brutus_tpu_torch.ops.mc`) against `pallas_mc.mc_integrate`
in interpret mode, and `lnpost_batch` against the JAX package's
`lnpost_batch` fed the same random numbers (the JAX normals through
`z`, its uniforms and its Gumbel noise).

Inputs come from a numpy seed; the JAX side gets float32 arrays
(conftest turns x64 on).  The CUDA kernel against this plain version:
`tests/test_torch_kernels_gpu.py`.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from bench import build_problem
from brutus_tpu.config import FitConfig, PosteriorConfig
from brutus_tpu.ops import pallas_loglike as PL
from brutus_tpu.ops import pallas_mc as JMC
from brutus_tpu.ops.posterior import lnpost_batch as j_lnpost_batch
from brutus_tpu.utils import inverse3_sym_parts, is_psd3_parts
from brutus_tpu_torch import config as TC
from brutus_tpu_torch.ops import mc as TMC, posterior as TP

B, M, F = 5, 4096, 8
COORD = (204.7, -19.2)
DUST = (np.linspace(0.05, 10.0, 120, dtype=np.float32),
        np.linspace(0.0, 1.5, 120, dtype=np.float32),
        np.full(120, 0.2, np.float32))


@pytest.fixture(scope="module")
def fit():
    """A JAX funnel fit of 5 stars (4096 models, 1024-model shortlists):
    the stacked pack both posteriors read."""
    mc, flux, err, idx, feh, loga, plx, plxe = build_problem(M, F, B,
                                                             seed=11)
    lnprior = np.random.default_rng(5).uniform(-1, 0, M).astype(np.float32)
    st, packed, names, n_real, maskrow = PL.prepare_screen(
        mc, aux=dict(lnprior=lnprior, feh=feh.astype(np.float32),
                     loga=loga.astype(np.float32)),
        tile=512, screen_block=64)
    res = PL.loglike_grid_screened(
        jnp.asarray(flux), jnp.asarray(err), jnp.ones((B, F), bool), st,
        packed, maskrow, n_real, parallax=jnp.asarray(plx),
        parallax_err=jnp.asarray(plxe), cfg=FitConfig(mag_direct_init=True),
        tile=512, screen_k=1024, screen_block=64, aux_names=names,
        interpret=True)
    return dict(res=res, names=PL.pack_row_names(names), plx=plx,
                plxe=plxe)


def _pd_mask(tab, row_map):
    """Models whose precision is positive definite (no PSD repair)."""
    parts = tuple(jnp.asarray(tab[:, row_map[3 + j]]) for j in range(6))
    return np.asarray(is_psd3_parts(inverse3_sym_parts(parts)))


def _assert_mc_close(out, ref, pd):
    """K4 outputs agree: on models with a positive-definite precision
    every output within 1e-4 (relative and absolute: the same float32
    formulas summed in another order); the fixed-pass PSD repair of
    indefinite precisions amplifies rounding differences chaotically
    (README), so there only 95% of the models must agree as tightly."""
    for name, a, b in zip(("lnmc", "dist", "red", "dred", "agg"), out, ref):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        sel = np.broadcast_to(pd[:, None, :], a.shape)
        np.testing.assert_allclose(a[sel], b[sel], rtol=1e-4, atol=1e-4,
                                   err_msg=name)
        close = np.isclose(a, b, rtol=1e-4, atol=1e-4).all(1)
        assert close[~pd].mean() >= 0.95, (name, close[~pd].mean())


@pytest.mark.parametrize("tile", [256, 32])
def test_mc_kernel_matches(fit, tile):
    """K4 with shared normals against the JAX kernel in interpret mode,
    on the 512 best-fitting models of each star, at the skip tile of
    the JAX default (256) and at one warp (32); one dead tile and one
    star with no valid model exercise the tile skip."""
    K, nmc, nmcp = 512, 20, 24
    rng = np.random.default_rng(21)
    full = np.asarray(fit["res"]["pack_rows"])[:, :len(fit["names"])]
    best = np.argsort(-full[:, 0], axis=1, kind="stable")[:, :K]
    pack = np.ascontiguousarray(np.take_along_axis(full, best[:, None],
                                                   axis=2))
    row_map = TP._pack_row_map(fit["names"])
    valid = rng.uniform(size=(B, K)) > 0.3
    valid[0, :256] = False                   # one dead tile: skipped
    valid[1] = False                         # a star with no valid model
    z = np.zeros((B, 3, nmcp, K), np.float32)
    z[:, :, :nmc] = rng.normal(size=(B, 3, nmc, K))
    coord = torch.tensor([COORD] * B, dtype=torch.float32)
    scal, dust = TP._star_scalars(
        coord, torch.as_tensor(fit["plx"]), torch.as_tensor(fit["plxe"]),
        (torch.as_tensor(DUST[0]),
         torch.as_tensor(DUST[1]).expand(B, 120),
         torch.as_tensor(DUST[2]).expand(B, 120)), True)
    pcfg = PosteriorConfig(n_mc_prior=nmc)
    jscal = np.zeros((B, 1, 16), np.float32)
    jscal[:, 0, :10] = scal.numpy()
    jdust = np.zeros((B, 128, 8), np.float32)
    jdust[:, :, :2] = dust.numpy().transpose(0, 2, 1)
    ref = JMC.mc_integrate(
        jnp.asarray(pack), jnp.asarray(jscal), jnp.asarray(jdust), nmc,
        nmcp, pcfg, JMC.GalPriorConfig(), JMC.DustPriorConfig(), True, True,
        True, tile=tile, interpret=True, z=jnp.asarray(z),
        valid=jnp.asarray(valid), row_map=row_map)
    out = TMC.mc_integrate(
        torch.as_tensor(pack), row_map, torch.as_tensor(valid,
                                                        dtype=torch.float32),
        scal, dust, torch.as_tensor(z), nmc, tile, TC.PosteriorConfig(
            n_mc_prior=nmc), TC.GalPriorConfig(), TC.DustPriorConfig(),
        True, True, True)
    pd = _pd_mask(pack, row_map)
    assert pd.sum() >= 100, pd.sum()
    _assert_mc_close(out, ref, pd)
    skipped = np.asarray(ref[4])[0, 0, :256]
    np.testing.assert_array_equal(out[4].numpy()[0, 0, :256], skipped)
    assert (skipped == -1e30).all()


def _jax_noise(keys, K, pcfg):
    """The JAX package's own draws for each star (`lnpost_batch`'s
    `kmvn, kidx, kmc = split(key, 3)`)."""
    nmc = pcfg.n_mc_prior
    nmcp = -(-nmc // 8) * 8
    zs, us, gs = [], [], []
    for key in keys:
        kmvn, kidx, kmc = jax.random.split(key, 3)
        z = np.asarray(jax.random.normal(kmvn, (K, 3, nmc), jnp.float32))
        zs.append(np.pad(z.transpose(1, 2, 0),
                         ((0, 0), (0, nmcp - nmc), (0, 0))))
        us.append(np.asarray(jax.random.uniform(kidx, (pcfg.n_draws,),
                                                jnp.float32)))
        gs.append(np.asarray(jax.random.gumbel(
            kmc, (pcfg.n_draws, nmc), jnp.float32)))
    return TP.Noise(*(torch.as_tensor(np.stack(x)) for x in (zs, us, gs)))


VARIANTS = {
    # all priors, prefilter on its bf16 key (the fit's defaults)
    "full": dict(cfg=dict(n_mc_prior=20, n_draws=64, n_sel_max=256,
                          prefilter_k=256), dust=True, plx=True,
                 labels=True),
    # no dust / labels / parallax, odd Nmc (padded draw rows)
    "minimal": dict(cfg=dict(n_mc_prior=13, n_draws=32, n_sel_max=128,
                             prefilter_k=128), dust=False, plx=False,
                    labels=False),
    # uncovered sightline: NaN dust profile -> flat dust prior
    "nan_dust": dict(cfg=dict(n_mc_prior=16, n_draws=32, n_sel_max=128,
                              prefilter_k=128), dust="nan", plx=True,
                     labels=True),
    # no prefilter: exact top-K of the culled shortlist
    "no_prefilter": dict(cfg=dict(n_mc_prior=16, n_draws=48, n_sel_max=200,
                                  prefilter_k=0), dust=True, plx=True,
                         labels=True),
    # CDF culls instead of relative-weight culls (wt_thresh=None)
    "cdf_cull": dict(cfg=dict(n_mc_prior=16, n_draws=32, n_sel_max=256,
                              prefilter_k=256, wt_thresh=None),
                     dust=True, plx=True, labels=True),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_lnpost_batch_matches(fit, variant):
    """Whole posterior stage on the same pack and the same random
    numbers: identical model draws, every float output within 1e-4
    (relative and absolute, float32 association)."""
    v = VARIANTS[variant]
    pcfg = PosteriorConfig(**v["cfg"])
    res = dict(fit["res"])
    names = fit["names"]
    col = {n: i for i, n in enumerate(names)}
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    dust = None
    if v["dust"]:
        dm = DUST[1] if v["dust"] is True else np.full(120, np.nan,
                                                       np.float32)
        dust = (DUST[0], dm, DUST[2])
    plx = fit["plx"] if v["plx"] else None
    plxe = fit["plxe"] if v["plx"] else None
    pack = np.asarray(res["pack_rows"])
    if not v["labels"]:
        keep = [n for n in names if n not in ("feh", "loga")]
        pack = pack[:, [col[n] for n in keep]]
        names = tuple(keep)
        res["pack_rows"] = jnp.asarray(pack)
    ref = j_lnpost_batch(
        keys, res, res["pack_rows"][:, names.index("lnprior")],
        jnp.asarray(COORD, jnp.float32),
        parallax=None if plx is None else jnp.asarray(plx),
        parallax_err=None if plxe is None else jnp.asarray(plxe),
        feh=res["aux"]["feh"] if v["labels"] else None,
        loga=res["aux"]["loga"] if v["labels"] else None,
        dust_profile=None if dust is None else tuple(jnp.asarray(x)
                                                     for x in dust),
        global_idx=res["global_idx"], pack_names=names, cfg=pcfg,
        interpret=True)
    K = min(pcfg.n_sel_max, pack.shape[2])
    noise = _jax_noise(keys, K, pcfg)
    tdust = None
    if dust is not None:
        tdust = (torch.as_tensor(dust[0]),
                 torch.as_tensor(dust[1]).expand(B, 120),
                 torch.as_tensor(dust[2]).expand(B, 120))
    out = TP.lnpost_batch(
        torch.as_tensor(pack[:, :len(names)]), names,
        torch.as_tensor(np.asarray(res["ndim"])),
        torch.tensor([COORD] * B), noise,
        parallax=None if plx is None else torch.as_tensor(plx),
        parallax_err=None if plxe is None else torch.as_tensor(plxe),
        dust_profile=tdust, cfg=TC.PosteriorConfig(**v["cfg"]))
    np.testing.assert_array_equal(out["model_idx"].numpy(),
                                  np.asarray(ref["model_idx"]))
    np.testing.assert_array_equal(out["ndim"].numpy(),
                                  np.asarray(ref["ndim"]))
    for k in ("scale", "av", "rv", "cov_sar", "lnprob", "dist", "red",
              "dred", "logwt", "log_evidence", "chi2min"):
        np.testing.assert_allclose(out[k].numpy().astype(float),
                                   np.asarray(ref[k], float), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("tile", [32, 512])
def test_tile_flags(tile):
    """K4's skip flags: a model tile is active where it holds a valid
    model, or everywhere for a star without one (its chi2-fallback
    resampling reads every model), as `pallas_mc.mc_integrate` sets
    them; checked on a best-first selection culled to a ragged valid
    prefix, a star without valid models and scattered culls."""
    K = 2048
    rng = np.random.default_rng(3)
    valid = np.zeros((4, K), bool)
    valid[0, :45] = True                     # ragged valid prefix
    valid[2] = rng.uniform(size=K) > 0.9     # scattered
    valid[3, K - 1] = True                   # only the last model
    flags = TMC.tile_flags(torch.as_tensor(valid), tile)
    assert flags.dtype == torch.int32 and flags.shape == (4, K // tile)
    want = valid.reshape(4, K // tile, tile).any(-1)
    want[1] = True                           # star 1 has no valid model
    np.testing.assert_array_equal(flags.numpy(), want.astype(np.int32))
