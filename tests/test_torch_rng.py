"""K4's random-number mode in the port (`brutus_tpu_torch.ops.rng`, the
seeds path of `ops.mc.mc_integrate`): Philox4x32-10 against its
published known-answer vectors, the moments of its Box-Muller normals,
the mode's plain path against `mc_integrate_plain` fed the same
normals, and `lnpost_batch` with in-kernel draws against the JAX
package's `lnpost_batch` fed its own normals, in distribution.

The CUDA kernel in this mode against its plain version:
`tests/test_torch_kernels_gpu.py`.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from bench import build_problem
from brutus_tpu.config import FitConfig, PosteriorConfig
from brutus_tpu.ops import pallas_loglike as PL
from brutus_tpu.ops.posterior import lnpost_batch as j_lnpost_batch
from brutus_tpu_torch import config as TC
from brutus_tpu_torch.ops import mc as TMC, posterior as TP, rng
from test_torch_kernels_gpu import _mc_problem

# Salmon et al. (SC'11), Random123's kat_vectors: counter, key, output.
PHILOX_KAT = {
    "zeros": ((0, 0, 0, 0), (0, 0),
              (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    "ones": ((0xffffffff,) * 4, (0xffffffff,) * 2,
             (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    "pi": ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
           (0xa4093822, 0x299f31d0),
           (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
}


@pytest.mark.parametrize("case", sorted(PHILOX_KAT))
def test_philox_known_answers(case):
    """Philox4x32-10 gives the published output words exactly."""
    ctr, key, want = PHILOX_KAT[case]
    t = lambda v: torch.tensor(v, dtype=torch.int64)
    got = rng.philox4x32_10(tuple(map(t, ctr)), tuple(map(t, key)))
    assert tuple(int(w) for w in got) == want


def test_normal_moments():
    """3 x 1.2e6 normals from 8 star seeds: mean within 5e-3, variance
    within 1e-2 of 1 and the three cross-correlations below 5e-3 (each
    about 5 standard errors); the padding rows are zero."""
    seeds = torch.tensor([[11 * b + 5, 2 ** 31 - 2 - 977 * b]
                          for b in range(8)], dtype=torch.int32)
    z = rng.normals(seeds, 3000, 50, 56)
    assert z.shape == (8, 3, 56, 3000)
    assert (z[:, :, 50:] == 0).all()
    x = z[:, :, :50].transpose(0, 1).reshape(3, -1).double()
    assert x.shape[1] == 1_200_000
    assert x.mean(1).abs().max().item() < 5e-3
    assert (x.var(1) - 1.0).abs().max().item() < 1e-2
    c = torch.corrcoef(x)
    for i, j in ((0, 1), (0, 2), (1, 2)):
        assert abs(c[i, j].item()) < 5e-3, (i, j, c[i, j].item())


def test_star_draws_follow_the_row_not_the_batch_position():
    """A star's draws depend on the fit's seed and its global row alone:
    the star of row 41 at position 0 of one batch and at position 5 of
    another draws the same key, `u`, Gumbel noise, fed and grid normals;
    a selection twice as wide extends its normals without changing the
    first half; other rows and other seeds draw otherwise."""
    cfg = TC.PosteriorConfig(n_mc_prior=12, n_draws=30)
    fed = dataclasses.replace(cfg, kernel_rng=False)
    rows_a = torch.tensor([41, 0, 1, 2, 3, 4])
    rows_b = torch.tensor([7, 8, 9, 10, 11, 41, 12])
    draw = lambda rows, c, K=64, **kw: TP.draw_noise(9, rows, K, c, "cpu",
                                                     **kw)
    a, b = draw(rows_a, cfg), draw(rows_b, cfg)
    assert torch.equal(a.seeds[0], b.seeds[5])
    assert torch.equal(a.u[0], b.u[5])
    assert torch.equal(a.gumbel[0], b.gumbel[5])
    fa, fb = draw(rows_a, fed), draw(rows_b, fed, K=128)
    assert torch.equal(fa.z[0], fb.z[5][..., :64])
    assert torch.equal(fa.z[0], rng.normals(a.seeds[:1], 64, 12, 16)[0])
    ga, gb = draw(rows_a, cfg, grid=True), draw(rows_b, cfg, grid=True)
    assert torch.equal(ga.z[0], gb.z[5])
    assert ga.z.shape == (6, 64, 3, 12) and a.gumbel.shape == (6, 30, 12)
    assert not torch.equal(a.u[0], a.u[1])
    assert not torch.equal(a.u[0], TP.draw_noise(10, rows_a, 64, cfg,
                                                 "cpu").u[0])
    # the streams of one star do not repeat each other
    assert not torch.equal(ga.z[0, :, 0, :], fa.z[0, 0, :12].T)
    assert 0.0 <= a.u.min() and a.u.max() < 1.0
    assert torch.isfinite(a.gumbel).all()


@pytest.mark.parametrize("z", [None, "mc", "grid"])
def test_draws_on_the_host_is_the_plain_path(z):
    """Off the card `rng.draws` is `star_keys` then `posterior_draws`, bit
    for bit, and launches no kernel, for rows past 2**32 (int32 or int64)
    and a seed with the high bit of 64 set; `draw_noise` hands on what
    it returns."""
    from brutus_tpu_torch.ops import _native
    seed, nmcp = 2 ** 63 + 977, TMC.nmc_pad_of(13)
    rows = torch.tensor([2 ** 32 + 5, 3, 2 ** 40])
    _native.reset_launches()
    got = rng.draws(seed, rows, 37, 13, 9, z=z, nmc_pad=nmcp)
    keys = rng.star_keys(seed, rows)
    want = (keys, *rng.posterior_draws(keys, 37, 13, 9, z=z, nmc_pad=nmcp))
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)
    small = torch.tensor([4, 1], dtype=torch.int32)
    for g, w in zip(rng.draws(seed, small, 37, 13, 9, z=z, nmc_pad=nmcp),
                    rng.draws(seed, small.long(), 37, 13, 9, z=z,
                              nmc_pad=nmcp)):
        assert (g is None and w is None) or torch.equal(g, w)
    cfg = TC.PosteriorConfig(n_mc_prior=13, n_draws=9, kernel_rng=z is None)
    noise = TP.draw_noise(seed, rows, 37, cfg, "cpu", grid=z == "grid")
    assert torch.equal(noise.u, want[2])
    assert torch.equal(noise.gumbel, want[3])
    assert (noise.z is None) == (z is None)
    if z is not None:
        assert torch.equal(noise.z, want[1]) and noise.seeds is None
    else:
        assert torch.equal(noise.seeds, keys)
    assert all(k.launches == 0 for k in _native.KERNELS.values())


def test_rng_plain_path_is_fed_plain():
    """On the CPU the random-number mode IS `rng.normals` followed by
    `mc_integrate_plain`: equal outputs, bit for bit; the two modes
    take exactly one of `z` and `seeds`."""
    cpu = torch.device("cpu")
    args, _, cf = _mc_problem(cpu)
    K = args[0].shape[2]
    seeds = torch.tensor([[3 * b + 1, 12345 + b] for b in range(8)],
                         dtype=torch.int32)
    out = TMC.mc_integrate(*args, None, 50, 512, *cf, seeds=seeds)
    z = rng.normals(seeds, K, 50, TMC.nmc_pad_of(50))
    flags = TMC.tile_flags(args[2] > 0.5, 512)
    ref = TMC.mc_integrate_plain(*args, z, flags, 50, 512, *cf)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        TMC.mc_integrate(*args, z, 50, 512, *cf, seeds=seeds)
    with pytest.raises(ValueError):
        TMC.mc_integrate(*args, None, 50, 512, *cf)


def test_lnpost_batch_rng_in_distribution():
    """`lnpost_batch` with the MC normals made from per-star seeds
    (`PosteriorConfig.kernel_rng`, the default) against the JAX
    package's `lnpost_batch` on the same pack fed its own normals:
    other draws from the same distribution, so per-star log-evidence
    within 0.1 nats and posterior median distance within 2% (the sum of
    two single-run MC envelopes of ~0.05 nats and ~1%)."""
    B, M, F = 6, 4096, 8
    mc, flux, err, idx, feh, loga, plx, plxe = build_problem(M, F, B,
                                                             seed=17)
    lnprior = np.random.default_rng(5).uniform(-1, 0, M).astype(np.float32)
    st, packed, names, n_real, maskrow = PL.prepare_screen(
        mc, aux=dict(lnprior=lnprior, feh=feh.astype(np.float32),
                     loga=loga.astype(np.float32)),
        tile=512, screen_block=64)
    res = PL.loglike_grid_screened(
        jnp.asarray(flux), jnp.asarray(err), jnp.ones((B, F), bool), st,
        packed, maskrow, n_real, parallax=jnp.asarray(plx),
        parallax_err=jnp.asarray(plxe), cfg=FitConfig(), tile=512,
        screen_k=1024, screen_block=64, aux_names=names, interpret=True)
    names = PL.pack_row_names(names)
    coord = (204.7, -19.2)
    dust = (np.linspace(0.05, 10.0, 120, dtype=np.float32),
            np.linspace(0.0, 1.5, 120, dtype=np.float32),
            np.full(120, 0.2, np.float32))
    ref = j_lnpost_batch(
        jax.random.split(jax.random.PRNGKey(8), B), res,
        res["pack_rows"][:, names.index("lnprior")],
        jnp.asarray(coord, jnp.float32), parallax=jnp.asarray(plx),
        parallax_err=jnp.asarray(plxe), feh=res["aux"]["feh"],
        loga=res["aux"]["loga"],
        dust_profile=tuple(jnp.asarray(x) for x in dust),
        global_idx=res["global_idx"], pack_names=names,
        cfg=PosteriorConfig(), interpret=True)
    pack = torch.as_tensor(np.array(res["pack_rows"])[:, :len(names)])
    pcfg = TC.PosteriorConfig()
    assert pcfg.kernel_rng
    noise = TP.draw_noise(2, torch.arange(B),
                          TP.selection_size(pcfg, pack.shape[2]), pcfg,
                          "cpu")
    assert noise.z is None and noise.seeds.shape == (B, 2)
    out = TP.lnpost_batch(
        pack, names, torch.as_tensor(np.array(res["ndim"])),
        torch.tensor([coord] * B), noise, parallax=torch.as_tensor(plx),
        parallax_err=torch.as_tensor(plxe),
        dust_profile=(torch.as_tensor(dust[0]),
                      torch.as_tensor(dust[1]).expand(B, 120),
                      torch.as_tensor(dust[2]).expand(B, 120)), cfg=pcfg)
    for k, v in out.items():
        if v.dtype.is_floating_point:
            assert torch.isfinite(v).all(), k
    lev = out["log_evidence"].numpy()
    med = np.median(out["dist"].numpy(), 1)
    med_j = np.median(np.asarray(ref["dist"]), 1)
    assert np.abs(lev - np.asarray(ref["log_evidence"])).max() < 0.1
    assert np.abs(med / med_j - 1).max() < 0.02
