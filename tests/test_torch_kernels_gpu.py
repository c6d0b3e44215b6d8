"""The port's CUDA kernels, in each of their modes, against their plain
PyTorch versions, on a CUDA card.  Every test here carries the `gpu`
marker and skips where no card is present (the check runs inside each
test, never at import).

The module imports no jax, so it also runs on a card machine without
jax, where `tests/conftest.py` cannot be loaded:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_kernels_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from brutus_tpu_torch.config import (FitConfig, PosteriorConfig,
                                     GalPriorConfig, DustPriorConfig)
from brutus_tpu_torch.convert import from_numpy_grid
from brutus_tpu_torch.ops import fit as TFD, funnel as TF, mc as TMC
from brutus_tpu_torch.ops import posterior as TP, rng
from brutus_tpu_torch.utils import inverse3_sym_parts, is_psd3_parts
import chip_smoke as smoke

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(M, F, B, seed, dev):
    rng = np.random.default_rng(seed)
    mc = np.stack([rng.uniform(8.0, 16.0, (M, F)),
                   rng.uniform(0.4, 1.1, (M, F)),
                   rng.uniform(0.05, 0.2, (M, F))], -1).astype(np.float32)
    idx = rng.integers(0, M, B)
    av = rng.uniform(0.1, 1.2, B)
    rv = rng.uniform(2.8, 3.8, B)
    dist = rng.uniform(0.5, 2.0, B)
    sed = mc[idx, :, 0] + av[:, None] * (mc[idx, :, 1]
                                         + rv[:, None] * mc[idx, :, 2])
    flux = 10 ** (-0.4 * sed) / dist[:, None] ** 2
    err = flux / 60.0
    flux = flux + rng.normal(size=flux.shape) * err
    mask = np.ones((B, F), bool)
    mask[0, max(4, F // 2):] = False
    lab = np.zeros(M, [("feh", float), ("loga", float)])
    lab["feh"] = rng.uniform(-2.0, 0.3, M)
    lab["loga"] = rng.uniform(8.0, 10.1, M)
    tabs = from_numpy_grid(mc, lab, device=dev,
                           lnprior=rng.uniform(-1, 0, M))
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    return dict(mc=mc, tabs=tabs, flux=t(flux), err=t(err),
                mask=torch.as_tensor(mask, device=dev), plx=t(1.0 / dist),
                plxe=t(0.05 / dist), idx=idx)


@pytest.mark.parametrize("F", [8, 49])
def test_funnel_kernels_match_plain(cuda, F):
    """K2 within 1.0 of the plain score (float32 order of a cancelling
    sum, see test_torch_funnel), K3 exact.  K1's fixed-budget iterations
    branch on float comparisons that rounding in another order can flip,
    so a few models stop at another point of the same fit; the limits
    sit above the H100 readings of this problem (F=8 / F=49) with
    multiply-add contraction: lnlike within 0.02 nats of the plain value
    on models within 20 nats of the best (read 3.4e-4 / 8.3e-4); each
    field within 0.2 of |plain| + the field's median |plain| (read
    0.034 / 6.1e-5); at most 0.1% of the fields beyond 1e-3 of that
    (read 2.1e-4 / 0).  The build turns contraction off; F=8 then reads
    0 for all three."""
    p = _problem(2048 if F == 8 else 1024, F, 6, 3 + F, cuda)
    tabs, cfg = p["tabs"], FitConfig()
    fp, wf, mg, wm, mk, nd, tv = TF.prepare_star_data(
        p["flux"], p["err"], p["mask"], cfg)
    plx, plxw = TF._screen_parallax(p["plx"], p["plxe"])
    star2, srow5 = TF._screen_star_mats(mg, wm, plx, plxw)
    bs = TF.screen_blocks(tabs.table, tabs.maskrow, star2, srow5, F, 64,
                          cfg)
    bp = TF.screen_blocks_plain(tabs.table, tabs.maskrow, star2, srow5, F,
                                64, cfg)
    real = bp > -1e29
    assert torch.equal(bs > -1e29, real)
    assert (bs - bp).abs()[real].max().item() < 1.0
    bidx, idx = TF._select_blocks(bp, 8, 64)
    coef = TF.gather_slabs(tabs.table, bidx, 64)
    assert torch.equal(coef, TF.gather_slabs_plain(tabs.table, bidx, 64))
    star4 = torch.stack([fp, wf, mg, wm], 1).contiguous()
    srow3 = torch.zeros((6, 3), device=cuda)
    args = (star4, coef, idx.contiguous(), srow3, 3, 15, tabs.n_real, 512,
            cfg)
    k, q = TF.fit_pack(*args), TF.fit_pack_plain(*args)
    real = idx < tabs.n_real
    near = real & (q[:, 0] > q[:, 0].amax(1, keepdim=True) - 20.0)
    qa = q[:, :11].abs().permute(1, 0, 2)[:, real]
    rel = ((k[:, :11] - q[:, :11]).abs().permute(1, 0, 2)[:, real]
           / (qa + qa.median(1, keepdim=True).values + 1e-30))
    lnl_dev = (k[:, 0] - q[:, 0]).abs()[near].max().item()
    frac = (rel > 1e-3).float().mean().item()
    print(f"K1 F={F}: lnlike {lnl_dev:.3g}, field {rel.max().item():.3g}, "
          f"share beyond 1e-3 {frac:.3g}")
    assert lnl_dev <= 0.02
    assert rel.max().item() <= 0.2
    assert frac <= 1e-3
    assert torch.equal(k[:, 11:], q[:, 11:])


# The redesigned K1 and K2 (register-resident per-filter state for
# F <= 16, the run-time-F instance above it; windows of 256 and 1024
# models on blocks of at most 256 threads; star groups with a ragged
# end), held to the limits of `chip_smoke.py` phase 3.
SHAPES = [(F, tile) for F in (5, 8, 49) for tile in (256, 1024)]


def _fit_inputs(p, cfg):
    fp, wf, mg, wm, mk, nd, tv = TF.prepare_star_data(
        p["flux"], p["err"], p["mask"], cfg)
    return (torch.stack([fp, wf, mg, wm], 1).contiguous(),
            TF.post_consts(mk, nd, tv), mg, wm)


@pytest.mark.parametrize("F,tile", SHAPES)
def test_stacked_fit_kernel_matches_plain(cuda, F, tile):
    """K1 in stacked mode on 5 stars' 2048-model shortlists (32 blocks
    of 64 of a 4096-model grid, the last models padding), within
    `chip_smoke.K1_TOL` and 0.02 nats near the best; aux rows and
    grid index copied exactly."""
    p = _problem(4000, F, 5, 40 + F, cuda)
    tabs, cfg = p["tabs"], FitConfig()
    star4, srow3, mg, wm = _fit_inputs(p, cfg)
    plx, plxw = TF._screen_parallax(p["plx"], p["plxe"])
    star2, srow5 = TF._screen_star_mats(mg, wm, plx, plxw)
    bp = TF.screen_blocks_plain(tabs.table, tabs.maskrow, star2, srow5, F,
                                64, cfg)
    bidx, idx = TF._select_blocks(bp, 32, 64)
    bidx[0, -1] = tabs.table.shape[1] // 64 - 1          # a padding block
    idx = (bidx[:, :, None] * 64 + torch.arange(64, device=cuda,
                                                dtype=torch.int32))
    idx = idx.reshape(5, -1).contiguous()
    coef = TF.gather_slabs_plain(tabs.table, bidx, 64)
    args = (star4, coef, idx, srow3, 3, 15, tabs.n_real, tile, cfg)
    k, q = TF.fit_pack(*args), TF.fit_pack_plain(*args)
    dev = smoke.fit_deviation(k, q, idx, tabs.n_real, tile)
    print(f"K1 stacked F={F} tile={tile}: {dev}")
    assert smoke.fit_ok(dev), dev
    assert torch.equal(k[:, 11:], q[:, 11:])
    pad = idx >= tabs.n_real
    assert pad.any() and torch.equal(k[:, :2][pad[:, None].expand(
        -1, 2, -1)], q[:, :2][pad[:, None].expand(-1, 2, -1)])


def test_fit_kernel_padding_mask_past_2_24(cuda):
    """K1's padding mask compares grid indices as integers: on shortlists
    of a grid of 2**24 + 4097 real models, each star's own model at the
    last real index (2**24 + 4096, equal to `n_real` once both are
    rounded to float32) stays finite and wins, every model past it is
    masked, and the kernel equals its plain version on every row."""
    P, F, B = 512, 8, 6
    p = _problem(P, F, B, 77, cuda)
    cfg = FitConfig()
    star4, srow3, _, _ = _fit_inputs(p, cfg)
    n_real = 2 ** 24 + 4097
    coef = torch.as_tensor(p["mc"].transpose(2, 1, 0).reshape(3 * F, P),
                           device=cuda)
    coef = coef[:, None, :].expand(3 * F, B, P).contiguous()
    pos = torch.arange(P, device=cuda)
    own = torch.as_tensor(p["idx"], device=cuda)[:, None]
    gidx = (n_real - 1 - own + pos).to(torch.int32).contiguous()
    args = (star4, coef, gidx, srow3, 0, 12, n_real, 512, cfg)
    k, q = TF.fit_pack(*args), TF.fit_pack_plain(*args)
    dev = smoke.fit_deviation(k, q, gidx, n_real, 512)
    assert smoke.fit_ok(dev), dev
    assert torch.equal(k[:, 11:], q[:, 11:])
    lnl = k[:, 0]
    assert torch.equal(lnl.argmax(1), own[:, 0])
    past = pos[None] > own
    assert past.any() and (lnl[past] < -1e29).all()
    assert (lnl[~past] > -1e29).all()


@pytest.mark.parametrize("F,tile", SHAPES)
def test_dense_fit_kernel_matches_plain(cuda, F, tile):
    """K1 in dense mode against its plain version, on every model of a
    4000-model grid padded to 4096 for 13 stars (one with half its
    bands masked; 13 is no multiple of the kernel's 8-star group), within
    `chip_smoke.K1_TOL` and 0.02 nats near the best, on real models;
    the padding masked exactly alike."""
    p = _problem(4000, F, 13, 31 + F, cuda)
    cfg = FitConfig()
    coeffs, n_real = TFD.prepare_coeffs(p["mc"], tile=1024, device=cuda)
    star4, srow3, _, _ = _fit_inputs(p, cfg)
    args = (star4, coeffs, srow3, n_real, tile, cfg)
    k, q = TFD.fit_dense(*args), TFD.fit_dense_plain(*args)
    assert torch.equal(k[:2, :, n_real:], q[:2, :, n_real:])
    Mp = coeffs.shape[2]
    dev = smoke.fit_deviation(
        k.transpose(0, 1), q.transpose(0, 1),
        torch.arange(Mp, device=cuda).expand(13, Mp), n_real, tile)
    print(f"K1 dense F={F} tile={tile}: {dev}")
    assert smoke.fit_ok(dev), dev


@pytest.mark.parametrize("F", [8, 49])
@pytest.mark.parametrize("sblock", [32, 256, 1024])
def test_screen_kernel_matches_plain(cuda, F, sblock):
    """K2 at block widths 32, 256 and 1024 for 150 stars (two full
    groups of the kernel's 64 stars and a ragged third) on a 4000-model
    grid padded to 4096, within `chip_smoke.py`'s per-star limit
    max(1, 2e-6 S); the padding blocks alike."""
    p = _problem(4000, F, 150, 50 + F, cuda)
    tabs, cfg = p["tabs"], FitConfig()
    _, _, mg, wm = _fit_inputs(p, cfg)
    plx, plxw = TF._screen_parallax(p["plx"], p["plxe"])
    star2, srow5 = TF._screen_star_mats(mg, wm, plx, plxw)
    a = (tabs.table, tabs.maskrow, star2, srow5, F, sblock, cfg)
    k, q = TF.screen_blocks(*a), TF.screen_blocks_plain(*a)
    assert k.shape == (150, tabs.table.shape[1] // sblock)
    dev = smoke.screen_deviation(k, q, wm, mg)
    print(f"K2 F={F} sblock={sblock}: {dev}")
    assert dev["ok"], dev


_MC_PROBLEMS = {}


def _mc_problem(cuda, B=8):
    """K4's inputs from the select stage of B funnel-fit stars (made once
    per B)."""
    if B not in _MC_PROBLEMS:
        _MC_PROBLEMS[B] = _make_mc_problem(cuda, B)
    return _MC_PROBLEMS[B]


def _make_mc_problem(cuda, B):
    p = _problem(4096, 8, B, 21, cuda)
    tabs, cfg = p["tabs"], FitConfig()
    res = TF.loglike_grid_screened(
        p["flux"], p["err"], p["mask"], tabs.table, tabs.maskrow,
        tabs.n_real, tabs.aux_names, parallax=p["plx"],
        parallax_err=p["plxe"], cfg=cfg, screen_k=1024, screen_block=256)
    pcfg = PosteriorConfig(n_sel_max=512, prefilter_k=512)
    coord = torch.tensor([[204.7, -19.2]] * B, device=cuda)
    ladder = torch.linspace(0.05, 10.0, 120, device=cuda)
    prof = (ladder, torch.linspace(0.0, 1.5, 120, device=cuda).expand(B, 120),
            torch.full((B, 120), 0.2, device=cuda))
    sel = TP._select_stage(res["pack"], res["names"], res["ndim"], coord,
                           p["plx"], p["plxe"], prof, pcfg,
                           GalPriorConfig(), DustPriorConfig(), True)
    scal, dust = TP._star_scalars(coord, p["plx"], p["plxe"], prof, True)
    valid = sel["valid"].to(torch.float32)
    rm = TP._pack_row_map(res["names"])
    tab = sel["table"]
    pd = is_psd3_parts(inverse3_sym_parts(tuple(
        tab[:, rm[3 + j]] for j in range(6))))
    cf = (pcfg, GalPriorConfig(), DustPriorConfig(), True, True, True)
    return (tab, rm, valid, scal, dust), pd, cf


def _assert_mc_close(k, q, valid, pd):
    """K4 limits: the MC log-integral of positive-definite models in
    active tiles within 1e-3 (relative above 1), and every one of their
    outputs within rtol = atol = 1e-3."""
    flags = TMC.tile_flags(valid > 0.5, 512)
    active = flags.repeat_interleave(512, 1) > 0
    v = active & pd
    assert v.sum().item() > 100
    lse_k, lse_q = k[4][:, 0][v], q[4][:, 0][v]
    lse_rel = ((lse_k - lse_q).abs() / lse_q.abs().clamp(min=1.0)).max()
    far = torch.cat([(~torch.isclose(a, b, rtol=1e-3, atol=1e-3))[
        v[:, None, :].expand_as(a)] for a, b in zip(k, q)])
    print(f"K4: log-integral {lse_rel.item():.3g}, outputs outside 1e-3 "
          f"{int(far.sum())}")
    assert lse_rel.item() <= 1e-3
    assert not far.any()
    for a, b in zip(k, q):
        assert torch.equal(torch.isfinite(a), torch.isfinite(b))


def test_mc_kernel_matches_plain(cuda):
    """K4 with fed normals against its plain version (the H100 read
    2.2e-6 on the log-integral and none outside 1e-3)."""
    args, pd, cf = _mc_problem(cuda)
    K = args[0].shape[2]
    fed = dataclasses.replace(cf[0], kernel_rng=False)
    z = TP.draw_noise(0, torch.arange(8), K, fed, cuda).z
    k = TMC.mc_integrate(*args, z, 50, 512, *cf)
    flags = TMC.tile_flags(args[2] > 0.5, 512)
    q = TMC.mc_integrate_plain(*args, z, flags, 50, 512, *cf)
    _assert_mc_close(k, q, args[2], pd)


def test_mc_kernel_rng_matches_plain(cuda):
    """K4 in its random-number mode against its plain version, Philox
    normals (`rng.normals`) then `mc_integrate_plain`, to the same
    limits."""
    args, pd, cf = _mc_problem(cuda)
    K = args[0].shape[2]
    seeds = torch.tensor([[7 * b + 1, 2 ** 31 - 3 - b] for b in range(8)],
                         dtype=torch.int32, device=cuda)
    k = TMC.mc_integrate(*args, None, 50, 512, *cf, seeds=seeds)
    z = rng.normals(seeds, K, 50, TMC.nmc_pad_of(50))
    flags = TMC.tile_flags(args[2] > 0.5, 512)
    q = TMC.mc_integrate_plain(*args, z, flags, 50, 512, *cf)
    _assert_mc_close(k, q, args[2], pd)


# K4's compiled instances per mode: (use_gal, use_feh, use_loga, use_dust)
# with every combination under the Galactic prior and, without it (where
# the feh and age flags select nothing), with and without dust.
MC_FLAGS = [(g, f, a, d) for g in (1, 0) for f in ((1, 0) if g else (1,))
            for a in ((1, 0) if g else (1,)) for d in (1, 0)]


@pytest.mark.parametrize("flags", MC_FLAGS,
                         ids=["gal%d-feh%d-loga%d-dust%d" % f
                              for f in MC_FLAGS])
@pytest.mark.parametrize("mode", ["fed", "rng"])
def test_mc_kernel_instances_match_plain(cuda, mode, flags):
    """K4 at the funnel's 128 stars with the path's skip tile of 512 and
    n_mc=50 (6 padding draw rows), in every compiled instance (mode x
    prior flags), against its plain version to the limits of
    `_assert_mc_close`."""
    use_gal, use_feh, use_loga, use_dust = (bool(x) for x in flags)
    args, pd, cf = _mc_problem(cuda, 128)
    cf = cf[:3] + (use_feh, use_loga, use_dust, use_gal)
    K = args[0].shape[2]
    pcfg = dataclasses.replace(cf[0], kernel_rng=mode == "rng")
    noise = TP.draw_noise(5, torch.arange(128), K, pcfg, cuda)
    before = TMC.KERNELS["mc_" + mode].launches
    k = TMC.mc_integrate(*args, noise.z, 50, 512, *cf, seeds=noise.seeds)
    assert TMC.KERNELS["mc_" + mode].launches == before + 1
    z = noise.z if mode == "fed" else rng.normals(noise.seeds, K, 50,
                                                   TMC.nmc_pad_of(50))
    flags_t = TMC.tile_flags(args[2] > 0.5, 512)
    q = TMC.mc_integrate_plain(*args, z, flags_t, 50, 512, *cf)
    _assert_mc_close(k, q, args[2], pd)


# The draws kernel's cases, `(B, K, n_mc, n_draws, normals layout)`: the
# funnel's batch in each layout and the dense engine's in its own (the
# cells' shapes), then ragged ones: one star, K and n_mc that fill no
# block of the kernel, and few MC rows.
DRAW_CASES = ([(128, 2048, 50, 250, z) for z in (None, "mc", "grid")]
              + [(16, 2048, 50, 250, "grid")]
              + [s + (z,) for s in ((1, 37, 12, 5), (5, 1000, 12, 250),
                                    (3, 301, 13, 31))
                 for z in (None, "mc", "grid")])
# Rows at and above 2**32 and seeds with the high bit of 64 set.
DRAW_ROW0 = (0, 2 ** 32 - 2, 2 ** 40 + 7)
DRAW_SEEDS = (0, 2 ** 63 + 12345, 2 ** 64 - 1)


def _plain_draws(seed, rows, K, n_mc, n_draws, z):
    keys = rng.star_keys(seed, rows)
    return (keys, *rng.posterior_draws(keys, K, n_mc, n_draws, z=z,
                                       nmc_pad=TMC.nmc_pad_of(n_mc)))


@pytest.mark.parametrize("case", DRAW_CASES,
                         ids=["x".join(map(str, c[:4])) + f"-{c[4]}"
                              for c in DRAW_CASES])
def test_draws_kernel_matches_plain(cuda, case):
    """The posterior's draws in one launch (`rng.draws`, `csrc/draws.cu`)
    equal the plain `star_keys` + `posterior_draws` bit for bit on every
    output (keys, normals, uniforms, Gumbel noise), in each normals
    layout, for rows past 2**32 and seeds with the high bit set."""
    B, K, n_mc, n_draws, z = case
    for row0, seed in zip(DRAW_ROW0, DRAW_SEEDS):
        rows = torch.arange(row0, row0 + 3 * B, 3, device=cuda)
        before = TMC.KERNELS["draws"].launches
        got = rng.draws(seed, rows, K, n_mc, n_draws, z=z,
                        nmc_pad=TMC.nmc_pad_of(n_mc))
        assert TMC.KERNELS["draws"].launches == before + 1
        want = _plain_draws(seed, rows, K, n_mc, n_draws, z)
        for name, g, w in zip(("keys", "z", "u", "gumbel"), got, want):
            if w is None:
                assert g is None, name
                continue
            assert g.shape == w.shape and g.dtype == w.dtype, name
            assert g.is_contiguous(), name
            assert torch.equal(g, w), (name, row0, seed, int(
                (g != w).sum()))


@pytest.mark.parametrize("grid,kernel_rng", [(False, True), (False, False),
                                             (True, True)])
def test_draw_noise_is_one_launch(cuda, grid, kernel_rng):
    """`draw_noise` on the card launches the draws kernel once and no
    other hand-written kernel, for rows handed in on the host (as the
    one-star `fitting.lnpost` hands them) or on the card, and gives the
    plain version's draws."""
    from brutus_tpu_torch.ops import _native
    cfg = dataclasses.replace(PosteriorConfig(), kernel_rng=kernel_rng)
    for rows in (torch.arange(5, 9), torch.arange(5, 9, device=cuda)):
        _native.reset_launches()
        noise = TP.draw_noise(11, rows, 2048, cfg, cuda, grid=grid)
        launches = {k: v.launches for k, v in _native.KERNELS.items()}
        assert launches == dict({k: 0 for k in launches}, draws=1)
        z = "grid" if grid else (None if kernel_rng else "mc")
        keys, *want = _plain_draws(11, rows.to(cuda), 2048, cfg.n_mc_prior,
                                   cfg.n_draws, z)
        for g, w in zip(noise, want + [None if z else keys]):
            assert (g is None and w is None) or torch.equal(g, w)


def _mesh_rank(rank, rdv, out_dir):
    """A rank of `test_funnel_model_mesh_two_ranks_on_one_card`: the
    funnel case of `tests/test_torch_parallel.py` on a 1 x 2 mesh, both
    ranks on card 0 over gloo."""
    import datetime
    import pickle
    import torch.distributed as dist
    from brutus_tpu_torch import BruteForce
    from brutus_tpu_torch.ops import _native
    from brutus_tpu_torch.parallel import make_mesh
    import test_torch_parallel as TPL
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=2,
                            timeout=datetime.timedelta(seconds=240))
    bf_args, args, kw, _ = TPL.fit_case("funnel_model_mesh")
    mesh = make_mesh(1, 2, devices=["cuda:0"] * 2)
    _native.reset_launches()
    out = BruteForce(*bf_args, device="cuda").fit(*args, mesh=mesh, **kw)
    launches = {k: v.launches for k, v in _native.KERNELS.items()}
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump((out, launches, mesh.transport()), f)
    dist.destroy_process_group()


def test_funnel_model_mesh_two_ranks_on_one_card(cuda, tmp_path):
    """The funnel case of `tests/test_torch_parallel.py` on a 1 x 2 mesh,
    two ranks on one card over gloo (CUDA tensors staged through host
    memory; NCCL refuses two ranks on one device): each rank launches
    K2, K3, K1 and K4 on its half of the grid and the merged
    shortlists, and every output equals the single-process run on the
    card bit for bit, on both ranks."""
    import pickle
    from brutus_tpu_torch import BruteForce
    from brutus_tpu_torch.ops import _native
    import test_torch_parallel as TPL
    _native.build()                  # once, before the ranks load it
    TPL.spawn_world(_mesh_rank, 2, (str(tmp_path / "rdv"), str(tmp_path)),
                    TPL.WORLD_TIMEOUT)
    bf_args, args, kw, _ = TPL.fit_case("funnel_model_mesh")
    ref = BruteForce(*bf_args, device="cuda").fit(*args, **kw)
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out, launches, transport = pickle.load(f)
        print(f"rank {r}: launches {launches}, transport {transport}")
        for k in ("screen", "gather", "fit", "mc_rng"):
            assert launches[k] > 0, (r, k)
        assert set(out) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
