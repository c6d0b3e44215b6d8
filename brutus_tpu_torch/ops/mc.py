"""
Monte-Carlo integration of the posterior (mirrors
`brutus_tpu/ops/pallas_mc.py`).

K4 replaces `pallas_mc.py:101 _make_mc_kernel` (wrapper `mc_integrate`):
for every (star, selected model) it repairs and factors the (s, Av, Rv)
covariance, draws `n_mc` samples, and integrates the Galactic, dust and
parallax priors over them with an online logsumexp.  The CUDA kernel is
`csrc/mc.cu`; `mc_integrate_plain` below is the same function in
PyTorch, which the CPU path and the tests use.  Like the TPU kernel it
has two modes: fed normals (`z`), and random numbers made inside the
kernel from per-star `seeds` (Philox, see `rng.py`), whose plain
version is `rng.normals` followed by `mc_integrate_plain`.  The fit
feeds `rng.normals` of the same star keys, so both modes draw the same
normals.

Cite: reference brutus/fitting.py:1068-1098 (MC prior integration),
brutus/pdf.py:476-749 (gal prior), brutus/pdf.py:752-840 (dust prior),
brutus/pdf.py:144-175 (parallax prior).
"""

import math
from functools import lru_cache

import torch

from ..config import PosteriorConfig, GalPriorConfig, DustPriorConfig
from ..coords import _T
from ..priors import age_prior_consts
from ..utils import psd_repair_parts, cholesky3_parts
from ._native import KERNELS, check
from . import rng

NEG_BIG = -1e30
LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
NL_PAD = 128                 # dust-ladder rungs the kernel holds
N_SCALARS = 10               # v0 v1 v2 | pm pw pln | d0 1/dx covered umax
N_AGG = 8                    # lse, in-bounds count, 6 covariance parts


def _age_consts(gal_cfg, feh_mean):
    """Constants of the truncated-normal age prior of one Galactic
    component: `(mean, sigma, lo, hi, lndenom)` (reference
    `brutus/pdf.py:410-473`)."""
    c = gal_cfg
    mu, sig, a, b = age_prior_consts(
        feh_mean, max_age=c.max_age, min_age=c.min_age,
        feh_age_ctr=c.feh_age_ctr, feh_age_scale=c.feh_age_scale,
        nsigma_from_max_age=c.nsigma_from_max_age,
        max_sigma=c.max_sigma, min_sigma=c.min_sigma)
    lndenom = (math.log(sig / 2.0)
               + math.log(math.erf(b / math.sqrt(2.0))
                          - math.erf(a / math.sqrt(2.0))))
    return mu, sig, sig * a + mu, sig * b + mu, lndenom


def _gal_consts(g: GalPriorConfig):
    rp_sol = math.sqrt(g.R_solar ** 2 + g.Z_solar ** 2 + g.r_q_halo ** 2)
    q_sol = g.q_halo_inf - (g.q_halo_inf - g.q_halo_ctr) * math.exp(
        1.0 - rp_sol / g.r_q_halo)
    reff_sol = math.sqrt(g.R_solar ** 2 + (g.Z_solar / q_sol) ** 2
                         + g.Rs_halo ** 2)
    comps = [(g.feh_thin, g.feh_thin_sigma), (g.feh_thick, g.feh_thick_sigma),
             (g.feh_halo, g.feh_halo_sigma)]
    return reff_sol, comps, [_age_consts(g, mu) for mu, _ in comps]


@lru_cache(maxsize=16)
def _mc_params(cfg, gal_cfg, dust_cfg, device):
    """Float constants in the order of `csrc/mc.cu`'s `prm` enum."""
    g, d = gal_cfg, dust_cfg
    reff_sol, comps, ages = _gal_consts(g)
    w = cfg.psd_width
    vals = [cfg.avlim[0], cfg.avlim[1], cfg.rvlim[0], cfg.rvlim[1],
            w, 1.0 / w ** 2, w ** 2, cfg.mvn_eps,
            float(_T[0]), float(_T[1]), float(_T[2]),
            g.R_solar, abs(g.Z_solar), g.R_thin, g.Z_thin, g.Rs_thin ** 2,
            g.R_thick, g.Z_thick, g.Rs_thick ** 2, g.r_q_halo,
            g.r_q_halo ** 2, g.q_halo_inf, g.q_halo_inf - g.q_halo_ctr,
            g.Rs_halo ** 2, -g.eta_halo, reff_sol, math.log(g.f_thick),
            math.log(g.f_halo)]
    vals += [mu for mu, _ in comps]
    vals += [sig ** 2 for _, sig in comps]
    vals += [0.5 * math.log(2.0 * math.pi * sig ** 2) for _, sig in comps]
    for j in range(5):
        vals += [a[j] for a in ages]
    vals += [d.scale, d.offset, d.smooth * d.scale, d.scatter ** 2]
    return torch.tensor(vals, dtype=torch.float32, device=device)


def tile_flags(valid, tile):
    """(B, K // tile) int32: 1 where a model tile holds a valid model,
    or where the star has no valid model at all (its chi2-fallback
    resampling reads every model); inactive tiles are skipped."""
    B, K = valid.shape
    tile_any = valid.reshape(B, K // tile, tile).any(-1)
    star_dead = ~valid.any(1)
    return (tile_any | star_dead[:, None]).to(torch.int32).contiguous()


def mc_integrate_plain(tab, row_map, valid, scal, dust, z, flags, n_mc,
                       tile, cfg: PosteriorConfig, gal_cfg: GalPriorConfig,
                       dust_cfg: DustPriorConfig, use_feh, use_loga,
                       use_dust, use_gal=True):
    """Plain version of K4 (mirrors `pallas_mc.py:101-370`)."""
    B, _, K = tab.shape
    nmc_pad = z.shape[2]
    g = gal_cfg
    reff_sol, comps, ages = _gal_consts(g)
    t0, t1, t2 = (float(x) for x in _T)
    avmin, avmax = cfg.avlim
    rvmin, rvmax = cfg.rvlim
    row = lambda i: tab[:, row_map[i], :][:, None, :]      # (B, 1, K)
    sc = lambda i: scal[:, i][:, None, None]               # (B, 1, 1)

    mean_s, mean_a, mean_r = row(0), row(1), row(2)
    icov_p = tuple(row(3 + j) for j in range(6))
    validm = valid[:, None, :] > 0.5
    cov_p = psd_repair_parts(icov_p, mean_s, validm, cfg.psd_width,
                             cfg.psd_max_passes, mvn_eps=cfg.mvn_eps)
    L00, L10, L11, L20, L21, L22 = cholesky3_parts(cov_p)
    z0, z1, z2 = z[:, 0], z[:, 1], z[:, 2]                 # (B, nmc, K)
    s = mean_s + L00 * z0
    a = mean_a + L10 * z0 + L11 * z1
    r = mean_r + L20 * z0 + L21 * z1 + L22 * z2
    par = torch.sqrt(torch.clamp(s, min=1e-30))
    dist = 1.0 / par

    lnp = torch.zeros_like(s)
    if use_gal:
        X = dist * sc(0) + t0
        Y = dist * sc(1) + t1
        Zg = dist * sc(2) + t2
        R2 = X * X + Y * Y
        vol = 2.0 * torch.log(dist)
        z_sol = abs(g.Z_solar)
        lt = -((torch.sqrt(R2 + g.Rs_thin ** 2) - g.R_solar) / g.R_thin
               + (torch.abs(Zg) - z_sol) / g.Z_thin) + vol
        lk = -((torch.sqrt(R2 + g.Rs_thick ** 2) - g.R_solar) / g.R_thick
               + (torch.abs(Zg) - z_sol) / g.Z_thick) \
            + vol + math.log(g.f_thick)
        rp = torch.sqrt(R2 + Zg * Zg + g.r_q_halo ** 2)
        q = g.q_halo_inf - (g.q_halo_inf - g.q_halo_ctr) \
            * torch.exp(1.0 - rp / g.r_q_halo)
        reff_h = torch.sqrt(R2 + (Zg / q) ** 2 + g.Rs_halo ** 2)
        lh = -g.eta_halo * torch.log(reff_h / reff_sol) + vol \
            + math.log(g.f_halo)
        mx = torch.maximum(torch.maximum(lt, lk), lh)
        lnden = mx + torch.log(torch.exp(lt - mx) + torch.exp(lk - mx)
                               + torch.exp(lh - mx))
        lnp = lnp + lnden
        lw = [lt - lnden, lk - lnden, lh - lnden]

        def mix(terms):
            m = torch.maximum(torch.maximum(terms[0], terms[1]), terms[2])
            return m, torch.log(torch.exp(terms[0] - m)
                                + torch.exp(terms[1] - m)
                                + torch.exp(terms[2] - m))

        if use_feh:
            feh = row(9)
            feh_g = [(-0.5 * ((mu - feh) ** 2 / sig ** 2)
                      - 0.5 * math.log(2.0 * math.pi * sig ** 2))
                     for mu, sig in comps]
            mf, lse3 = mix([feh_g[i] + lw[i] for i in range(3)])
            lnp = lnp + mf + lse3
        if use_loga:
            age = torch.exp(math.log(10.0) * row(10)) * 1e-9
            age_g = []
            for mu_a, sig_a, lo, hi, lden in ages:
                xi = (age - mu_a) / sig_a
                ans = -LOG_SQRT_2PI - 0.5 * xi * xi - lden
                age_g.append(torch.where((age < lo) | (age > hi),
                                         torch.full_like(ans, NEG_BIG),
                                         ans))
            ma, lse3 = mix([age_g[i] + lw[i] for i in range(3)])
            lnp = lnp + ma + lse3

    if use_dust:
        u = torch.clamp((dist - sc(6)) * sc(7), min=0.0)
        u = torch.minimum(u, sc(9))
        lo = torch.clamp(torch.floor(u), max=NL_PAD - 1).long()
        hi = torch.clamp(lo + 1, max=NL_PAD - 1)
        w_lo = torch.clamp(1.0 - torch.abs(u - lo.to(u.dtype)), min=0.0)
        w_hi = torch.where(hi > lo, torch.clamp(
            1.0 - torch.abs(u - hi.to(u.dtype)), min=0.0),
            torch.zeros_like(u))
        take = lambda col, i: torch.gather(
            dust[:, col, :], 1, i.reshape(B, -1)).reshape(i.shape)
        mean_i = w_lo * take(0, lo) + w_hi * take(0, hi)
        std_i = w_lo * take(1, lo) + w_hi * take(1, hi)
        mean_d = dust_cfg.scale * mean_i + dust_cfg.offset
        err2 = ((dust_cfg.smooth * dust_cfg.scale * std_i) ** 2
                + dust_cfg.scatter ** 2)
        dpdf = -0.5 * ((a - mean_d) ** 2 / err2
                       + torch.log(2.0 * math.pi * err2))
        lnp = lnp + torch.where(sc(8) > 0.5, dpdf, torch.zeros_like(dpdf))

    lnp = lnp - 0.5 * ((par - sc(3)) ** 2 * sc(4) + sc(5))
    rows = torch.arange(nmc_pad, device=tab.device)[None, :, None]
    inb = ((s >= 1e-20) & (a >= avmin) & (a <= avmax) & (r >= rvmin)
           & (r <= rvmax) & (rows < n_mc))
    lnp = torch.where(inb & torch.isfinite(lnp), lnp,
                      torch.full_like(lnp, NEG_BIG))

    # online logsumexp over chunks of 8 draws, as the TPU kernel sums
    m_acc = torch.full((B, 1, K), NEG_BIG, dtype=tab.dtype,
                       device=tab.device)
    s_acc = torch.zeros_like(m_acc)
    for c in range(0, nmc_pad, 8):
        ch = lnp[:, c:c + 8]
        nmax = torch.maximum(m_acc, ch.amax(1, keepdim=True))
        s_acc = s_acc * torch.exp(m_acc - nmax) + torch.exp(
            ch - nmax).sum(1, keepdim=True)
        m_acc = nmax
    lse = m_acc + torch.log(torch.clamp(s_acc, min=1e-37))
    n_acc = inb.to(tab.dtype).sum(1, keepdim=True)
    agg = torch.cat([lse, n_acc] + list(cov_p), dim=1)

    # skipped tiles write fixed constants
    act = flags.repeat_interleave(tile, dim=1)[:, None, :] > 0
    lnp = torch.where(act, lnp, torch.full_like(lnp, NEG_BIG))
    dist = torch.where(act, dist, torch.ones_like(dist))
    a = torch.where(act, a, torch.zeros_like(a))
    r = torch.where(act, r, torch.zeros_like(r))
    skip_agg = torch.zeros_like(agg)
    skip_agg[:, 0] = NEG_BIG
    agg = torch.where(act, agg, skip_agg)
    return lnp, dist, a, r, agg


def nmc_pad_of(n_mc):
    """Draw rows of the MC outputs: `n_mc` rounded up to 8."""
    return -(-n_mc // 8) * 8


def mc_integrate(tab, row_map, valid, scal, dust, z, n_mc, tile,
                 cfg: PosteriorConfig, gal_cfg: GalPriorConfig,
                 dust_cfg: DustPriorConfig, use_feh, use_loga, use_dust,
                 use_gal=True, seeds=None):
    """K4: MC integration of the priors over each selected model.

    tab : (B, n_rows, K) gathered fit pack, read through `row_map`
    (indices of scale, av, rv, the 6 precision parts, feh, loga);
    valid : (B, K) float 0/1; scal : (B, 10) per-star scalars; dust :
    (B, 2, 128) ladder mean | std.  The draws come from exactly one of
    `z` (B, 3, nmc_pad, K) standard normals (rows from `n_mc` on are
    padding) and `seeds` (B, 2) int32, the Philox keys of the
    random-number mode (`rng.normals` gives its normals).  Model tiles
    of `tile` columns without a valid model are skipped.

    Returns `(lnmc, dist, red, dred)` each (B, nmc_pad, K) and `agg`
    (B, 8, K) = [logsumexp over draws, in-bounds count, repaired
    covariance parts c00, c11, c22, c01, c02, c12].
    """
    if (z is None) == (seeds is None):
        raise ValueError("mc_integrate takes exactly one of z and seeds")
    B, n_rows, K = tab.shape
    nmc_pad = nmc_pad_of(n_mc) if z is None else z.shape[2]
    t = tile
    while K % t:
        t //= 2
    flags = tile_flags(valid > 0.5, t)
    if tab.device.type == "cpu":
        if z is None:
            z = rng.normals(seeds, K, n_mc, nmc_pad)
        return mc_integrate_plain(tab, row_map, valid, scal, dust, z,
                                  flags, n_mc, t, cfg, gal_cfg, dust_cfg,
                                  use_feh, use_loga, use_dust, use_gal)
    dev = tab.device
    check(tab, "tab", device=dev)
    check(valid, "valid", (B, K), device=dev)
    check(scal, "scal", (B, N_SCALARS), device=dev)
    check(dust, "dust", (B, 2, NL_PAD), device=dev)
    if z is not None:
        check(z, "z", (B, 3, nmc_pad, K), device=dev)
    else:
        check(seeds, "seeds", (B, 2), dtype=torch.int32, device=dev)
    if nmc_pad % 8 or nmc_pad < n_mc:
        raise ValueError("z must carry a multiple of 8 draw rows >= n_mc")
    prm = _mc_params(cfg, gal_cfg, dust_cfg, dev)
    iprm = torch.tensor(list(row_map) + [int(use_feh), int(use_loga),
                                         int(use_dust), int(use_gal),
                                         cfg.psd_max_passes],
                        dtype=torch.int32, device=dev)
    shp = (B, nmc_pad, K)
    lnmc, dist, red, dred = (torch.empty(shp, dtype=torch.float32,
                                         device=dev) for _ in range(4))
    agg = torch.empty((B, N_AGG, K), dtype=torch.float32, device=dev)
    KERNELS["mc_fed" if seeds is None else "mc_rng"](
        tab, valid, scal, dust, z, seeds, flags, prm, iprm, lnmc, dist, red,
        dred, agg, B, K, n_rows, n_mc, nmc_pad, t, prm.numel())
    return lnmc, dist, red, dred, agg


__all__ = ["mc_integrate", "mc_integrate_plain", "tile_flags", "nmc_pad_of",
           "NL_PAD", "N_SCALARS", "NEG_BIG"]
