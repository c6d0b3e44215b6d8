"""
Posterior selection, Monte-Carlo integration and resampling, batched
over stars (mirrors `brutus_tpu/ops/posterior.py`; reference
`brutus/fitting.py:823-1107` and the resampling tail of `_fit`,
`brutus/fitting.py:2024-2061`).

The stage reads the fit kernel's stacked pack: the likelihood-rank
prefilter gathers whole pack columns, the Galactic and dust priors and
the two relative-weight culls run in PyTorch, the MC kernel (K4, see
`mc.py`) reads the gathered pack through a row map, and resampling uses
plain indexing (the JAX package's one-hot matmuls only avoided slow
gathers on the TPU and give identical values).

All randomness comes in through `Noise`: the MC normals, the uniforms of
the inverse-CDF model draws and the Gumbel noise of the per-draw pick.
`draw_noise` makes them on the device from a `torch.Generator`; tests
hand in the JAX package's own draws instead.
"""

import collections
import math

import torch

from ..config import PosteriorConfig, GalPriorConfig, DustPriorConfig
from ..coords import _M
from ..priors import gal_lnprior, dust_lnprior, scale_parallax_lnprior
from ..utils import sym3_from_parts
from .mc import mc_integrate, NL_PAD

NEG_BIG = -1e30
# NEG_BIG is finite, so validity is a threshold, not `isfinite`.
VALID_MIN = 0.5 * NEG_BIG

Noise = collections.namedtuple("Noise", "z u gumbel")
Noise.__doc__ = """Random inputs of `lnpost_batch`: `z` (B, 3, nmc_pad, K)
standard normals (rows from n_mc on are zero), `u` (B, n_draws)
uniforms in [0, 1), `gumbel` (B, n_draws, n_mc) standard Gumbel."""


def _is_valid(x):
    return torch.isfinite(x) & (x > VALID_MIN)


def _nmc_pad(n_mc):
    return -(-n_mc // 8) * 8


def draw_noise(generator, B, K, cfg: PosteriorConfig, device):
    """The random inputs of one batch, drawn on `device`."""
    nmc = cfg.n_mc_prior
    z = torch.zeros((B, 3, _nmc_pad(nmc), K), dtype=torch.float32,
                    device=device)
    z[:, :, :nmc] = torch.randn((B, 3, nmc, K), generator=generator,
                                device=device)
    u = torch.rand((B, cfg.n_draws), generator=generator, device=device)
    e = torch.empty((B, cfg.n_draws, nmc), device=device).exponential_(
        generator=generator)
    return Noise(z, u, -torch.log(e))


def _categorical_cdf(u, logits, n):
    """`n` categorical draws per row by inverse-CDF sampling (mirrors
    `posterior._categorical_cdf`): u (B, n) uniforms, logits (B, K)."""
    wt = torch.softmax(logits, dim=1)
    cdf = torch.cumsum(wt, dim=1)
    v = (u * cdf[:, -1:]).contiguous()
    idx = torch.searchsorted(cdf.contiguous(), v, side="left")
    return torch.clamp(idx, 0, logits.shape[1] - 1)


def _cull_mask(lnp, wt_thresh, cdf_thresh, base_mask=None):
    """Relative-weight (or CDF) threshold culling per star (mirrors
    `posterior._cull_mask`; reference `brutus/fitting.py:987-1022`)."""
    if base_mask is not None:
        lnp = torch.where(base_mask, lnp, torch.full_like(lnp, -math.inf))
    if wt_thresh is not None:
        thr = torch.clamp(lnp.amax(1, keepdim=True) + math.log(wt_thresh),
                          min=VALID_MIN)
        mask = lnp > thr
    else:
        order = torch.sort(-lnp, dim=1, stable=True).indices
        prob = torch.softmax(torch.gather(lnp, 1, order), dim=1)
        cdf = torch.cumsum(prob, dim=1)
        keep_sorted = (cdf - prob) <= (1.0 - cdf_thresh)
        mask = torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)
        mask = mask & (lnp > VALID_MIN)
    if base_mask is not None:
        mask = mask & base_mask
    return mask


def _top_k(key, k):
    """Indices of the `k` largest entries per row, best first, ties to
    the lower index (XLA's `top_k` order)."""
    return torch.sort(key, dim=1, descending=True, stable=True).indices[:, :k]


def _pack_row_map(pack_names):
    """Rows of scale, av, rv, the 6 precision parts, feh, loga in the
    pack (the MC kernel's `row_map`)."""
    col = {n: i for i, n in enumerate(pack_names)}
    return (col["scale"], col["av"], col["rv"],
            col["i00"], col["i11"], col["i22"],
            col["i01"], col["i02"], col["i12"],
            col.get("feh", 0), col.get("loga", 0))


def _pack_usable(cfg: PosteriorConfig, M):
    """Whether the likelihood-rank prefilter runs (it gathers whole pack
    columns, model by model)."""
    return bool(cfg.prefilter_k) and cfg.prefilter_k < M


def selection_size(cfg: PosteriorConfig, M):
    """Models kept per star by the select stage from an `M`-wide pack
    (the MC normals' K axis)."""
    K = min(cfg.n_sel_max, M)
    return min(K, cfg.prefilter_k) if _pack_usable(cfg, M) else K


def _select_stage(pack, names, ndim, coord, parallax, parallax_err,
                  dust_profile, cfg, gal_cfg, dust_cfg, apply_av_prior):
    """Culls + priors + top-K selection of every star (mirrors
    `posterior._select_stage`, the kernel-pack path and the path without
    a prefilter).  pack : (B, n_rows, M)."""
    col = {n: i for i, n in enumerate(names)}
    B, _, M = pack.shape
    plx, plxe = parallax[:, None], parallax_err[:, None]

    def lnprob_of(p):
        scale_err = 1.0 / torch.sqrt(torch.abs(p[:, col["i00"]]))
        lp = p[:, col["lnlike"]] + scale_parallax_lnprior(
            p[:, col["scale"]], scale_err, plx, plxe)
        return torch.where(torch.isfinite(lp), lp,
                           torch.full_like(lp, NEG_BIG))

    lnprob = lnprob_of(pack)
    lnprob_max = lnprob.amax(1, keepdim=True)
    K = selection_size(cfg, M)
    if _pack_usable(cfg, M):
        K1 = cfg.prefilter_k
        if cfg.prefilter_bf16:
            key = torch.clamp(lnprob - lnprob_max, min=-3e4).to(
                torch.bfloat16).to(torch.float32)
        else:
            key = lnprob
        pre_idx = _top_k(key, K1)
        packed = torch.gather(pack, 2, pre_idx[:, None, :].expand(
            B, pack.shape[1], K1))
        lnprob = lnprob_of(packed)
    else:
        packed = pack
    g = lambda n: packed[:, col[n]]
    lnlike, scale, av = g("lnlike"), g("scale"), g("av")
    lnprior_grid = g("lnprior")
    feh = g("feh") if "feh" in col else None
    loga = g("loga") if "loga" in col else None

    if cfg.wt_thresh is not None:
        mask1 = lnprob > torch.clamp(lnprob_max + math.log(cfg.wt_thresh),
                                     min=VALID_MIN)
    else:
        mask1 = _cull_mask(lnprob, None, cfg.cdf_thresh)
    dist = 1.0 / torch.sqrt(torch.clamp(scale, min=1e-30))
    lnp_mle = lnlike + lnprior_grid
    lnp_mle = lnp_mle + gal_lnprior(dist, coord, feh=feh, loga=loga,
                                    cfg=gal_cfg)
    if apply_av_prior and dust_profile is not None:
        av_dist, av_mean, av_std = dust_profile
        lnp_mle = lnp_mle + dust_lnprior(dist, av, av_dist, av_mean,
                                         av_std, dust_cfg)
    lnp_mle = torch.where(mask1 & _is_valid(lnp_mle), lnp_mle,
                          torch.full_like(lnp_mle, NEG_BIG))
    mask2 = _cull_mask(lnp_mle, cfg.wt_thresh, cfg.cdf_thresh,
                       base_mask=mask1)
    score = torch.where(mask2, lnlike + lnprior_grid,
                        torch.full_like(lnlike, -math.inf))
    if K == score.shape[1]:
        lnp_sel, table = score, packed
    else:
        sel = _top_k(score, K)
        lnp_sel = torch.gather(score, 1, sel)
        table = torch.gather(packed, 2, sel[:, None, :].expand(
            B, packed.shape[1], K))
    valid = _is_valid(lnp_sel)
    lnp_sel = torch.where(valid, lnp_sel, torch.full_like(lnp_sel,
                                                          NEG_BIG))
    t = lambda n: table[:, col[n]]
    scale_k, chi2_k = t("scale"), t("chi2")

    have = torch.isfinite(parallax) & torch.isfinite(parallax_err)
    perr = torch.where(have, parallax_err, torch.ones_like(parallax_err))
    chi2_k = chi2_k + torch.where(
        have[:, None], (torch.sqrt(scale_k) - plx) ** 2 / perr[:, None] ** 2,
        torch.zeros_like(chi2_k))
    ndim_out = ndim + have.to(ndim.dtype)
    inf = torch.full_like(chi2_k, math.inf)
    chi2_fin = torch.where(torch.isfinite(chi2_k), chi2_k, inf)
    chi2min_v = torch.where(valid, chi2_fin, inf).amin(1)
    chi2min = torch.where(torch.isfinite(chi2min_v), chi2min_v,
                          chi2_fin.amin(1))
    sel_gidx = torch.round(t("gidx")).to(torch.int32)
    return dict(table=table.contiguous(), lnp_sel=lnp_sel, valid=valid,
                scale_k=scale_k, av_k=t("av"), rv_k=t("rv"),
                chi2_k=chi2_k, ndim=ndim_out, chi2min=chi2min,
                sel_gidx=sel_gidx, has_feh=feh is not None,
                has_loga=loga is not None)


def _star_scalars(coord, parallax, parallax_err, dust_profile, use_dust):
    """Per-star scalars of the MC kernel `(B, 10)` and its dust ladder
    `(B, 2, 128)` (mirrors `_batch_fns.pre`, posterior.py:599-704)."""
    B = coord.shape[0]
    dev = coord.device
    f32 = torch.float32
    lr = torch.deg2rad(coord[:, 0])
    br = torch.deg2rad(coord[:, 1])
    cb = torch.cos(br)
    uvec = torch.stack([cb * torch.cos(lr), cb * torch.sin(lr),
                        torch.sin(br)], dim=1).to(f32)
    v = uvec @ torch.as_tensor(_M, dtype=f32, device=dev).T     # (B, 3)
    have = (torch.isfinite(parallax) & torch.isfinite(parallax_err)
            & (parallax_err > 0))
    perr = torch.where(have, parallax_err, torch.ones_like(parallax_err))
    zero = torch.zeros_like(parallax)
    pm = torch.where(have, parallax, zero)
    pw = torch.where(have, 1.0 / perr ** 2, zero)
    pln = torch.where(have, torch.log(2.0 * math.pi * perr ** 2), zero)
    dust = torch.zeros((B, 2, NL_PAD), dtype=f32, device=dev)
    if use_dust:
        av_dist, av_mean, av_std = dust_profile
        nl = av_mean.shape[1]
        if nl > NL_PAD:
            raise ValueError(
                f"dust ladder has {nl} rungs > NL_PAD={NL_PAD}; resample "
                f"with dustmap.uniform_profile(n={NL_PAD})")
        covered = torch.all(torch.isfinite(av_mean) & torch.isfinite(av_std),
                            dim=1).to(f32)
        dust[:, 0, :nl] = torch.where(torch.isfinite(av_mean), av_mean,
                                      torch.zeros_like(av_mean))
        dust[:, 1, :nl] = torch.where(torch.isfinite(av_std), av_std,
                                      torch.ones_like(av_std))
        d0 = av_dist[0].expand(B)
        idx_s = (1.0 / (av_dist[1] - av_dist[0])).expand(B)
        umax = torch.full((B,), float(nl - 1), dtype=f32, device=dev)
    else:
        covered, d0, umax = zero, zero, zero
        idx_s = torch.ones_like(zero)
    scal = torch.stack([v[:, 0], v[:, 1], v[:, 2], pm, pw, pln, d0, idx_s,
                        covered, umax], dim=1).to(f32).contiguous()
    return scal, dust


def lnpost_batch(pack, names, ndim, coord, noise: Noise, parallax=None,
                 parallax_err=None, dust_profile=None,
                 cfg: PosteriorConfig = PosteriorConfig(),
                 gal_cfg: GalPriorConfig = GalPriorConfig(),
                 dust_cfg: DustPriorConfig = DustPriorConfig(),
                 apply_av_prior=True, tile=512):
    """Posterior weights and `(dist, Av, Rv)` draws for a batch of stars
    (mirrors `posterior.lnpost_batch` with the built-in priors).

    pack : (B, n_rows, M) stacked fit output with row names `names`
    (`funnel.pack_row_names`; must hold `lnprior`, and `feh`/`loga` to
    apply those mixtures); ndim : (B,); coord : (B, 2) galactic degrees;
    dust_profile : `(av_dist (Nd,), av_mean (B, Nd), av_std (B, Nd))`
    on a uniform ladder of at most 128 rungs.

    Returns per-draw `(B, n_draws)` fields `model_idx, scale, av, rv,
    lnprob, dist, red, dred, logwt` and `cov_sar (B, n_draws, 3, 3)`,
    and per-star `log_evidence, chi2min, ndim`.
    """
    B = pack.shape[0]
    dev = pack.device
    nan = torch.full((B,), math.nan, dtype=torch.float32, device=dev)
    parallax = nan if parallax is None else parallax.to(dev, torch.float32)
    parallax_err = (nan if parallax_err is None
                    else parallax_err.to(dev, torch.float32))
    coord = coord.to(dev, torch.float32)
    use_dust = dust_profile is not None and apply_av_prior
    sel = _select_stage(pack, names, ndim, coord, parallax, parallax_err,
                        dust_profile, cfg, gal_cfg, dust_cfg,
                        apply_av_prior)
    scal, dust = _star_scalars(coord, parallax, parallax_err, dust_profile,
                               use_dust)
    nmc = cfg.n_mc_prior
    valid = sel["valid"]
    lnmc, dist_k, red_k, dred_k, agg = mc_integrate(
        sel["table"], _pack_row_map(names), valid.to(torch.float32), scal,
        dust, noise.z.contiguous(), nmc, tile, cfg, gal_cfg, dust_cfg,
        use_feh=sel["has_feh"], use_loga=sel["has_loga"],
        use_dust=use_dust)

    lnp_sel = sel["lnp_sel"] + agg[:, 0] - torch.log(
        torch.clamp(agg[:, 1], min=1.0))
    lnp_sel = torch.where(valid & _is_valid(lnp_sel) & (agg[:, 1] > 0),
                          lnp_sel, torch.full_like(lnp_sel, NEG_BIG))
    log_evid = torch.logsumexp(lnp_sel, dim=1)
    chi2_k = sel["chi2_k"]
    chi2_draw = torch.where(torch.isfinite(chi2_k), chi2_k,
                            torch.full_like(chi2_k, 1e30))
    any_ok = _is_valid(lnp_sel).any(1, keepdim=True)
    logits = torch.where(any_ok, lnp_sel, -0.5 * chi2_draw)
    idxs = _categorical_cdf(noise.u, logits, cfg.n_draws)    # (B, nd)

    take = lambda x: torch.gather(x, 1, idxs)
    # (B, nmc, K) draw fields at the drawn models -> (B, nd, nmc)
    at = lambda x: torch.gather(x[:, :nmc], 2, idxs[:, None, :].expand(
        B, nmc, idxs.shape[1])).transpose(1, 2)
    lr = at(lnmc)
    imc = torch.argmax(lr + noise.gumbel, dim=2, keepdim=True)
    pick = lambda x: torch.gather(at(x), 2, imc)[..., 0]
    covd = torch.gather(agg[:, 2:8], 2, idxs[:, None, :].expand(
        B, 6, idxs.shape[1]))
    cov_sar = sym3_from_parts(tuple(covd[:, j] for j in range(6)))
    return dict(
        model_idx=take(sel["sel_gidx"]),
        scale=take(sel["scale_k"]), av=take(sel["av_k"]),
        rv=take(sel["rv_k"]), cov_sar=cov_sar, lnprob=take(lnp_sel),
        dist=pick(dist_k), red=pick(red_k), dred=pick(dred_k),
        logwt=torch.gather(lr, 2, imc)[..., 0],
        log_evidence=log_evid, chi2min=sel["chi2min"], ndim=sel["ndim"])


__all__ = ["lnpost_batch", "draw_noise", "selection_size", "Noise"]
