"""
Funnel likelihood of the PyTorch port: screen every grid model, keep the
best blocks per star, gather them and fit them in full.

Mirrors `brutus_tpu/ops/pallas_loglike.py`, on one shard of the grid or
on a mesh's `model` axis (`model_group`).  Three of the
JAX package's four Pallas kernels live here, each as a hand-written CUDA
kernel (`csrc/`) beside a plain PyTorch version of the same function:

| kernel | TPU kernel it replaces | CUDA source |
| --- | --- | --- |
| K2 screen | `pallas_loglike.py:452 _make_screen_kernel` | `csrc/screen.cu` |
| K3 slab gather | `pallas_loglike.py:1049 _make_gather_call` | `csrc/gather.cu` |
| K1 fit (per-star stacked mode) | `pallas_loglike.py:66 _make_kernel` | `csrc/fit.cu` |

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors, which is how the CPU tests reach the same arithmetic.
K1's dense mode (the dense engine) is in `fit.py`; it reuses
`fit_pack_plain` and `post_consts` from here.

The grid lives in ONE `(3F + n_aux, Mp)` float32 table (row `k*F + f`
holds coefficient `k` of filter `f`; then the aux rows: grid log-prior,
feh, loga) with M padded with zero columns to a multiple of the tile,
and a `(Mp,)` mask row that is -1e30 on the padding (see
`convert.from_numpy_grid`).  The TPU's bf16 split tables and block-major
gather layout have no purpose on a GPU and are not built.
"""

import math
from functools import lru_cache

import torch

from .. import profiling
from ..config import FitConfig, LN2PI
from ..parallel.mesh import all_gather, all_reduce, group_rank, group_size
from ._native import KERNELS, check
from .optimize import parallax_or_nan, prepare_star_data

SCREEN_MAG_CENTER = 12.0
# Block widths K2 reduces over: its warps reduce 32 models each.
SCREEN_BLOCKS = (32, 64, 128, 256, 512, 1024)
LN10 = math.log(10.0)
FLUXFAC = -0.4 * LN10


def _slab_block(screen_block, tile):
    """Slab width of the funnel: the largest power-of-two fraction of
    `screen_block` that tiles `tile` (the TPU's 128-lane floor does not
    apply)."""
    block = min(screen_block, tile)
    while tile % block:
        block //= 2
    return block


def pack_row_names(aux_names):
    """Row names of the fit kernel's stacked pack: the 11 fit fields,
    the aux rows in `aux_names` order, then the grid index."""
    return ("lnlike", "chi2", "scale", "av", "rv",
            "i00", "i11", "i22", "i01", "i02", "i12",
            *aux_names, "gidx")


def _screen_parallax(parallax, parallax_err):
    ok = (torch.isfinite(parallax) & torch.isfinite(parallax_err)
          & (parallax_err > 0))
    one = torch.ones_like(parallax)
    plx = torch.where(ok, parallax, torch.zeros_like(parallax))
    plxw = torch.where(ok, 1.0 / torch.where(ok, parallax_err, one) ** 2,
                       torch.zeros_like(parallax))
    return plx, plxw


def _screen_star_mats(mags, wt_mag, plx, plxw):
    """Star-side screen inputs: `(B, 2, F)` rows `[w, m*w]` with `m` the
    magnitudes centered by `SCREEN_MAG_CENTER` (zero where `w == 0`),
    and the `(B, 5)` scalars `[a00, C0, q0, plx, plxw]` (sum w,
    sum w m, sum w m^2, parallax mean and weight)."""
    mc = (mags - SCREEN_MAG_CENTER) * torch.sign(wt_mag)
    mcw = mc * wt_mag
    srow = torch.stack([wt_mag.sum(1), mcw.sum(1), (mc * mcw).sum(1),
                        plx, plxw], dim=1)
    star = torch.stack([wt_mag, mcw], dim=1)
    return star.contiguous(), srow.contiguous()


def screen_score_from_sums(A01, A02, Bm0, A11, A12, A22, RS, b1r, b2,
                           a00, C0, q0, plx, plxw, cfg: FitConfig):
    """Screening score `-chi2/2` from the nine bilinear sums (mirrors
    `pallas_loglike.py:339-420`): clamped direct 3x3 WLS solve of
    `(mu, Av, Av*Rv)` through the Schur complement of `a00`, the
    explicit-residual chi2 by its quadratic-form expansion, plus the
    parallax chi2 at the implied flux scale."""
    avm, av_sig = cfg.av_gauss
    rvm, _ = cfg.rv_gauss
    avvi = 1.0 / av_sig ** 2
    avmin, avmax = cfg.avlim
    rvmin, rvmax = cfg.rvlim
    b0 = C0 - Bm0
    b1 = b1r + avm * avvi
    ra00 = 1.0 / a00
    k1 = A01 * ra00
    k2 = A02 * ra00
    s11 = (A11 + avvi) - k1 * A01
    s12 = A12 - k1 * A02
    s22 = A22 - k2 * A02
    c1 = b1 - k1 * b0
    c2 = b2 - k2 * b0
    det = s11 * s22 - s12 * s12
    rdet = 1.0 / torch.where(torch.abs(det) > 1e-30, det,
                             torch.ones_like(det))
    av = torch.clamp((c1 * s22 - s12 * c2) * rdet, avmin, avmax)
    avrv = (s11 * c2 - s12 * c1) * rdet
    av_ok = torch.abs(av) > 1e-10
    rv = torch.where(av_ok, avrv / torch.where(av_ok, av,
                                               torch.ones_like(av)),
                     torch.full_like(av, rvm))
    rv = torch.clamp(rv, rvmin, rvmax)
    avrv = av * rv
    s0 = b0 - av * A01 - avrv * A02
    u = s0 * ra00
    rss0 = q0 + RS
    chi2 = (rss0 - u * s0
            + av * (av * A11 - 2.0 * b1r)
            + avrv * (avrv * A22 - 2.0 * b2)
            + 2.0 * (av * avrv) * A12)
    par = torch.exp(-0.2 * LN10 * u)
    chi2 = chi2 + (par - plx) ** 2 * plxw
    return -0.5 * chi2


# ---------------------------------------------------------------------------
# K2: screen
# ---------------------------------------------------------------------------

# Cached: a new device tensor per call would be a synchronous copy
# from host memory in front of every launch.
@lru_cache(maxsize=16)
def _screen_params(cfg, device):
    avm, av_sig = cfg.av_gauss
    avvi = 1.0 / av_sig ** 2
    return torch.tensor([avvi, cfg.rv_gauss[0], cfg.avlim[0], cfg.avlim[1],
                         cfg.rvlim[0], cfg.rvlim[1], avm * avvi],
                        dtype=torch.float32, device=device)


def screen_blocks_plain(table, maskrow, star, srow, n_filt, block,
                        cfg: FitConfig):
    """Plain version of K2: per-block maxima of the screening score."""
    F = n_filt
    w, mw = star[:, 0], star[:, 1]
    m0 = table[0:F] - SCREEN_MAG_CENTER
    r0, dr = table[F:2 * F], table[2 * F:3 * F]
    A01, A02, Bm0 = w @ r0, w @ dr, w @ m0
    A11, A12, A22 = w @ (r0 * r0), w @ (r0 * dr), w @ (dr * dr)
    RS = mw @ (-2.0 * m0) + w @ (m0 * m0)
    b1r = mw @ r0 + w @ (-(m0 * r0))
    b2 = mw @ dr + w @ (-(m0 * dr))
    col = lambda i: srow[:, i:i + 1]
    score = screen_score_from_sums(
        A01, A02, Bm0, A11, A12, A22, RS, b1r, b2,
        torch.clamp(col(0), min=1e-30), col(1), col(2), col(3), col(4),
        cfg) + maskrow[None, :]
    B, M = score.shape
    return score.reshape(B, M // block, block).amax(dim=-1)


def screen_blocks(table, maskrow, star, srow, n_filt, block,
                  cfg: FitConfig):
    """K2: `(B, Mp // block)` maxima of the screening score over each
    `block`-wide block of grid models, for every star.

    table : (3F + n_aux, Mp); maskrow : (Mp,); star : (B, 2, F);
    srow : (B, 5) (see `_screen_star_mats`).
    """
    if table.device.type == "cpu":
        return screen_blocks_plain(table, maskrow, star, srow, n_filt,
                                   block, cfg)
    dev = table.device
    C, Mp = table.shape
    B = star.shape[0]
    F = n_filt
    check(table, "table", device=dev)
    check(maskrow, "maskrow", (Mp,), device=dev)
    check(star, "star", (B, 2, F), device=dev)
    check(srow, "srow", (B, 5), device=dev)
    if C < 3 * F or Mp % block or block not in SCREEN_BLOCKS or F > 64:
        raise ValueError(f"screen: table {tuple(table.shape)} / block "
                         f"{block} do not fit F={F} (the kernel takes "
                         f"blocks of {SCREEN_BLOCKS})")
    out = torch.empty((B, Mp // block), dtype=torch.float32, device=dev)
    KERNELS["screen"](table, maskrow, star, srow,
                      _screen_params(cfg, dev), out, B, F, Mp, block)
    return out


def _select_blocks(bscore, nb, block):
    """Per-star top-`nb` score blocks (exact top-k; the TPU's
    approximate `approx_max_k` selection is not needed here) and the
    `(B, nb * block)` grid indices of their models."""
    bidx = torch.topk(bscore, nb, dim=1, sorted=True).indices.to(
        torch.int32)
    ar = torch.arange(block, dtype=torch.int32, device=bscore.device)
    idx = (bidx[:, :, None] * block + ar).reshape(bscore.shape[0],
                                                  nb * block)
    return bidx.contiguous(), idx


def _select_blocks_sharded(bscore, nb, block, group):
    """Cross-shard top-`nb` block selection of the model-sharded funnel
    (mirrors `pallas_loglike._select_blocks_sharded`, :1017-1045).
    `bscore (B, nblocks_l)` holds this shard's block maxima; shard `s`
    of the model `group` owns global blocks `[s * nblocks_l, (s + 1) *
    nblocks_l)`.  Each shard ranks its own blocks, the candidates'
    scores and global ids are all-gathered, and every shard re-ranks
    the union to the same global top-`nb`.  Returns `(bidx (B, nb),
    idx (B, nb * block), mine (B, nb))`, global ids and the blocks this
    shard owns."""
    B, nblocks_l = bscore.shape
    sc, ix = torch.topk(bscore, min(nb, nblocks_l), dim=1, sorted=True)
    lo = group_rank(group) * nblocks_l
    cand_sc = all_gather(sc, group, dim=1)
    cand_ix = all_gather(ix.to(torch.int32) + lo, group, dim=1)
    sel = torch.topk(cand_sc, nb, dim=1, sorted=True).indices
    bidx = torch.gather(cand_ix, 1, sel).contiguous()
    ar = torch.arange(block, dtype=torch.int32, device=bscore.device)
    idx = (bidx[:, :, None] * block + ar).reshape(B, nb * block)
    mine = (bidx >= lo) & (bidx < lo + nblocks_l)
    return bidx, idx, mine


def select_and_gather(table, bscore, nb, block, group=None):
    """The funnel's block selection and slab gather (K3): `(bidx, idx,
    slab (C, B, nb * block))`.  On a model `group`, each shard gathers
    the selected blocks it owns (local ids; block 0 for the others,
    whose slots are then zeroed) and one all-reduce SUM over the group
    assembles every star's whole shortlist on every shard
    (`loglike_grid_screened`'s sharded branch, :1301-1315)."""
    if group_size(group) == 1:
        bidx, idx = _select_blocks(bscore, nb, block)
        return bidx, idx, gather_slabs(table, bidx, block)
    bidx, idx, mine = _select_blocks_sharded(bscore, nb, block, group)
    local = torch.where(mine, bidx - group_rank(group) * bscore.shape[1],
                        torch.zeros_like(bidx))
    slab = gather_slabs(table, local.contiguous(), block)
    keep = mine[:, :, None].expand(*mine.shape, block).reshape(1, -1,
                                                                idx.shape[1])
    slab = torch.where(keep, slab, torch.zeros_like(slab))
    return bidx, idx, all_reduce(slab, "sum", group)


# ---------------------------------------------------------------------------
# K3: slab gather
# ---------------------------------------------------------------------------

def gather_slabs_plain(table, bidx, block):
    """Plain version of K3: one advanced-index copy."""
    B, nb = bidx.shape
    ar = torch.arange(block, device=table.device)
    idx = (bidx.long()[:, :, None] * block + ar).reshape(-1)
    return table.index_select(1, idx).reshape(table.shape[0], B,
                                              nb * block)


def gather_slabs(table, bidx, block):
    """K3: `out[:, b, j*block:(j+1)*block] = table[:, bidx[b, j]*block :
    +block]`; returns `(C, B, nb * block)`."""
    if table.device.type == "cpu":
        return gather_slabs_plain(table, bidx, block)
    dev = table.device
    C, Mp = table.shape
    B, nb = bidx.shape
    check(table, "table", device=dev)
    check(bidx, "bidx", (B, nb), dtype=torch.int32, device=dev)
    out = torch.empty((C, B, nb * block), dtype=torch.float32, device=dev)
    KERNELS["gather"](table, bidx, out, C, Mp, B, nb, block)
    return out


# ---------------------------------------------------------------------------
# K1: per-star shortlist fit, stacked pack output
# ---------------------------------------------------------------------------

@lru_cache(maxsize=16)
def _fit_params(cfg, device):
    avm, av_sig = cfg.av_gauss
    rvm, rv_sig = cfg.rv_gauss
    avvi, rvvi = 1.0 / av_sig ** 2, 1.0 / rv_sig ** 2
    return torch.tensor(
        [avm, avvi, rvm, rvvi, 1.0 / cfg.av_reg ** 2, 1.0 / cfg.rv_reg ** 2,
         cfg.avlim[0], cfg.avlim[1], cfg.rvlim[0], cfg.rvlim[1],
         math.log(cfg.init_thresh), cfg.scale_min, cfg.stepsize_rescale,
         avm * avvi, rvm * rvvi],
        dtype=torch.float32, device=device)


def post_consts(mask, ndim, tot_var):
    """Per-star constants `(B, 3)` of K1's `_post` epilogue (mirrors
    `pallas_loglike._post`, :666-696, and the stacked kernel's `srow`,
    :1333-1340): the Gaussian normalisation constant, and `cA`, `cB` of
    the chi2 dimensionality prior `cA + cB log(chi2) - chi2 / 2` with
    `ndim - 3` degrees of freedom."""
    ndim_f = ndim.to(torch.float32)
    halfdf = (ndim_f - 3.0) / 2.0
    safe_var = torch.where(mask, tot_var, torch.ones_like(tot_var))
    const = -0.5 * (ndim_f * LN2PI
                    + (torch.log(safe_var) * mask).sum(1))
    return torch.stack([const,
                        -(halfdf * math.log(2.0) + torch.lgamma(halfdf)),
                        halfdf - 1.0], dim=1).contiguous()


def fit_pack_plain(star, coef, gidx, srow, n_aux, n_rows, n_real_mask,
                   tile, cfg: FitConfig):
    """Plain version of K1 (mirrors `pallas_loglike.py:66-323` step by
    step): per-filter tensors are `(F, B, P)`."""
    F = star.shape[2]
    B, P = gidx.shape
    avm, av_sig = cfg.av_gauss
    rvm, rv_sig = cfg.rv_gauss
    avvi = 1.0 / av_sig ** 2
    rvvi = 1.0 / rv_sig ** 2
    a_reg = 1.0 / cfg.av_reg ** 2
    r_reg = 1.0 / cfg.rv_reg ** 2
    avmin, avmax = cfg.avlim
    rvmin, rvmax = cfg.rvlim
    ln_init_thresh = math.log(cfg.init_thresh)

    def fsum(x):
        """Sum over the filter axis in filter order, one rounding per
        term, as the kernel's loop adds."""
        acc = x[0]
        for i in range(1, x.shape[0]):
            acc = acc + x[i]
        return acc

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    mag0, r0, dr = coef[0:F], coef[F:2 * F], coef[2 * F:3 * F]
    st = star.permute(1, 2, 0)[..., None]            # (4, F, B, 1)
    flux, wtf, mags, wtm = st[0], st[1], st[2], st[3]
    m_int = torch.exp(FLUXFAC * mag0)

    def mle(av, rv, want_icov=False):
        rvec_m = r0 + rv[None] * dr
        m = m_int * torch.exp(FLUXFAC * (av[None] * rvec_m))
        rvec = FLUXFAC * m * rvec_m
        drvec = FLUXFAC * m * dr
        s_num = fsum(m * flux * wtf)
        s_den = torch.clamp(fsum(m * m * wtf), min=1e-30)
        scale = torch.clamp(s_num / s_den, min=cfg.scale_min)
        ms = m * scale[None]
        resid = flux - ms
        if not want_icov:
            return rvec * scale[None], drvec * scale[None], scale, resid
        red_s = (m - m_int) * scale[None]
        t = ms - resid
        sa = fsum(rvec * t * wtf)
        sr = fsum(drvec * t * wtf)
        rvec_s = rvec * scale[None]
        drvec_s = drvec * scale[None]
        ar = fsum(drvec_s * (red_s - resid) * wtf)
        a_den = fsum(rvec_s * rvec_s * wtf) + avvi + a_reg
        r_den = fsum(drvec_s * drvec_s * wtf) + rvvi + r_reg
        return scale, resid, s_den, a_den, r_den, sa, sr, ar

    # phase A seed: direct 3x3 WLS of (mu, Av, Av*Rv)
    resid0 = mags - mag0
    a00 = fsum(wtm)
    a01 = fsum(r0 * wtm)
    a02 = fsum(dr * wtm)
    a11 = fsum(r0 * r0 * wtm) + avvi
    a12 = fsum(r0 * dr * wtm)
    a22 = fsum(dr * dr * wtm)
    b0 = fsum(resid0 * wtm)
    b1 = fsum(resid0 * r0 * wtm) + avm * avvi
    b2 = fsum(resid0 * dr * wtm)
    det = (a00 * (a11 * a22 - a12 * a12)
           - a01 * (a01 * a22 - a12 * a02)
           + a02 * (a01 * a12 - a11 * a02))
    det1 = (a00 * (b1 * a22 - a12 * b2)
            - b0 * (a01 * a22 - a12 * a02)
            + a02 * (a01 * b2 - b1 * a02))
    det2 = (a00 * (a11 * b2 - b1 * a12)
            - a01 * (a01 * b2 - b1 * a02)
            + b0 * (a01 * a12 - a11 * a02))
    safe_det = torch.where(torch.abs(det) > 1e-30, det,
                           torch.ones_like(det))
    av = torch.clamp(det1 / safe_det, avmin, avmax)
    avrv = det2 / safe_det
    ok = torch.abs(av) > 1e-10
    rv = torch.where(ok, avrv / torch.where(ok, av, torch.ones_like(av)),
                     torch.full_like(av, rvm))
    rv = torch.clamp(rv, rvmin, rvmax)

    # phase A: alternating clamped (Av, Rv) solves
    rvec = r0 + rv[None] * dr
    resid = mags - (mag0 + av[None] * rvec)
    s_den_m = fsum(wtm)
    rp_den = fsum(dr * dr * wtm)
    srp = fsum(dr * wtm)
    for _ in range(cfg.kernel_mag_iters):
        a_den = fsum(rvec * rvec * wtm) + avvi
        sa = fsum(rvec * wtm)
        rs = fsum(resid * wtm)
        ra = fsum(resid * rvec * wtm) + (avm - av) * avvi
        dav = (s_den_m * ra - sa * rs) / (s_den_m * a_den - sa * sa)
        dav = clip(dav, avmin - av, avmax - av)
        av = av + dav
        resid = resid - dav[None] * rvec
        r_den = rp_den * av * av + rvvi
        sr = srp * av
        rs = fsum(resid * wtm)
        rr = av * fsum(resid * dr * wtm) + (rvm - rv) * rvvi
        drv = (s_den_m * rr - sr * rs) / (s_den_m * r_den - sr * sr)
        drv = clip(drv, rvmin - rv, rvmax - rv)
        rv = rv + drv
        resid = resid - (av * drv)[None] * dr
        rvec = rvec + drv[None] * dr

    # phase B: flux-space damped polish; the freeze window is the
    # `tile`-wide block of the shortlist.
    rvecs, drvecs, scale, residf = mle(av, rv)
    chi2 = fsum(residf * residf * wtf)
    lnl = -0.5 * chi2
    lmax = lnl.reshape(B, P // tile, tile).amax(-1, keepdim=True)
    lmax = lmax.expand(B, P // tile, tile).reshape(B, P)
    stepsize = torch.where(lnl < lmax + ln_init_thresh,
                           torch.zeros_like(lnl), torch.ones_like(lnl))
    lnl_old = lnl
    for _ in range(cfg.kernel_flux_iters):
        a_num = fsum(rvecs * residf * wtf) + (avm - av) * avvi
        a_den = fsum(rvecs * rvecs * wtf) + avvi
        dav = stepsize * a_num / a_den
        r_num = fsum(drvecs * residf * wtf) + (rvm - rv) * rvvi
        r_den = fsum(drvecs * drvecs * wtf) + rvvi
        drv = stepsize * r_num / r_den
        dav = clip(dav, avmin - av, avmax - av)
        drv = clip(drv, rvmin - rv, rvmax - rv)
        av = av + dav
        rv = rv + drv
        rvecs, drvecs, scale, residf = mle(av, rv)
        chi2 = fsum(residf * residf * wtf)
        lnl = -0.5 * chi2
        stepsize = torch.where(lnl < lnl_old,
                               stepsize / cfg.stepsize_rescale, stepsize)
        lnl_old = lnl

    scale, residf, s_den, a_den, r_den, sa, sr, ar = mle(av, rv, True)
    chi2 = fsum(residf * residf * wtf)

    # epilogue (`_post` in-kernel): padding mask, Gaussian constant,
    # chi2 dimensionality prior
    if n_real_mask >= 0:
        bad = gidx >= n_real_mask       # as integers, exact past 2**24
        chi2 = torch.where(bad, torch.full_like(chi2, 1e30), chi2)
    lnl = -0.5 * chi2
    if n_real_mask >= 0:
        lnl = torch.where(bad, torch.full_like(lnl, -1e30), lnl)
    lnl = lnl + srow[:, 0:1]
    if cfg.dim_prior:
        safe_y = torch.where(chi2 > 0, chi2, torch.ones_like(chi2))
        ans = srow[:, 1:2] + srow[:, 2:3] * torch.log(safe_y) - safe_y / 2.0
        lnl = torch.where(chi2 > 0, ans, torch.full_like(ans, -math.inf))
    rows = [lnl, chi2, scale, av, rv, s_den, a_den, r_den, sa, sr, ar]
    rows += [coef[3 * F + i] for i in range(n_aux)]
    rows.append(gidx.to(torch.float32))
    rows += [torch.zeros_like(chi2)] * (n_rows - len(rows))
    return torch.stack(rows, dim=1)


def fit_pack(star, coef, gidx, srow, n_aux, n_rows, n_real_mask, tile,
             cfg: FitConfig):
    """K1: fit every shortlist model of every star and write the
    stacked pack `(B, n_rows, P)` (rows `pack_row_names`).

    star : (B, 4, F) `[flux, wt_flux, mags, wt_mag]`; coef : (C, B, P)
    slab-gather output; gidx : (B, P) int32 grid index; srow : (B, 3)
    `[Gaussian constant, cA, cB]` of the chi2 dim prior; `n_real_mask`
    masks models with `gidx >= n_real_mask` (negative: no mask); the
    freeze of phase B is local to `tile`-wide windows of the shortlist.
    """
    if star.device.type == "cpu":
        return fit_pack_plain(star, coef, gidx, srow, n_aux, n_rows,
                              n_real_mask, tile, cfg)
    dev = star.device
    B, _, F = star.shape
    C, _, P = coef.shape
    check(star, "star", (B, 4, F), device=dev)
    check(coef, "coef", (C, B, P), device=dev)
    check(gidx, "gidx", (B, P), dtype=torch.int32, device=dev)
    check(srow, "srow", (B, 3), device=dev)
    if C < 3 * F + n_aux or n_rows < 12 + n_aux or P % tile \
            or not 1 <= tile <= 1024 or F > 64:
        raise ValueError("fit: inconsistent shapes for the fit kernel")
    out = torch.empty((B, n_rows, P), dtype=torch.float32, device=dev)
    KERNELS["fit"](star, coef, gidx, srow, _fit_params(cfg, dev), out,
                   B, F, P, n_aux, n_rows, n_real_mask, tile,
                   cfg.kernel_mag_iters, cfg.kernel_flux_iters,
                   int(cfg.dim_prior))
    return out


# ---------------------------------------------------------------------------
# The funnel
# ---------------------------------------------------------------------------

def screen_and_gather(flux, fluxerr, mask, table, maskrow, parallax,
                      parallax_err, cfg: FitConfig, tile, screen_k,
                      screen_block, model_group=None):
    """The first stage of both funnels, in `bf.screen` and `bf.gather`:
    the stars' hygiene, K2, the best `screen_k // block` blocks per star
    and K3's gather, for float32 (B, F) stars on the table's device.
    Returns `prepare_star_data`'s tuple, the parallaxes (NaN where None),
    the (B, P) int32 grid index of each shortlist model and its slab."""
    B, F = flux.shape
    Mp = table.shape[1] * group_size(model_group)   # the whole grid's
    block = _slab_block(screen_block, tile)
    nb = max(1, min(screen_k // block, Mp // block))
    with profiling.span("bf.screen"):
        star = prepare_star_data(flux, fluxerr, mask, cfg)
        parallax, parallax_err = parallax_or_nan(B, table.device, parallax,
                                                 parallax_err)
        star2, srow5 = _screen_star_mats(
            star[2], star[3], *_screen_parallax(parallax, parallax_err))
        bscore = screen_blocks(table, maskrow, star2, srow5, F, block, cfg)
    with profiling.span("bf.gather"):
        _, idx, slab = select_and_gather(table, bscore, nb, block,
                                         model_group)
    return star, parallax, parallax_err, idx, slab


def loglike_grid_screened(flux, fluxerr, mask, table, maskrow, n_real,
                          aux_names, parallax=None, parallax_err=None,
                          cfg: FitConfig = FitConfig(), tile=512,
                          screen_k=12288, screen_block=256,
                          model_group=None):
    """Funnel likelihood (mirrors `loglike_grid_screened`): K2 scores
    every model, the best `screen_k // block` blocks per star are kept,
    K3 gathers them (`screen_and_gather`) and K1 fits them.

    With a `model_group` of several shards (the JAX package's
    `model_axis`, with `n_model_shards` its size), `table` and
    `maskrow` are this shard's contiguous slice of the padded grid and
    `n_real` the grid's real model count: each shard screens its own
    models, the block shortlists merge over the group
    (`select_and_gather`), and K1 runs on the whole shortlist on every
    shard, so everything after the merge is the same on each.

    Returns a dict: `pack` (B, n_rows, P) stacked fit output, `names`
    its row names (`pack_row_names`), `ndim` (B,) usable bands, and
    `global_idx` the (B, P) int32 grid index of each shortlist model
    (the pack's float32 `gidx` row is exact only below 2**24).
    """
    dev = table.device
    Mp = table.shape[1] * group_size(model_group)   # the whole grid's
    flux = flux.to(dev, torch.float32)
    fluxerr = fluxerr.to(dev, torch.float32)
    mask = mask.to(dev)
    (*star4, mask, ndim, tot_var), _, _, idx, coef = screen_and_gather(
        flux, fluxerr, mask, table, maskrow, parallax, parallax_err, cfg,
        tile, screen_k, screen_block, model_group)
    tile2 = tile
    while idx.shape[1] % tile2:
        tile2 //= 2

    n_aux = len(aux_names)
    n_rows = 12 + n_aux
    with profiling.span("bf.fit_models"):
        pack = fit_pack(torch.stack(star4, dim=1).contiguous(), coef,
                        idx.contiguous(), post_consts(mask, ndim, tot_var),
                        n_aux, n_rows, n_real if n_real < Mp else -1, tile2,
                        cfg)
    return dict(pack=pack, names=pack_row_names(aux_names), ndim=ndim,
                global_idx=idx)


__all__ = ["loglike_grid_screened", "screen_and_gather", "screen_blocks",
           "gather_slabs", "fit_pack", "fit_pack_plain", "post_consts",
           "pack_row_names", "screen_score_from_sums"]
