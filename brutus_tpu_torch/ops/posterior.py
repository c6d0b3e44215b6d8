"""
Posterior selection, Monte-Carlo integration and resampling, batched
over stars (mirrors `brutus_tpu/ops/posterior.py`; reference
`brutus/fitting.py:823-1107` and the resampling tail of `_fit`,
`brutus/fitting.py:2024-2061`).

Two entry points, as in the JAX package:

- `lnpost_batch` reads the funnel fit kernel's stacked pack: the
  likelihood-rank prefilter gathers whole pack columns, the Galactic and
  dust priors and the two relative-weight culls run in PyTorch, and the
  MC kernel (K4, see `mc.py`) reads the gathered pack through a row map.
- `lnpost_grid` reads the dense engine's `(B, M)` fields and integrates
  in plain PyTorch, as the JAX package does in XLA; custom prior
  callables take this path on both engines, since K4 hard-codes the
  built-in priors.

Resampling uses plain indexing (the JAX package's one-hot matmuls only
avoided slow gathers on the TPU and give identical values).  All
randomness comes in through `Noise`: the MC normals (or, for K4's
random-number mode, per-star seeds), the uniforms of the inverse-CDF
model draws and the Gumbel noise of the per-draw pick.  `draw_noise`
makes them on the device from one Philox stream per star, keyed by the
fit's seed and the star's global row (`rng.py`); tests hand in the JAX
package's own draws instead.
"""

import collections
import math

import torch

from .. import profiling
from ..config import PosteriorConfig, GalPriorConfig, DustPriorConfig
from ..coords import _M
from ..priors import (gal_lnprior, dust_lnprior, parallax_lnprior,
                      scale_parallax_lnprior)
from ..parallel.mesh import all_gather, all_reduce, group_rank, group_size
from ..utils import (sym3_from_parts, psd_repair_parts, cholesky3_parts)
from .mc import mc_integrate, nmc_pad_of, NL_PAD
from .optimize import parallax_or_nan
from . import rng

NEG_BIG = -1e30
# NEG_BIG is finite, so validity is a threshold, not `isfinite`.
VALID_MIN = 0.5 * NEG_BIG

Noise = collections.namedtuple("Noise", "z u gumbel seeds",
                               defaults=(None,))
Noise.__doc__ = """Random inputs of the posterior: `z` the MC normals, in
`lnpost_batch`'s layout (B, 3, nmc_pad, K) with rows from n_mc on zero,
or in `lnpost_grid`'s (B, K, 3, n_mc); `u` (B, n_draws) uniforms in
[0, 1); `gumbel` (B, n_draws, n_mc) standard Gumbel; `seeds` (B, 2)
int32, the Philox keys of K4's random-number mode, given instead of `z`
to `lnpost_batch`."""


def _is_valid(x):
    return torch.isfinite(x) & (x > VALID_MIN)


def draw_noise(seed, rows, K, cfg: PosteriorConfig, device, grid=False):
    """The random inputs of the stars at global `rows` (B,) of a fit
    seeded with `seed`, drawn on `device` from one Philox stream per
    star (`rng.py`, counter layout there): for `lnpost_grid` when
    `grid`, else for `lnpost_batch`, whose MC kernel makes its normals
    from the star keys when `cfg.kernel_rng` and is fed the same
    normals otherwise.  A star's draws depend on `(seed, row)` alone; on
    a card they come from one kernel launch (`rng.draws`)."""
    nmc = cfg.n_mc_prior
    kind = "grid" if grid else (None if cfg.kernel_rng else "mc")
    keys, z, u, gumbel = rng.draws(seed, torch.as_tensor(rows, device=device),
                                   K, nmc, cfg.n_draws, z=kind,
                                   nmc_pad=nmc_pad_of(nmc))
    return Noise(z, u, gumbel, None if kind else keys)


def _categorical_cdf(u, logits, n):
    """`n` categorical draws per row by inverse-CDF sampling (mirrors
    `posterior._categorical_cdf`): u (B, n) uniforms, logits (B, K).
    The CDF is summed in float64: a float32 `cumsum` on the card rounds
    differently for a batch of another size, which moved a few of a
    row's draws to a neighbouring model with its batch
    (`tools/cdf_batch_probe.py`)."""
    wt = torch.softmax(logits, dim=1)
    cdf = torch.cumsum(wt.double(), dim=1)
    v = (u.double() * cdf[:, -1:]).contiguous()
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


def _lnprob(lnlike, scale, s_den, plx, plxe):
    """Likelihood plus the scale-space parallax prior, the key of the
    first cull and of the prefilter (`posterior.py:259-265`)."""
    scale_err = 1.0 / torch.sqrt(torch.abs(s_den))
    lp = lnlike + scale_parallax_lnprior(scale, scale_err, plx, plxe)
    return torch.where(torch.isfinite(lp), lp, torch.full_like(lp, NEG_BIG))


def _prefilter(lnprob, lnprob_max, cfg: PosteriorConfig, group=None):
    """`(B, prefilter_k)` indices of the likelihood-rank prefilter, best
    first, on the max-shifted key rounded to bf16 when
    `cfg.prefilter_bf16` (`posterior.py:267-313`).  On a model `group`
    (`lnprob` this shard's `(B, M)` columns, `lnprob_max` the whole
    grid's) the indices are global columns: each shard keeps its own
    best, and the union of the shards' candidates, all-gathered in
    shard order, is ranked again, which keeps the single-grid order
    (ties to the lower column)."""
    if cfg.prefilter_bf16:
        key = torch.clamp(lnprob - lnprob_max, min=-3e4).to(
            torch.bfloat16).to(torch.float32)
    else:
        key = lnprob
    if group_size(group) == 1:
        return _top_k(key, cfg.prefilter_k)
    M = key.shape[1]
    loc = _top_k(key, min(cfg.prefilter_k, M))
    cand_key = all_gather(torch.gather(key, 1, loc), group, dim=1)
    cand_col = all_gather(loc + group_rank(group) * M, group, dim=1)
    return torch.gather(cand_col, 1, _top_k(cand_key, cfg.prefilter_k))


def _take(x, idx):
    """`x` at the model indices `idx (B, n)`: `x` is per star `(B, M)`,
    a grid row `(M,)` shared by every star, or None; `idx` None keeps
    `x`."""
    if x is None or idx is None:
        return x
    return x[idx] if x.dim() == 1 else torch.gather(x, 1, idx)


def _take_sharded(fields, cols, group):
    """Every field of `fields` (each `(B, M)` or `(M,)` over this
    shard's models, or None) at the global columns `cols (B, n)` of a
    grid sharded over the model `group`: each shard fills the columns
    it owns, zero elsewhere, and one all-reduce SUM of the stacked
    fields (in float64, which holds every float32 and index exactly)
    gives every shard all of them."""
    names = [k for k, v in fields.items() if v is not None]
    M = fields[names[0]].shape[-1]
    loc = cols - group_rank(group) * M
    mine = (loc >= 0) & (loc < M)
    loc = torch.where(mine, loc, torch.zeros_like(loc))
    stack = torch.stack([
        torch.where(mine, _take(fields[k], loc).to(torch.float64),
                    torch.zeros(loc.shape, dtype=torch.float64,
                                device=loc.device)) for k in names])
    stack = all_reduce(stack, "sum", group)
    out = dict.fromkeys(fields)
    for k, v in zip(names, stack):
        out[k] = v.to(fields[k].dtype)
    return out


def _per_star(fn, args, mapped):
    """Apply a per-star prior callable over the leading star axis with
    `torch.func.vmap` (the counterpart of the `jax.vmap` at
    `posterior.py:832-843`): the arguments flagged in `mapped` map over
    their first axis, the others (None, a grid row shared by every
    star, the shared distance ladder) go in whole."""
    dims = tuple(0 if m else None for m in mapped)
    return torch.func.vmap(fn, in_dims=dims)(*args)


def _gal_prior(dist, coord, feh, loga, gal_cfg, lngalprior):
    """Galactic prior of `dist (B, ...)`: a custom per-star
    `lngalprior(dist, coord, feh=, loga=)` or the built-in one.  `feh`
    and `loga` are per star (as many dimensions as `dist`), shared, or
    None."""
    per_star = lambda x: x is not None and x.dim() == dist.dim()
    if lngalprior is not None:
        return _per_star(lambda d, c, f, a: lngalprior(d, c, feh=f, loga=a),
                         (dist, coord, feh, loga),
                         (True, True, per_star(feh), per_star(loga)))
    B = dist.shape[0]
    flat = lambda x: None if x is None else x.expand(dist.shape).reshape(
        B, -1)
    return gal_lnprior(flat(dist), coord, feh=flat(feh), loga=flat(loga),
                       cfg=gal_cfg).reshape(dist.shape)


def _dust_prior(dist, av, dust_profile, dust_cfg, lndustprior):
    """Dust prior of `(dist, av) (B, ...)` on the per-star ladders of
    `dust_profile`: a custom per-star `lndustprior(dist, av, av_dist,
    av_mean, av_std)` or the built-in one."""
    av_dist, av_mean, av_std = dust_profile
    if lndustprior is not None:
        return _per_star(lndustprior, (dist, av, av_dist, av_mean, av_std),
                         (True, True, False, True, True))
    B = dist.shape[0]
    return dust_lnprior(dist.reshape(B, -1), av.reshape(B, -1), av_dist,
                        av_mean, av_std, dust_cfg).reshape(dist.shape)


def _cull_select(lnprob, lnprob_max, lnlike, lnprior, scale, av, feh, loga,
                 coord, dust_profile, K, cfg, gal_cfg, dust_cfg,
                 apply_av_prior, lngalprior=None, lndustprior=None):
    """Cull on the likelihood, the priors at the MLE solutions, cull on
    the posterior and the top-`K` selection (`posterior.py:403-470`).

    Every input is `(B, n)` (or a shared `(n,)` row).  Returns `lnp_sel
    (B, K)` (NEG_BIG where invalid), `valid (B, K)` and `sel (B, K)`,
    the selected columns, or None when `K == n` and nothing is sorted.
    """
    if cfg.wt_thresh is not None:
        mask1 = lnprob > torch.clamp(lnprob_max + math.log(cfg.wt_thresh),
                                     min=VALID_MIN)
    else:
        mask1 = _cull_mask(lnprob, None, cfg.cdf_thresh)
    dist = 1.0 / torch.sqrt(torch.clamp(scale, min=1e-30))
    lnp_mle = lnlike + lnprior
    lnp_mle = lnp_mle + _gal_prior(dist, coord, feh, loga, gal_cfg,
                                   lngalprior)
    if apply_av_prior and dust_profile is not None:
        lnp_mle = lnp_mle + _dust_prior(dist, av, dust_profile, dust_cfg,
                                        lndustprior)
    lnp_mle = torch.where(mask1 & _is_valid(lnp_mle), lnp_mle,
                          torch.full_like(lnp_mle, NEG_BIG))
    mask2 = _cull_mask(lnp_mle, cfg.wt_thresh, cfg.cdf_thresh,
                       base_mask=mask1)
    score = torch.where(mask2, lnlike + lnprior,
                        torch.full_like(lnp_mle, -math.inf))
    if K == score.shape[1]:
        lnp_sel, sel = score, None
    else:
        sel = _top_k(score, K)
        lnp_sel = torch.gather(score, 1, sel)
    valid = _is_valid(lnp_sel)
    lnp_sel = torch.where(valid, lnp_sel, torch.full_like(lnp_sel,
                                                          NEG_BIG))
    return lnp_sel, valid, sel


def _chi2_bookkeeping(chi2_k, scale_k, valid, ndim, parallax, parallax_err):
    """chi2 with the parallax term, band count and chi2 minimum of the
    selection (`posterior.py:492-505`)."""
    have = torch.isfinite(parallax) & torch.isfinite(parallax_err)
    perr = torch.where(have, parallax_err, torch.ones_like(parallax_err))
    chi2_k = chi2_k + torch.where(
        have[:, None],
        (torch.sqrt(scale_k) - parallax[:, None]) ** 2 / perr[:, None] ** 2,
        torch.zeros_like(chi2_k))
    ndim_out = ndim + have.to(ndim.dtype)
    inf = torch.full_like(chi2_k, math.inf)
    chi2_fin = torch.where(torch.isfinite(chi2_k), chi2_k, inf)
    chi2min_v = torch.where(valid, chi2_fin, inf).amin(1)
    chi2min = torch.where(torch.isfinite(chi2min_v), chi2min_v,
                          chi2_fin.amin(1))
    return chi2_k, ndim_out, chi2min


def _select_stage(pack, names, ndim, coord, parallax, parallax_err,
                  dust_profile, cfg, gal_cfg, dust_cfg, apply_av_prior,
                  global_idx=None):
    """Culls + priors + top-K selection of every star on the fit
    kernel's stacked pack (mirrors `posterior._select_stage`, the
    kernel-pack path and the path without a prefilter): the prefilter
    gathers whole pack columns, so the selected table feeds K4 as it
    is.  pack : (B, n_rows, M).  The selected models' grid indices come
    from the integer `global_idx (B, M)` when it is given (exact at any
    grid size, `posterior.py:434`), else from the pack's float32 `gidx`
    row (exact below 2**24 models)."""
    col = {n: i for i, n in enumerate(names)}
    B, _, M = pack.shape
    plx, plxe = parallax[:, None], parallax_err[:, None]
    lnprob_of = lambda p: _lnprob(p[:, col["lnlike"]], p[:, col["scale"]],
                                  p[:, col["i00"]], plx, plxe)
    lnprob = lnprob_of(pack)
    lnprob_max = lnprob.amax(1, keepdim=True)
    K = selection_size(cfg, M)
    if _pack_usable(cfg, M):
        pre_idx = _prefilter(lnprob, lnprob_max, cfg)
        packed = torch.gather(pack, 2, pre_idx[:, None, :].expand(
            B, pack.shape[1], pre_idx.shape[1]))
        lnprob = lnprob_of(packed)
        if global_idx is not None:
            global_idx = torch.gather(global_idx, 1, pre_idx)
    else:
        packed = pack
    g = lambda n: packed[:, col[n]] if n in col else None
    lnp_sel, valid, sel = _cull_select(
        lnprob, lnprob_max, g("lnlike"), g("lnprior"), g("scale"), g("av"),
        g("feh"), g("loga"), coord, dust_profile, K, cfg, gal_cfg, dust_cfg,
        apply_av_prior)
    table = packed if sel is None else torch.gather(
        packed, 2, sel[:, None, :].expand(B, packed.shape[1], K))
    t = lambda n: table[:, col[n]]
    chi2_k, ndim_out, chi2min = _chi2_bookkeeping(
        t("chi2"), t("scale"), valid, ndim, parallax, parallax_err)
    if global_idx is not None:
        sel_gidx = (global_idx if sel is None
                    else torch.gather(global_idx, 1, sel)).to(torch.int32)
    else:
        sel_gidx = torch.round(t("gidx")).to(torch.int32)
    return dict(table=table.contiguous(), lnp_sel=lnp_sel, valid=valid,
                scale_k=t("scale"), av_k=t("av"), rv_k=t("rv"),
                chi2_k=chi2_k, ndim=ndim_out, chi2min=chi2min,
                sel_gidx=sel_gidx, has_feh="feh" in col,
                has_loga="loga" in col)


def _select_grid(results, lnprior_grid, feh, loga, global_idx, coord,
                 parallax, parallax_err, dust_profile, cfg, gal_cfg,
                 dust_cfg, apply_av_prior, lngalprior, lndustprior,
                 group=None):
    """`_select_stage` on `loglike_grid_fused`'s form of the fit (the
    `lnpost_grid` path, `posterior.py:209-528`): `(B, M)` fields, grid
    rows `lnprior_grid`, `feh`, `loga` either `(M,)` (gathered at the
    selected models, never copied per star) or per star `(B, M)`.

    On a model `group` the fields and rows cover this shard's slice of
    the grid, and the merges GSPMD makes of the JAX package's
    reductions are made here: the per-star maximum by an all-reduce
    MAX, the prefilter over every shard (`_prefilter`), and the
    prefiltered models' fields from their owners (`_take_sharded`);
    without a prefilter every shard all-gathers the whole grid.  The
    rest then runs alike on every shard."""
    parts = tuple(results["icov_parts"])
    f = dict(lnlike=results["lnlike"], scale=results["scale"],
             av=results["av"], rv=results["rv"], chi2=results["chi2"],
             lnprior=lnprior_grid, feh=feh, loga=loga, gidx=global_idx)
    f.update({f"i{j}": x for j, x in enumerate(parts)})
    B, M = f["lnlike"].shape
    n_shards = group_size(group)
    plx, plxe = parallax[:, None], parallax_err[:, None]
    lnprob = _lnprob(f["lnlike"], f["scale"], f["i0"], plx, plxe)
    lnprob_max = all_reduce(lnprob.amax(1, keepdim=True), "max", group)
    if n_shards > 1 and global_idx is None:
        f["gidx"] = torch.arange(M, device=lnprob.device) + group_rank(
            group) * M
    M = M * n_shards
    K = selection_size(cfg, M)
    pre = None
    if _pack_usable(cfg, M):
        pre = _prefilter(lnprob, lnprob_max, cfg, group)
        f = (_take_sharded(f, pre, group) if n_shards > 1
             else {k: _take(v, pre) for k, v in f.items()})
        lnprob = _lnprob(f["lnlike"], f["scale"], f["i0"], plx, plxe)
    elif n_shards > 1:
        f = {k: None if v is None else all_gather(v, group, dim=v.dim() - 1)
             for k, v in f.items()}
        lnprob = _lnprob(f["lnlike"], f["scale"], f["i0"], plx, plxe)
    lnp_sel, valid, sel = _cull_select(
        lnprob, lnprob_max, f["lnlike"], f["lnprior"], f["scale"], f["av"],
        f["feh"], f["loga"], coord, dust_profile, K, cfg, gal_cfg, dust_cfg,
        apply_av_prior, lngalprior, lndustprior)
    fk = {k: _take(v, sel) for k, v in f.items()}
    chi2_k, ndim_out, chi2min = _chi2_bookkeeping(
        fk["chi2"], fk["scale"], valid, results["ndim"], parallax,
        parallax_err)
    if fk["gidx"] is not None:
        sel_gidx = fk["gidx"]
    else:
        cols = torch.arange(M, device=lnprob.device)
        sel_gidx = _take(_take(cols, pre), sel)
    if sel_gidx.dim() == 1:
        sel_gidx = sel_gidx.expand(B, M)
    return dict(lnp_sel=lnp_sel, valid=valid, scale_k=fk["scale"],
                av_k=fk["av"], rv_k=fk["rv"], chi2_k=chi2_k,
                icov_k=tuple(fk[f"i{j}"] for j in range(6)),
                feh_k=fk["feh"], loga_k=fk["loga"], ndim=ndim_out,
                chi2min=chi2min, sel_gidx=sel_gidx.to(torch.int32))


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


def _star_args(B, dev, parallax, parallax_err, coord):
    """Per-star float32 parallax (NaN where missing) and coordinates."""
    return parallax_or_nan(B, dev, parallax, parallax_err) + (
        coord.to(dev, torch.float32),)


def _evidence_and_draws(lnp_sel, chi2_k, u, n_draws):
    """Log-evidence and the inverse-CDF model draws `(B, n_draws)`; a
    star with no valid model draws by exp(-chi2/2) over the selection
    (`posterior.py:540-558`)."""
    log_evid = torch.logsumexp(lnp_sel, dim=1)
    chi2_draw = torch.where(torch.isfinite(chi2_k), chi2_k,
                            torch.full_like(chi2_k, 1e30))
    any_ok = _is_valid(lnp_sel).any(1, keepdim=True)
    logits = torch.where(any_ok, lnp_sel, -0.5 * chi2_draw)
    return log_evid, _categorical_cdf(u, logits, n_draws)


def lnpost_batch(pack, names, ndim, coord, noise: Noise, parallax=None,
                 parallax_err=None, dust_profile=None,
                 cfg: PosteriorConfig = PosteriorConfig(),
                 gal_cfg: GalPriorConfig = GalPriorConfig(),
                 dust_cfg: DustPriorConfig = DustPriorConfig(),
                 apply_av_prior=True, tile=512, global_idx=None):
    """Posterior weights and `(dist, Av, Rv)` draws for a batch of stars
    (mirrors `posterior.lnpost_batch` with the built-in priors).

    pack : (B, n_rows, M) stacked fit output with row names `names`
    (`funnel.pack_row_names`; must hold `lnprior`, and `feh`/`loga` to
    apply those mixtures); ndim : (B,); coord : (B, 2) galactic degrees;
    dust_profile : `(av_dist (Nd,), av_mean (B, Nd), av_std (B, Nd))`
    on a uniform ladder of at most 128 rungs; noise : `z` (fed normals)
    or `seeds` (normals made inside K4), with `u` and `gumbel`;
    global_idx : the funnel's (B, M) int32 grid indices, read for the
    selected models (without it, the pack's float32 `gidx` row).

    Returns per-draw `(B, n_draws)` fields `model_idx, scale, av, rv,
    lnprob, dist, red, dred, logwt` and `cov_sar (B, n_draws, 3, 3)`,
    per-star `log_evidence, chi2min, ndim`, and the selection's
    diagnostics `(B, K)`: `sel_idx` its grid indices, `lnp_sel` its
    log-posteriors, `valid_sel` its valid models (`posterior.py:
    567-575`).
    """
    B = pack.shape[0]
    with profiling.span("bf.select"):
        parallax, parallax_err, coord = _star_args(
            B, pack.device, parallax, parallax_err, coord)
        sel = _select_stage(pack, names, ndim, coord, parallax,
                            parallax_err, dust_profile, cfg, gal_cfg,
                            dust_cfg, apply_av_prior, global_idx)
    use_dust = dust_profile is not None and apply_av_prior
    nmc = cfg.n_mc_prior
    valid = sel["valid"]
    with profiling.span("bf.mc"):
        scal, dust = _star_scalars(coord, parallax, parallax_err,
                                   dust_profile, use_dust)
        lnmc, dist_k, red_k, dred_k, agg = mc_integrate(
            sel["table"], _pack_row_map(names), valid.to(torch.float32),
            scal, dust, None if noise.z is None else noise.z.contiguous(),
            nmc, tile, cfg, gal_cfg, dust_cfg, use_feh=sel["has_feh"],
            use_loga=sel["has_loga"], use_dust=use_dust, seeds=noise.seeds)
    if profiling.recording():
        # summed on the card, read when the call ends
        profiling.count("k4_columns", valid.numel())
        profiling.count("k4_valid", valid.sum())

    with profiling.span("bf.draws"):
        lnp_sel = sel["lnp_sel"] + agg[:, 0] - torch.log(
            torch.clamp(agg[:, 1], min=1.0))
        lnp_sel = torch.where(valid & _is_valid(lnp_sel) & (agg[:, 1] > 0),
                              lnp_sel, torch.full_like(lnp_sel, NEG_BIG))
        log_evid, idxs = _evidence_and_draws(lnp_sel, sel["chi2_k"], noise.u,
                                             cfg.n_draws)

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
            log_evidence=log_evid, chi2min=sel["chi2min"], ndim=sel["ndim"],
            sel_idx=sel["sel_gidx"], lnp_sel=lnp_sel, valid_sel=valid)


def lnpost_grid(results, lnprior_grid, coord, noise: Noise, parallax=None,
                parallax_err=None, feh=None, loga=None, dust_profile=None,
                global_idx=None, cfg: PosteriorConfig = PosteriorConfig(),
                gal_cfg: GalPriorConfig = GalPriorConfig(),
                dust_cfg: DustPriorConfig = DustPriorConfig(),
                apply_av_prior=True, lngalprior=None, lndustprior=None,
                model_group=None):
    """Posterior weights and `(dist, Av, Rv)` draws for a batch of stars,
    with the MC integration in plain PyTorch (mirrors
    `posterior.lnpost_grid`, :453-577, with a leading star axis, as the
    dense engine vmaps it).

    results : `loglike_grid_fused`'s dict, `(B, M)` fields `lnlike,
    chi2, scale, av, rv`, the 6 `icov_parts` and `ndim (B,)`;
    lnprior_grid, feh, loga : `(M,)` grid rows shared by every star, or
    per-star `(B, M)` rows (the funnel's shortlists); global_idx :
    optional `(B, M)` model -> grid index map of per-star shortlists;
    coord : (B, 2); dust_profile : `(av_dist (Nd,), av_mean (B, Nd),
    av_std (B, Nd))`; noise : `z (B, K, 3, n_mc)`, `u`, `gumbel` drawn
    with `draw_noise(..., grid=True)`.

    Custom priors replace the built-in ones with per-star callables of
    the JAX package's contract, on torch tensors:
    `lngalprior(dist, coord, feh=, loga=)` (dist `(K,)` or `(K, n_mc)`,
    coord `(2,)`, feh and loga `(K,)`/`(K, 1)` or None) and
    `lndustprior(dist, av, av_dist, av_mean, av_std)`; they are applied
    over the star axis with `torch.func.vmap`.

    With a `model_group`, `results` and the grid rows cover this
    shard's contiguous slice of a grid sharded over that group (the
    dense reference engine on a mesh): the selection merges over the
    shards (`_select_grid`), and `noise` is drawn for the whole grid's
    model count; every shard returns the same result.

    Returns the fields of `lnpost_batch` (its `sel_idx` through
    `global_idx` when given).
    """
    B = results["lnlike"].shape[0]
    with profiling.span("bf.select"):
        parallax, parallax_err, coord = _star_args(
            B, results["lnlike"].device, parallax, parallax_err, coord)
        sel = _select_grid(results, lnprior_grid, feh, loga, global_idx,
                           coord, parallax, parallax_err, dust_profile, cfg,
                           gal_cfg, dust_cfg, apply_av_prior, lngalprior,
                           lndustprior, model_group)
    lnp_sel, valid = sel["lnp_sel"], sel["valid"]
    scale_k, av_k, rv_k = sel["scale_k"], sel["av_k"], sel["rv_k"]

    with profiling.span("bf.mc"):
        # covariances: stable inverse + PSD repair, on parts (:520-524)
        cov_p = psd_repair_parts(sel["icov_k"], scale_k, valid,
                                 cfg.psd_width, cfg.psd_max_passes,
                                 mvn_eps=cfg.mvn_eps)
        cov_k = sym3_from_parts(cov_p)

        # MC integration over the (s, Av, Rv) Gaussians (:526-565)
        l00, l10, l11, l20, l21, l22 = (x[..., None]
                                        for x in cholesky3_parts(cov_p))
        z0, z1, z2 = noise.z[:, :, 0], noise.z[:, :, 1], noise.z[:, :, 2]
        s_mc = scale_k[..., None] + l00 * z0                 # (B, K, Nmc)
        a_mc = av_k[..., None] + l10 * z0 + l11 * z1
        r_mc = rv_k[..., None] + l20 * z0 + l21 * z1 + l22 * z2
        par_mc = torch.sqrt(torch.clamp(s_mc, min=1e-30))
        dist_mc = 1.0 / par_mc
        lab = lambda x: None if x is None else x[..., None]
        lnp_mc = _gal_prior(dist_mc, coord, lab(sel["feh_k"]),
                            lab(sel["loga_k"]), gal_cfg, lngalprior)
        if apply_av_prior and dust_profile is not None:
            lnp_mc = lnp_mc + _dust_prior(dist_mc, a_mc, dust_profile,
                                          dust_cfg, lndustprior)
        lnp_mc = lnp_mc + parallax_lnprior(par_mc, parallax[:, None, None],
                                           parallax_err[:, None, None])
        inb = ((s_mc >= 1e-20) & (a_mc >= cfg.avlim[0])
               & (a_mc <= cfg.avlim[1]) & (r_mc >= cfg.rvlim[0])
               & (r_mc <= cfg.rvlim[1]))
        lnp_mc = torch.where(inb & torch.isfinite(lnp_mc), lnp_mc,
                             torch.full_like(lnp_mc, NEG_BIG))
        n_eff = inb.sum(2)
        lnp_sel = lnp_sel + torch.logsumexp(lnp_mc, dim=2) - torch.log(
            torch.clamp(n_eff, min=1).to(lnp_sel.dtype))
        lnp_sel = torch.where(valid & _is_valid(lnp_sel) & (n_eff > 0),
                              lnp_sel, torch.full_like(lnp_sel, NEG_BIG))

    with profiling.span("bf.draws"):
        log_evid, idxs = _evidence_and_draws(lnp_sel, sel["chi2_k"],
                                             noise.u, cfg.n_draws)

        # weighted categorical resampling (:566-577)
        nd = idxs.shape[1]
        take = lambda x: torch.gather(x, 1, idxs)
        at = lambda x: torch.gather(x, 1, idxs[..., None].expand(
            B, nd, x.shape[2]))                              # (B, nd, Nmc)
        lr = at(lnp_mc)
        imc = torch.argmax(lr + noise.gumbel, dim=2, keepdim=True)
        pick = lambda x: torch.gather(at(x), 2, imc)[..., 0]
        cov_sar = torch.gather(cov_k, 1, idxs[..., None, None].expand(
            B, nd, 3, 3))
        return dict(
            model_idx=take(sel["sel_gidx"]), scale=take(scale_k),
            av=take(av_k), rv=take(rv_k), cov_sar=cov_sar,
            lnprob=take(lnp_sel), dist=pick(dist_mc), red=pick(a_mc),
            dred=pick(r_mc), logwt=torch.gather(lr, 2, imc)[..., 0],
            log_evidence=log_evid, chi2min=sel["chi2min"],
            ndim=sel["ndim"], sel_idx=sel["sel_gidx"], lnp_sel=lnp_sel,
            valid_sel=valid)

__all__ = ["lnpost_batch", "lnpost_grid", "draw_noise", "selection_size",
           "Noise"]
