"""The comparison that decides `correct`: a sample of the stars the
timed calls returned, drawn from the seed, held against the plain
reference (`reference.py`), after the window has closed.

The reference works out each sampled star's posterior from the
benchmark's own inputs (grid, map, catalogue) as the configuration's
engine defines it, in float64: the funnel's screened shortlist (or
every model), the fits, the prefilter, the culls, the selection and the
Monte Carlo mean of exp(priors) over each selected model's Gaussian
(`N_MC_POST` quasi-random draws).  Against it, `numbers` reads the
following, each the largest over the sample unless said otherwise; a
cell's `limits` (`workloads/<cell>.json`) name the ones it holds, and
the run reports the others beside them:

- `cov_dev`: the widest gap between a drawn model's returned covariance
  of `(s, Av, Rv)` and the reference's at the returned point, each
  entry over the root of its two diagonal entries; over the pairs whose
  precision float32 can tell from singular (the determinant of its
  unit-diagonal form at least `RESOLVED` in size: nearer 0 the positive-
  definiteness test that picks brutus's repair follows the rounding);
- `lnprob_z`: a drawn model's returned log-posterior against the
  reference's at the returned point and covariance (`N_MC_REF`
  quasi-random draws), in units of the spread of a 50-draw mean, as
  the program takes it (bootstrapped from the reference's draws);
- `logwt_dev` (nats): every draw's returned `logwt` against the priors
  the reference finds at its returned `(dist, red, dred)`;
- `fit_excess`: the mean over the drawn models of the fit's objective
  (flux chi-square plus the Av and Rv prior terms) at the returned
  `(s, Av, Rv)` above its value at the reference's own fit of that
  model (brutus's fixed budget, in float64), where it is above
  (`fit_excess_max` the largest); `fit_gap` and `fit_gap_max` the same
  above the objective's least value within the limits
  (`reference.converged`), which also counts what the fixed budget
  itself leaves;
- `logz_p90`, `logz_med`, `logz_max` (nats): the 90th percentile,
  median and largest over the sampled stars of the gap between the
  returned log-evidence and the reference's; `logz_z` the largest gap
  from the mean of the reference's evidence under brutus's 50-draw
  Monte Carlo means, in their spread (bootstrapped, `_boot_posterior`);
- `weight_z`: the mean over the draws of the reference's log-weight of
  the drawn model, against its mean and spread under brutus's draws
  from 50-draw weights (bootstrapped), pooled over the sampled stars
  none of whose models' covariances brutus's repair touches, in
  standard deviations (`stars_repaired` counts the others);
- `draw_z`: the sum over the draws of their squared Mahalanobis
  distance from their model's returned point, in the reference's
  covariance there, against what brutus's draws give (each model's
  Gaussian, one draw of `n_mc` picked by its priors; simulated by the
  reference, `N_SETS` sets each), in standard deviations; over the
  resolved pairs (`draw_r2_max` the largest distance).

The control puts the reference, computed in TF32 (`reference.rnd`), in
the program's place: its own posterior of each sampled star (with
`n_mc` Monte Carlo draws of its own) and its own draws (`reference.
draw`), judged by the float64 reference as the program's answers are.
"""

import math

import numpy as np
import torch

from . import reference as ref

KEYS = ("model_idx", "scale", "av", "rv", "cov_sar", "lnprob", "dist",
        "red", "dred", "logwt", "log_evidence")
N_MC_REF = 4096
N_MC_POST = 512
N_SETS = 32
N_BOOT = 256
# one nat in a thousand: the arithmetic floor of a float32 log-posterior
# beside the bootstrap spread (which is 0 where the priors are flat)
LNPROB_FLOOR = 1e-3
# a unit-diagonal precision with a determinant below this is singular to
# float32 (its parts round at ~1e-7; the determinant carries that
# error times the condition number)
RESOLVED = 1e-4


def keep_rows(out, rows):
    return {k: np.asarray(out[k])[rows] for k in KEYS}


def sample(kept, n, seed, largest, last):
    """`n` of the kept `(call, row, outputs)` records drawn from the
    seed, always with one of the largest call and one of the last."""
    rng = np.random.default_rng([seed, 7])
    pick = set(rng.choice(len(kept), min(n, len(kept)), replace=False))
    for call in (largest, last):
        hit = [i for i, k in enumerate(kept) if k[0] == call]
        if hit and not pick & set(hit):
            pick.add(hit[0])
    return [kept[i] for i in sorted(pick)]


def _stars(records, cats, dmap, fit_kw, dev, prec="f64"):
    """Per sampled star, in precision `prec`: bands, coordinates,
    parallax, its dust profile on the uniform ladder, and the limits."""
    cat = lambda key: np.stack([cats[c][key][r] for c, r, _ in records])
    coords = cat("coords")
    dists, mean, std = dmap.query((coords[:, 0], coords[:, 1]))
    ladder, mean_u, std_u = ref.uniform_ladder(dists, mean, std)
    t = lambda x: ref.rnd(np.asarray(x, float), prec, dev)
    return dict(flux=cat("flux"), err=cat("err"), mask=cat("mask"),
                l=t(coords[:, 0]), b=t(coords[:, 1]), plx=t(cat("plx")),
                plxe=t(cat("plxe")), ladder=ladder, mean=t(mean_u),
                std=t(std_u), avlim=fit_kw["avlim"], rvlim=fit_kw["rvlim"])


def _normals(n, seed, dev):
    """`n` scrambled-Sobol standard normals in 3 dimensions."""
    sob = torch.quasirandom.SobolEngine(3, scramble=True,
                                        seed=int(seed) % 2 ** 31)
    u = sob.draw(n, dtype=torch.float64).clamp(1e-12, 1 - 1e-12)
    return (math.sqrt(2.0) * torch.erfinv(2 * u - 1)).to(dev)


def answers(records, cats, mc, labels, dmap, fit_kw, dev, seed, prec,
            n_mc):
    """The answers judged: the program's records, or with `prec` other
    than "f64" the control's, the reference in that precision in the
    program's place."""
    if prec == "f64":
        return [out for _, _, out in records]
    gen = torch.Generator().manual_seed(int(seed) % 2 ** 63 + 3)
    grid = ref.Grid(mc, labels, prec, dev)
    post = ref.posterior(grid, _stars(records, cats, dmap, fit_kw, dev,
                                      prec), fit_kw, n_mc, gen=gen)
    return ref.draw(post, int(fit_kw["Ndraws"]), gen)


def numbers(records, cats, mc, labels, dmap, fit_kw, dev, seed,
            prec="f64", n_mc=50):
    """The compared numbers of the sampled `records` (the control's
    with `prec` other than "f64")."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    outs = answers(records, cats, mc, labels, dmap, fit_kw, dev, seed,
                   prec, n_mc)
    st, mod, first, inv = [], [], [], []
    for si, out in enumerate(outs):
        u, pos, back = np.unique(out["model_idx"], return_index=True,
                                 return_inverse=True)
        inv.append(back + len(st))
        st += [si] * len(pos)
        mod += [int(out["model_idx"][p]) for p in pos]
        first += list(pos)
    st, mod, inv = np.asarray(st), np.asarray(mod), np.concatenate(inv)
    cat = lambda key: np.stack([cats[c][key][r] for c, r, _ in records])
    flux, err, mask = cat("flux")[st], cat("err")[st], cat("mask")[st]
    f64 = lambda x: torch.as_tensor(np.asarray(x, float), device=dev)
    got = lambda key: np.stack([outs[s][key][p]
                                for s, p in zip(st, first)])
    star = _stars(records, cats, dmap, fit_kw, dev)
    model = dict(feh=f64(labels["feh"][mod]), loga=f64(labels["loga"][mod]))
    lnprior = f64(ref.grid_lnprior(labels)[mod])
    F = ref.Fit(mc[mod], flux, err, mask, fit_kw, "f64", dev)
    s_p, av_p, rv_p = f64(got("scale")), f64(got("av")), f64(got("rv"))
    cov_p, lnprob_p = f64(got("cov_sar")), f64(got("lnprob"))
    star_i = torch.as_tensor(st, device=dev)
    pair_star = ref._star_rows_at(star, star_i)

    # cov_dev, at the returned point
    parts = F.precision(av_p, rv_p)
    C = ref.covariance(parts, s_p)
    d = torch.sqrt(C.diagonal(dim1=-2, dim2=-1))
    P = ref._sym(parts)
    e = torch.sqrt(P.diagonal(dim1=-2, dim2=-1).abs())
    resolved = torch.linalg.det(P / e[:, :, None] / e[:, None, :]).abs() \
        >= RESOLVED
    cov_dev = torch.where(resolved, ((cov_p - C).abs() / d[:, :, None]
                                     / d[:, None, :]).amax((1, 2)),
                          torch.zeros_like(s_p))
    # lnprob_z, at the returned point, with the returned covariance
    z = _normals(N_MC_REF, seed, dev)
    gen = torch.Generator().manual_seed(int(seed) % 2 ** 63 + 1)
    boot = torch.randint(0, N_MC_REF, (N_BOOT, n_mc), generator=gen).to(dev)
    lnp, inb, _ = ref.mc_draws(s_p, av_p, rv_p, cov_p, pair_star, model, z)
    term, _ = ref.log_mean_exp(lnp, inb)
    bn = inb[:, boot].sum(-1).clamp(min=1).to(lnp.dtype)
    var = (torch.logsumexp(lnp[:, boot], -1) - torch.log(bn)).var(1)
    lnprob_r = F.lnlike(F.chi2(s_p, av_p, rv_p)) + lnprior + term
    lnprob_z = (lnprob_p - lnprob_r).abs() / torch.sqrt(
        var + LNPROB_FLOOR ** 2)
    del lnp, inb

    # fit_gap: the objective at the returned point over its least value
    J = ref.objective(F, s_p, av_p, rv_p)
    fixed = F.brutus_fit()
    J_min = ref.converged(F, [(s_p, av_p, rv_p), fixed])
    gap = torch.clamp(J - J_min, min=0.0)
    excess = torch.clamp(J - ref.objective(F, *fixed), min=0.0)

    # logz_z and weight_z, against the reference's posterior and the
    # spread of brutus's n_mc-draw Monte Carlo means (bootstrapped)
    grid = ref.Grid(mc, labels, "f64", dev)
    post = ref.posterior(grid, star, fit_kw, N_MC_POST,
                         z=_normals(N_MC_POST, seed + 2, dev))
    logz_z, logz_dev, dev_w, var_w = [], [], 0.0, 0.0
    repaired = torch.zeros(len(outs), dtype=torch.bool, device=dev)
    repaired.index_put_((star_i,), ~ref._pd(C), accumulate=True)
    n_rep = 0
    for si, (out, p) in enumerate(zip(outs, post)):
        logz_b, E_b, V_b = _boot_posterior(p, n_mc, gen)
        logz_dev.append(abs(float(out["log_evidence"]) - float(p["logz"])))
        logz_z.append(abs(float(out["log_evidence"]) - float(logz_b.mean()))
                      / math.sqrt(float(logz_b.var()) + LNPROB_FLOOR ** 2))
        if bool(p["repaired"][p["keep"]].any()) or bool(repaired[si]):
            n_rep += 1          # its weights follow the repair's rounding
            continue
        ell = p["lnp"][p["keep"]] - p["logz"]
        at = {int(m): float(v) for m, v in zip(p["idx"][p["keep"]], ell)}
        low = float(ell.min()) if len(ell) else 0.0
        got_ell = np.asarray([at.get(int(m), low) for m in out["model_idx"]])
        nd = len(got_ell)
        dev_w += float(got_ell.mean() - E_b.mean())
        var_w += float(E_b.var() + V_b.mean() / nd)
    weight_z = abs(dev_w) / math.sqrt(max(var_w, 1e-300))

    # logwt_dev and draw_z, every draw
    pick = lambda key: np.concatenate([out[key] for out in outs])
    dist, red, dred = f64(pick("dist")), f64(pick("red")), f64(pick("dred"))
    rs = torch.as_tensor(np.concatenate([[si] * len(out["model_idx"])
                                         for si, out in enumerate(outs)]),
                         device=dev)
    drawn = pick("model_idx")
    dmodel = dict(feh=f64(labels["feh"][drawn]),
                  loga=f64(labels["loga"][drawn]))
    lw_r, _ = ref.star_priors(dist[:, None], red[:, None], dred[:, None],
                              1.0 / dist[:, None] ** 2,
                              ref._star_rows_at(star, rs), dmodel)
    logwt_dev = (f64(pick("logwt")) - lw_r[:, 0]).abs()
    k = torch.as_tensor(inv, device=dev)
    x = torch.stack([1.0 / dist ** 2, red, dred], -1)
    mu = torch.stack([s_p, av_p, rv_p], -1)
    dx = (x - mu[k])[..., None]
    r2 = (dx.transpose(-1, -2) @ torch.linalg.solve(C[k], dx))[:, 0, 0]
    res_k = resolved[k]
    zs = torch.randn((N_SETS * n_mc, 3), generator=gen,
                     dtype=torch.float64).to(dev)
    lnp, _, _ = ref.mc_draws(s_p, av_p, rv_p, C, pair_star, model, zs)
    w = torch.softmax(lnp.view(-1, N_SETS, n_mc), -1)
    q = (zs * zs).sum(-1).view(N_SETS, n_mc)
    m_set = (w * q).sum(-1)
    v_set = (w * q * q).sum(-1) - m_set ** 2
    n_p = torch.bincount(k[res_k], minlength=len(st)).to(torch.float64)
    use = resolved & (n_p > 0)
    expect = (n_p * m_set.mean(1))[use].sum()
    spread = (n_p ** 2 * m_set.var(1) + n_p * v_set.mean(1))[use].sum()
    draw_z = abs(float(r2[res_k].sum() - expect)) / math.sqrt(
        max(float(spread), 1e-300))

    big = lambda x: float(torch.nan_to_num(x, nan=math.inf).amax())
    return dict(cov_dev=big(cov_dev),
                resolved=float(resolved.double().mean()),
                lnprob_z=big(lnprob_z), logwt_dev=big(logwt_dev),
                fit_gap=float(torch.nan_to_num(gap, nan=math.inf).mean()),
                fit_gap_max=big(gap),
                fit_excess=float(torch.nan_to_num(excess, nan=math.inf)
                                 .mean()), fit_excess_max=big(excess),
                logz_z=max(logz_z), logz_max=max(logz_dev),
                logz_med=float(np.median(logz_dev)),
                logz_p90=float(np.quantile(logz_dev, 0.9)),
                weight_z=weight_z, draw_z=draw_z,
                draw_r2_max=big(r2[res_k]) if bool(res_k.any()) else 0.0,
                stars_repaired=n_rep, pairs=int(len(st)),
                draws=int(len(rs)))


def _boot_posterior(p, n_mc, gen, n_boot=64):
    """A star's posterior as brutus's `n_mc`-draw Monte Carlo means give
    it, in `n_boot` bootstrap sets of the reference's draws (each model
    its own `n_mc` of them): per set the log-evidence, and the mean and
    variance under the set's weights of the reference's log-weight of a
    model (`lnp - logz`)."""
    keep = p["keep"]
    lnp_mc, inb, score = p["lnp_mc"][keep], p["inb"][keep], p["score"][keep]
    K, n = lnp_mc.shape
    ell = p["lnp"][keep] - p["logz"]
    idx = torch.randint(0, n, (n_boot, K, n_mc), generator=gen).to(
        lnp_mc.device)
    l = torch.gather(lnp_mc.expand(n_boot, K, n), 2, idx)
    n_in = torch.gather(inb.expand(n_boot, K, n), 2, idx).sum(-1)
    lnp_b = score + torch.logsumexp(l, -1) - torch.log(
        torch.clamp(n_in, min=1).to(l.dtype))
    lnp_b = torch.where(n_in > 0, lnp_b, torch.full_like(lnp_b, -math.inf))
    logz_b = torch.logsumexp(lnp_b, 1)
    w = torch.softmax(lnp_b, 1)
    E = (w * ell).sum(1)
    return logz_b, E, (w * ell * ell).sum(1) - E * E


def judge(values, limits):
    """`(correct, checks)`: each compared number beside its limit."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in checks.values())
    return ok, checks
