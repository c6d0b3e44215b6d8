"""
Affine-invariant ensemble MCMC (Goodman & Weare stretch moves), a
power-posterior ladder for evidences, and chain diagnostics (mirrors
`brutus_tpu/sampling.py`).

The reference leaves its applications' likelihoods to an external
sampler (dynesty; reference `brutus/los.py:27-33`, demos "Overview 4/5");
the JAX package samples them itself, and so does the port.  Every
walker's log-posterior is one batched call per half-step, and the chain
stays on the device: the steps draw from an explicit `torch.Generator`
on the walkers' device and read nothing back until the chain is done.
Only the half of the ensemble that a half-step moves is evaluated (the
JAX sampler evaluates all walkers and discards the other half).  The
random streams are not JAX's, so chains agree with the JAX package's as
distributions, not draw for draw.

The diagnostics (autocorrelation time, effective sample size, split
R-hat) and the evidence estimators run on the host in numpy.
"""

import numpy as np
import torch

from .utils import resolve_device


def _generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _stretch(u, active, a, g):
    """Stretch-move proposals for the walkers `active` (a slice of the
    walker axis, the last but one of `u (..., W, ndim)`): a partner from
    the other half for every walker and its stretch factor `z`; returns
    the active walkers' proposals and `z` and the log-uniforms of their
    acceptance test."""
    *lead, W, ndim = u.shape
    half = W // 2
    j = torch.randint(0, half, (*lead, W), generator=g, device=u.device)
    idx = torch.where(torch.arange(W, device=u.device) < half, half + j, j)
    partners = torch.gather(u, -2, idx[..., None].expand(*lead, W, ndim))
    zu = torch.rand((*lead, W), generator=g, dtype=u.dtype, device=u.device)
    z = ((a - 1.0) * zu + 1.0) ** 2 / a
    prop = partners + z[..., None] * (u - partners)
    lnu = torch.log(torch.rand((*lead, W), generator=g, dtype=u.dtype,
                               device=u.device))
    return prop[..., active, :], z[..., active], lnu[..., active]


def ensemble_sample(logpost, ndim, n_walkers=64, n_steps=1500,
                    stretch_a=2.0, seed=0, init=None, logpost_args=(),
                    device=None):
    """A stretch-move ensemble sampler (mirrors
    `brutus_tpu.sampling.ensemble_sample`).

    logpost : callable `(u (n, ndim), *logpost_args) -> (n,)`, batched;
        out-of-support positions return -inf (never accepted).
    n_walkers : even; the two halves move in turns, each against the
        other (the parallel variant of Goodman & Weare 2010).
    init : `(W, ndim)` start, else uniform in `(0.02, 0.98)^ndim` (the
        unit cube of prior transforms).
    device : where the walkers live, in float64 (CUDA unless the caller
        names another); `seed` seeds a generator there.

    Returns a dict of device tensors `chain (n_steps, W, ndim)`,
    `logp (n_steps, W)`, `accept (n_steps, W)` bool.
    """
    if n_walkers % 2:
        raise ValueError("n_walkers must be even")
    dev = resolve_device(device)
    W, half = n_walkers, n_walkers // 2
    g = _generator(seed, dev)
    if init is None:
        u = 0.02 + 0.96 * torch.rand((W, ndim), generator=g,
                                     dtype=torch.float64, device=dev)
    else:
        u = torch.as_tensor(init, dtype=torch.float64, device=dev).clone()
    lp = logpost(u, *logpost_args)
    chain = torch.empty((n_steps, W, ndim), dtype=u.dtype, device=dev)
    logp = torch.empty((n_steps, W), dtype=lp.dtype, device=dev)
    accept = torch.zeros((n_steps, W), dtype=torch.bool, device=dev)
    halves = (slice(0, half), slice(half, W))
    for step in range(n_steps):
        for sl in halves:
            prop, z, lnu = _stretch(u, sl, stretch_a, g)
            lp_prop = logpost(prop, *logpost_args)
            ok = lnu < (ndim - 1) * torch.log(z) + lp_prop - lp[sl]
            u[sl] = torch.where(ok[:, None], prop, u[sl])
            lp[sl] = torch.where(ok, lp_prop, lp[sl])
            accept[step, sl] = ok
        chain[step] = u
        logp[step] = lp
    return dict(chain=chain, logp=logp, accept=accept)


def default_beta_ladder(n_temps, power=5.0):
    """Inverse temperatures `beta_k = (k / (K - 1))**power`, from 0 (the
    prior) to 1 (the posterior), dense near 0 (mirrors
    `brutus_tpu.sampling.default_beta_ladder`; Friel & Pettitt 2008)."""
    k = np.arange(int(n_temps), dtype=np.float64)
    return (k / (n_temps - 1)) ** float(power)


def tempered_ensemble_sample(logl, ndim, betas, n_walkers=64,
                             n_steps=1500, stretch_a=2.0, seed=0,
                             logl_args=(), device=None):
    """One independent stretch-move ensemble per inverse temperature in
    `betas`, targeting `prior * L**beta` (mirrors
    `brutus_tpu.sampling.tempered_ensemble_sample`); the support
    (`logl` of -inf) belongs to the prior and is never tempered.  Every
    rung's walkers are one batched `logl` call per half-step.

    logl : callable `(u (n, ndim), *logl_args) -> (n,)`, the batched
        log-likelihood over the prior unit cube.
    betas : `(K,)` ascending, 0 first and 1 last.

    Returns device tensors, rung-major: `chain (K, n_steps, W, ndim)`,
    `logl (K, n_steps, W)` (raw, untempered), `accept (K, n_steps, W)`.
    """
    if n_walkers % 2:
        raise ValueError("n_walkers must be even")
    dev = resolve_device(device)
    W, half, K = n_walkers, n_walkers // 2, len(betas)
    beta = torch.as_tensor(np.asarray(betas, float), device=dev)[:, None]
    g = _generator(seed, dev)
    u = 0.02 + 0.96 * torch.rand((K, W, ndim), generator=g,
                                 dtype=torch.float64, device=dev)
    batched = lambda x: logl(x.reshape(-1, ndim),
                             *logl_args).reshape(x.shape[:-1])
    ll = batched(u)
    temper = lambda v: torch.where(torch.isfinite(v), beta * v,
                                   torch.full_like(v, -torch.inf))
    chain = torch.empty((K, n_steps, W, ndim), dtype=u.dtype, device=dev)
    lls = torch.empty((K, n_steps, W), dtype=ll.dtype, device=dev)
    accept = torch.zeros((K, n_steps, W), dtype=torch.bool, device=dev)
    for step in range(n_steps):
        for sl in (slice(0, half), slice(half, W)):
            prop, z, lnu = _stretch(u, sl, stretch_a, g)
            ll_prop = batched(prop)
            ok = lnu < ((ndim - 1) * torch.log(z) + temper(ll_prop)
                        - temper(ll[:, sl]))
            u[:, sl] = torch.where(ok[..., None], prop, u[:, sl])
            ll[:, sl] = torch.where(ok, ll_prop, ll[:, sl])
            accept[:, step, sl] = ok
        chain[:, step] = u
        lls[:, step] = ll
    return dict(chain=chain, logl=lls, accept=accept)


def evidence_from_ladder(betas, logl, n_blocks=8):
    """Log-evidence from power-posterior samples `logl (K, S, W)` (raw,
    post-burn) at `betas` (mirrors
    `brutus_tpu.sampling.evidence_from_ladder`): `logz`, the
    stepping-stone estimate (Xie et al. 2011); `logz_err`, its
    standard error over `n_blocks` time blocks; `logz_ti`, the
    thermodynamic-integration cross-check (biased low by the ladder's
    discretisation where the integrand is convex)."""
    from scipy.special import logsumexp
    betas = np.asarray(betas, np.float64)
    ll = np.asarray(logl, np.float64)
    K, S, W = ll.shape
    if K != len(betas):
        raise ValueError("logl leading axis must match betas")
    dbs = np.diff(betas)

    def ss(ll_kt):                       # (K, s, W) -> scalar
        n = ll_kt.shape[1] * ll_kt.shape[2]
        return float(sum(
            logsumexp(dbs[k] * ll_kt[k].ravel()) - np.log(n)
            for k in range(K - 1)))

    logz = ss(ll)
    bs = max(1, S // n_blocks)
    blocks = [ss(ll[:, i * bs:(i + 1) * bs]) for i in range(n_blocks)
              if ll[:, i * bs:(i + 1) * bs].shape[1] > 0]
    logz_err = float(np.std(blocks) / np.sqrt(len(blocks)))
    # TI on the per-rung mean lnL, without the -inf stragglers a rung's
    # burn-in failed to clear (they carry no posterior mass).
    mean_ll = np.empty(K)
    for k in range(K):
        v = ll[k].ravel()
        v = v[np.isfinite(v)]
        mean_ll[k] = v.mean() if len(v) else -np.inf
    logz_ti = float(np.trapezoid(mean_ll, betas)
                    if hasattr(np, "trapezoid")
                    else np.trapz(mean_ll, betas))
    return dict(logz=logz, logz_err=logz_err, logz_ti=logz_ti)


def integrated_autocorr_time(x, c=5.0):
    """Per-parameter integrated autocorrelation time of an ensemble chain
    `x (n_steps, n_walkers, ndim)` (mirrors
    `brutus_tpu.sampling.integrated_autocorr_time`): emcee's method, the
    FFT autocorrelation per walker averaged over walkers and integrated
    with Sokal's adaptive window."""
    x = np.asarray(x, np.float64)
    n, w, d = x.shape
    nfft = 1 << (2 * n - 1).bit_length()
    xc = x - x.mean(axis=0, keepdims=True)
    f = np.fft.rfft(xc, n=nfft, axis=0)
    acf = np.fft.irfft(f * np.conjugate(f), n=nfft, axis=0)[:n]
    acf /= np.maximum(acf[0:1], 1e-300)          # normalize per (w, d)
    rho = acf.mean(axis=1)                       # (n, d) walker-avg
    tau = np.empty(d)
    for k in range(d):
        cumsum = 2.0 * np.cumsum(rho[:, k]) - 1.0
        window = np.arange(n) < c * cumsum
        m = np.argmin(window) if not window.all() else n - 1
        tau[k] = cumsum[min(m, n - 1)]
    return np.maximum(tau, 1.0)


def split_rhat(x):
    """Per-parameter split-chain Gelman-Rubin R-hat of an ensemble chain
    `x (n_steps, n_walkers, ndim)` (mirrors `brutus_tpu.sampling.
    split_rhat`); near 1 when the walkers agree."""
    x = np.asarray(x, np.float64)
    n, w, d = x.shape
    h = n // 2
    sub = np.concatenate([x[:h], x[h:2 * h]], axis=1)   # (h, 2w, d)
    mean_c = sub.mean(axis=0)                            # (2w, d)
    var_c = sub.var(axis=0, ddof=1)
    W_ = var_c.mean(axis=0)
    B = h * mean_c.var(axis=0, ddof=1)
    var_post = (h - 1) / h * W_ + B / h
    return np.sqrt(var_post / np.maximum(W_, 1e-300))


def chain_diagnostics(chain, accept=None):
    """Autocorrelation time, effective sample size, split R-hat and mean
    acceptance of a post-burn chain `(n_steps, W, ndim)` (mirrors
    `brutus_tpu.sampling.chain_diagnostics`)."""
    chain = np.asarray(chain)
    n, w, d = chain.shape
    tau = integrated_autocorr_time(chain)
    out = dict(tau=tau, ess=n * w / tau, rhat=split_rhat(chain))
    if accept is not None:
        out["acceptance"] = float(np.asarray(accept).mean())
    return out


__all__ = ["ensemble_sample", "tempered_ensemble_sample",
           "default_beta_ladder", "evidence_from_ladder",
           "integrated_autocorr_time", "split_rhat", "chain_diagnostics"]
