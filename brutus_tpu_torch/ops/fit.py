"""
Dense fit engine of the PyTorch port: every star against every model of
one shared grid (mirrors `brutus_tpu/ops/pallas_loglike.py`'s
`prepare_coeffs`, `_post`, `icov_from_parts` and `loglike_grid_fused`).

K1 in dense mode replaces `pallas_loglike.py:66 _make_kernel` with
`per_star=False` (pallas_call at :819, wrapper `loglike_grid_fused`
:710).  The CUDA kernel is `csrc/fit.cu`'s `bk_fit_dense`: the same body
as the funnel's stacked mode (`funnel.fit_pack`), with each block
fitting a group of 8 stars against one window of the shared grid
staged in shared memory, and `_post` applied in its epilogue.  Its
plain version, `fit_dense_plain`, is `funnel.fit_pack_plain` on the
grid broadcast over the stars.  The wrapper `fit_dense` runs the plain
version for CPU tensors and launches the kernel for CUDA tensors.
"""

import numpy as np
import torch

from ..config import FitConfig
from ._native import KERNELS, check
from .funnel import _fit_params, fit_pack_plain, post_consts
from .optimize import prepare_star_data


def prepare_coeffs(mag_coeffs, tile=2048, device=None):
    """`(M, F, 3)` -> `(3, F, Mp)` float32 with `Mp` a multiple of
    `tile`, padded with copies of the last model made 60 mag fainter
    (mirrors `pallas_loglike.prepare_coeffs`, :648-658).  Returns
    `(coeffs_t, M)`."""
    mc = np.asarray(mag_coeffs, dtype=np.float32)
    M = mc.shape[0]
    rem = (-M) % tile
    if rem:
        pad = np.repeat(mc[-1:], rem, axis=0).copy()
        pad[..., 0] += 60.0
        mc = np.concatenate([mc, pad], axis=0)
    ct = torch.from_numpy(np.ascontiguousarray(mc.transpose(2, 1, 0)))
    return ct.to(device if device is not None else "cpu"), M


def icov_from_parts(parts):
    """Assemble `(..., 3, 3)` precisions from the 6 unique components
    `(s_den, a_den, r_den, sa, sr, ar)` (mirrors
    `pallas_loglike.icov_from_parts`, :699-706)."""
    s_den, a_den, r_den, sa, sr, ar = parts
    return torch.stack([
        torch.stack([s_den, sa, sr], dim=-1),
        torch.stack([sa, a_den, ar], dim=-1),
        torch.stack([sr, ar, r_den], dim=-1),
    ], dim=-2)


def fit_dense_plain(star, coeffs_t, srow, n_real_mask, tile,
                    cfg: FitConfig):
    """Plain version of K1 in dense mode: the stacked mode's arithmetic
    (`funnel.fit_pack_plain`) on the grid broadcast over the stars, the
    grid index being the model column."""
    B = star.shape[0]
    _, F, Mp = coeffs_t.shape
    coef = coeffs_t.reshape(3 * F, 1, Mp).expand(3 * F, B, Mp)
    gidx = torch.arange(Mp, dtype=torch.int32,
                        device=star.device).expand(B, Mp)
    pack = fit_pack_plain(star, coef, gidx, srow, 0, 12, n_real_mask, tile,
                          cfg)
    return pack[:, :11].transpose(0, 1)


def fit_dense(star, coeffs_t, srow, n_real_mask, tile, cfg: FitConfig):
    """K1, dense mode: fit every model of `coeffs_t` for every star.

    star : (B, 4, F) `[flux, wt_flux, mags, wt_mag]`; coeffs_t :
    (3, F, Mp) from `prepare_coeffs`; srow : (B, 3) `post_consts`;
    models with index `>= n_real_mask` are masked (negative: no mask);
    the freeze of phase B is local to `tile`-wide windows of the grid.
    Returns (11, B, Mp): lnlike (with `_post` applied), chi2, scale,
    av, rv and the 6 precision parts.
    """
    if star.device.type == "cpu":
        return fit_dense_plain(star, coeffs_t, srow, n_real_mask, tile, cfg)
    dev = star.device
    B, _, F = star.shape
    _, _, Mp = coeffs_t.shape
    check(star, "star", (B, 4, F), device=dev)
    check(coeffs_t, "coeffs_t", (3, F, Mp), device=dev)
    check(srow, "srow", (B, 3), device=dev)
    if Mp % tile or not 1 <= tile <= 1024 or F > 64:
        raise ValueError("fit_dense: inconsistent shapes for the fit "
                         "kernel")
    out = torch.empty((11, B, Mp), dtype=torch.float32, device=dev)
    KERNELS["fit_dense"](star, coeffs_t, srow, _fit_params(cfg, dev), out,
                         B, F, Mp, n_real_mask, tile, cfg.kernel_mag_iters,
                         cfg.kernel_flux_iters, int(cfg.dim_prior))
    return out


def loglike_grid_fused(flux, fluxerr, mask, coeffs_t, parallax=None,
                       parallax_err=None, cfg: FitConfig = FitConfig(),
                       tile=512, n_real=None):
    """Per-star log-likelihood of every grid model (mirrors
    `pallas_loglike.loglike_grid_fused`, :710-771).

    flux, fluxerr, mask : (B, F); coeffs_t : (3, F, Mp) from
    `prepare_coeffs` (Mp a multiple of `tile`); models from `n_real` on
    are padding and get lnlike -1e30, chi2 1e30.  The parallax is not
    used here, as in the JAX package (the posterior applies it).

    Returns a dict: `lnlike, chi2, scale, av, rv` (B, Mp), `icov_parts`
    the 6 precision parts (B, Mp) each, and `ndim` (B,).
    """
    dev = coeffs_t.device
    flux = flux.to(dev, torch.float32)
    fluxerr = fluxerr.to(dev, torch.float32)
    mask = mask.to(dev)
    Mp = coeffs_t.shape[2]
    flux_p, wt_flux, mags, wt_mag, mask, ndim, tot_var = \
        prepare_star_data(flux, fluxerr, mask, cfg)
    star4 = torch.stack([flux_p, wt_flux, mags, wt_mag], dim=1).contiguous()
    n_real_mask = n_real if n_real is not None and n_real < Mp else -1
    out = fit_dense(star4, coeffs_t, post_consts(mask, ndim, tot_var),
                    n_real_mask, tile, cfg)
    return dict(lnlike=out[0], ndim=ndim, chi2=out[1], scale=out[2],
                av=out[3], rv=out[4], icov_parts=tuple(out[5:11]))


__all__ = ["prepare_coeffs", "icov_from_parts", "fit_dense",
           "fit_dense_plain", "loglike_grid_fused"]
