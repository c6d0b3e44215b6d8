"""
Interpolation on grids (mirrors `brutus_tpu/ops/interp.py`).

- `interpn`: multilinear interpolation on a rectilinear grid, a gather of
  the 2**ndim corners and a blend, NaN outside the grid (the semantics
  of `scipy.interpolate.RegularGridInterpolator(method="linear",
  bounds_error=False, fill_value=nan)`, which the reference uses for the
  MIST tracks and isochrones).
- `interp1d_monotone_bisect`: a fixed number of bisection steps on a
  monotone function, NaN counted as "too high".
- `interp`: `jnp.interp` with its `left` / `right` fill values, over
  one axis or a batch of axes.

A NaN corner of the table poisons the blend even where its weight is 0
(`v * w`), as in the JAX function: the NaN pattern of the tables'
holes is part of the result.
"""

import numpy as np
import torch


def interpn(points, values, xi, fill_nan=True):
    """Multilinear interpolation of `values` on the grid `points` at `xi`
    (mirrors `brutus_tpu.ops.interp.interpn`).

    points : tuple of `ndim` ascending 1-D tensors `(n_k,)`.
    values : `(n_0, ..., n_{ndim-1}, ...)`; trailing axes are
        interpolated together.
    xi : `(..., ndim)` query points.

    Returns `(..., <trailing value axes>)`, NaN outside the grid and at
    non-finite queries when `fill_nan`.  The 2**ndim corners are one
    gather of the flattened table and one weighted sum (the JAX function
    loops over them; the sum's order differs by rounding only).
    """
    ndim = len(points)
    dims = values.shape[:ndim]
    trail = values.shape[ndim:]
    flat = values.reshape((-1,) + trail)
    idxs, ts, oob = [], [], None
    for k in range(ndim):
        g = points[k]
        x = xi[..., k]
        i = torch.clamp(torch.searchsorted(g, x.contiguous(), right=True) - 1,
                        0, g.shape[0] - 2)
        idxs.append(i)
        ts.append((x - g[i]) / (g[i + 1] - g[i]))
        out = (x < g[0]) | (x > g[-1]) | ~torch.isfinite(x)
        oob = out if oob is None else (oob | out)

    # Corner c takes the upper node on axis k where bit k of c is set.
    dev = xi.device
    hi = torch.tensor([[(c >> k) & 1 for k in range(ndim)]
                       for c in range(1 << ndim)], device=dev)
    strides = torch.tensor([int(np.prod(dims[k + 1:])) for k in range(ndim)],
                           device=dev)
    lin = ((torch.stack(idxs, -1)[..., None, :] + hi) * strides).sum(-1)
    t = torch.stack(ts, -1)[..., None, :]
    w = torch.where(hi > 0, t, 1.0 - t).prod(-1)         # (..., 2**ndim)
    v = flat[lin]                                # (..., 2**ndim, *trail)
    out = (v * w[(...,) + (None,) * len(trail)]).sum(-1 - len(trail))

    if fill_nan:
        mask = oob[(...,) + (None,) * len(trail)]
        out = torch.where(mask, torch.full_like(out, torch.nan), out)
    return out


def interp1d_monotone_bisect(f, lo, hi, n_iter=50):
    """Bisection root of a monotone-increasing `f` in `[lo, hi]` after
    `n_iter` steps (mirrors `brutus_tpu.ops.interp.
    interp1d_monotone_bisect`).  NaN values of `f` sit at the late-EEP
    (large-f) end of MIST tracks and are taken as "too high"."""
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        fm = f(mid)
        go_low = (fm > 0) | torch.isnan(fm)
        hi = torch.where(go_low, mid, hi)
        lo = torch.where(go_low, lo, mid)
    return 0.5 * (lo + hi)


def interp(x, xp, fp, left=None, right=None):
    """Piecewise-linear interpolation with `jnp.interp`'s semantics
    (`jax._src.numpy.lax_numpy._interp`): the interval index from a
    right-sided search clipped to `[1, n - 1]`, intervals of width at
    most `spacing(eps)` taking their left value, and `left` / `right`
    (the end values when None) outside `[xp[0], xp[-1]]`.  An interval
    that ends at +inf gives its left value to every finite query in it.

    xp, fp : `(n,)`, or `(..., n)` with `x` of shape `(..., k)` (one
        axis per leading index).
    """
    n = xp.shape[-1]
    batched = xp.dim() > 1
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    n - 1)
    if batched:
        take = lambda a, j: torch.gather(a, -1, j)
    else:
        take = lambda a, j: a[j]
    fl, fr = take(fp, i - 1), take(fp, i)
    xl, xr = take(xp, i - 1), take(xp, i)
    df = fr - fl
    dx = xr - xl
    delta = x - xl
    eps = float(np.spacing(np.finfo(
        torch.empty((), dtype=xp.dtype).numpy().dtype).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fl,
                    fl + (delta / torch.where(dx0, torch.ones_like(dx), dx))
                    * df)
    first, last = xp[..., :1], xp[..., -1:]
    lv = fp[..., :1] if left is None else torch.full_like(f, left)
    rv = fp[..., -1:] if right is None else torch.full_like(f, right)
    f = torch.where(x < first, lv, f)
    return torch.where(x > last, rv, f)


__all__ = ["interpn", "interp1d_monotone_bisect", "interp"]
