"""
The reference-semantics funnel: screen every model, fit a shortlist with
the convergence loops of `optimize.loglike_grid` (mirrors
`brutus_tpu/ops/screen_xla.py`, one device).

Stage 1 is the fused funnel's own: K2 scores every model with the
clamped direct 3x3 weighted least-squares solve plus the parallax chi2
(the JAX package's plain-XLA screen evaluates the same
`screen_score_from_sums`, `screen_xla.py:17-19`), the best
`screen_k // block` blocks of each star are kept (`_select_blocks`)
and K3 gathers them, all on the tables `convert.from_numpy_grid`
builds.  The JAX package's three-way bf16 split tables
(`prepare_screen_xla`) are not built: they are the TPU matrix unit's
way of summing at float32 precision, and K2 sums in float32 already.

Stage 2 reshapes each star's gathered slab to `(P, F, 3)` coefficients
and its aux rows, and runs the batched `optimize.loglike_grid` body on
the shortlists: the same engine as the dense reference engine, whose
convergence predicates then range over the shortlist.  Padding models
inside selected slabs are fitted as the JAX package pads its grid (the
last model, 60 mag fainter) and killed by grid index afterwards.

On a mesh's `model` axis (`model_group`, the JAX package's
`model_axis`), each shard screens its slice of the grid and the
shortlists merge exactly as the fused funnel's do
(`funnel.select_and_gather`); stage 2 then runs on every shard.  The
padding's faint copy comes from `last`, the last real model's rows
that every shard carries (`convert.GridTables.last`): the shard that
holds column `n_real - 1` is only one of them.
"""

import math

import torch

from ..config import FitConfig
from ..parallel.mesh import group_size
from .funnel import (_screen_parallax, _screen_star_mats, _slab_block,
                     screen_blocks, select_and_gather)
from .optimize import _loglike_grid_body, highest_precision, \
    prepare_star_data


def loglike_grid_screened_xla(flux, fluxerr, mask, table, maskrow, n_real,
                              aux_names, parallax=None, parallax_err=None,
                              cfg: FitConfig = FitConfig(), tile=512,
                              screen_k=8192, screen_block=256, last=None,
                              model_group=None):
    """Batched funnel likelihood with the reference's semantics (mirrors
    `screen_xla.loglike_grid_screened_xla`).

    flux, fluxerr, mask : (B, F); table, maskrow : `from_numpy_grid`'s
    `(3F + n_aux, Mp)` table and `(Mp,)` mask row (this shard's slice
    on a `model_group`); `n_real` the grid's real models; parallax,
    parallax_err : (B,) or None; last : the `(3F,)` rows of model
    `n_real - 1` (read from `table` when None, which a shard cannot).

    Returns `optimize.loglike_grid`'s dict with `(B, P)` fields (no
    `n_iter`), `global_idx` the `(B, P)` int32 grid index of each
    shortlist model, and `aux` the gathered aux rows by name, `(B, P)`
    each.
    """
    B, F = flux.shape
    dev = table.device
    Mp = table.shape[1] * group_size(model_group)   # the whole grid's
    f32 = torch.float32
    flux = flux.to(dev, f32)
    fluxerr = fluxerr.to(dev, f32)
    mask = mask.to(dev)
    block = _slab_block(screen_block, tile)
    nb = max(1, min(screen_k // block, Mp // block))
    nan = torch.full((B,), math.nan, dtype=f32, device=dev)
    parallax = nan if parallax is None else parallax.to(dev, f32)
    parallax_err = nan if parallax_err is None else parallax_err.to(dev, f32)

    _, _, mags, wt_mag, _, _, _ = prepare_star_data(flux, fluxerr, mask, cfg)
    star2, srow5 = _screen_star_mats(mags, wt_mag,
                                     *_screen_parallax(parallax,
                                                       parallax_err))
    bscore = screen_blocks(table, maskrow, star2, srow5, F, block, cfg)
    _, idx, slab = select_and_gather(table, bscore, nb, block,
                                     model_group)        # (C, B, P)
    P = nb * block
    coeffs = slab[:3 * F].reshape(3, F, B, P).permute(2, 3, 1,
                                                      0).contiguous()
    if n_real < Mp:
        # The table's zero padding columns would make singular solves
        # whose NaNs end a star's convergence loops; the loops see the
        # JAX package's padding instead: the last model, 60 mag fainter
        # (`prepare_screen_xla`).
        if last is None:
            if group_size(model_group) > 1:
                raise ValueError("a model shard needs `last`")
            last = table[:3 * F, n_real - 1]
        faint = last.reshape(3, F).T.clone()
        faint[:, 0] += 60.0
        coeffs = torch.where((idx >= n_real)[..., None, None], faint,
                             coeffs)
    aux = {name: slab[3 * F + i] for i, name in enumerate(aux_names)}
    with highest_precision():
        res = _loglike_grid_body(flux, fluxerr, mask, coeffs, parallax,
                                 parallax_err, None, None, cfg)
    res.pop("n_iter")
    if n_real < Mp:
        bad = idx >= n_real
        res["lnlike"] = torch.where(bad, torch.full_like(res["lnlike"],
                                                         -1e30),
                                    res["lnlike"])
        res["chi2"] = torch.where(bad, torch.full_like(res["chi2"], 1e30),
                                  res["chi2"])
    res["global_idx"] = idx
    res["aux"] = aux
    return res


__all__ = ["loglike_grid_screened_xla"]
