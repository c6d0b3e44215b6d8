#!/usr/bin/env python3
"""Smoke run of `brutus_tpu_torch` on one NVIDIA H100.

    python3 chip_smoke.py               # the card run (needs one CUDA card)
    python3 chip_smoke.py --cpu --tiny  # rehearsal: phases 4-13 on the CPU
    python3 chip_smoke.py --profile     # where each fit path's time goes
    python3 chip_smoke.py --rates 2     # warm stars/s of the fused paths
    python3 chip_smoke.py --mesh        # phase 14's paths on four cards

Phases, each printing one line with its elapsed seconds:

1. the card's name and power limit (`nvidia-smi`);
2. build of the CUDA kernels (one nvcc call, `build/kernels/`), and the
   registers and local memory per thread of the instances of the main
   paths (K1 and K2 at F=8, K3, K4 in both modes with every prior on,
   the draws kernel without normals) and of K1's run-time-F instance;
3. each kernel, in each of its modes, against its plain PyTorch
   version on the card, at the widths of the main paths: K2 screen
   (750k models, 8 stars and the funnel's 128), K3 slab
   gather and K1 fit (128 stars, 12288-model shortlists), K1 in dense
   mode (16 stars x 750,080 models), K4 MC integration with fed normals
   and with its own random numbers (the funnel's 128 stars and 16, 2048
   selected models, the path's skip tiles of 512), with the deviation,
   the tolerance and the times of kernel, plain version, library call
   (where one exists) and bound (K1's counts the polish only for the
   pairs its freeze lets move, `moving_pairs`; K4's the draws of valid
   models, with its special functions on either pipe, `mc_bound`); and
   the posterior's draws kernel (`rng.draws`) at each fused path's
   batch (the funnel's 128 stars x 250 draws x 50 MC rows without
   normals and with K4's fed normals, the dense engine's 16 stars with
   (2048, 3, 50) grid normals), bit for bit, beside its bound and the
   time of its stores alone (`draws_bound`);
4. the main path: `BruteForce.fit` (funnel engine, K4 making its own
   normals, the default) on a 750,000-model, 8-band correlated grid,
   512 stars in 4 batches of 128, with parallax, Galactic and dust
   priors, checked for finite outputs, true-model recall and distance
   bias, timed as stars/s;
5. the funnel with fed normals (`PosteriorConfig.kernel_rng=False`),
   64 stars;
6. the dense path: `BruteForce.fit(screen_k=0)` on the same grid (K1
   in dense mode over all 750,080 padded models, then `lnpost_grid`),
   256 stars in batches of 16, timed as stars/s;
8. the reference-semantics funnel: `BruteForce.fit(engine="xla")`
   (K2, K3, then the convergence loops of `ops.optimize` on the
   shortlists and `lnpost_grid`), 128 stars in one batch, K2 and K3
   launched; the dense reference engine (`screen_k=0`) on the first 16
   in batches of 8; the funnel's likelihoods held against the
   reference engine in float64 on the host on each star's own
   shortlist, the dense engine against itself in float64 on the card
   (a TF32-rounded control must miss each limit), and the funnel
   compared (as a report) with the dense engine;
9. the rest of `BruteForce` on the funnel, phase 4's stars: a per-star
   `lnprior_ext` on feh with `scan_batches=2` and `return_sel=True`,
   held against the same fit batch by batch (identical rows) and
   against phase 4 (the drawn feh moves toward the truth), and the
   `_fit` generator's first batch of tuples against those rows
   (`resume` writes HDF5 and is tested on the CPU only);
10. the fallback past 2**24 models: a float32 grid of 2**24 + 4096
   models, 64 stars planted past 2**24, one funnel batch: odd drawn
   indices there (float32 holds only even ones) show the integer
   grid-index path, and every drawn model lies in its star's shortlist;
11. grid generation: `SEDmaker.make_grid` in float64 over the
   reference's 818,620 labels (the default mini, EEP and [Fe/H] grids,
   afe 0, single stars, the 6 x 7 (Av, Rv) lattice) on MIST-schema
   tracks and an 8-band network built in memory from a seed, timed in
   labels/s with its peak device memory; 4096 seeded labels regenerated
   on the host in float64 (the same validity and NaN pattern, values
   within `GRID_TOL`); then the funnel on the grid's valid models (512
   stars of phase 4's settings), K4's valid columns there, and, as a
   report, the reference-semantics funnel against the dense reference
   engine on that grid;
12. the cluster fit: an `Isochrone` built in memory (15 [Fe/H] nodes,
   log age 5.0-10.3, EEP 202-808), a 1050-star M67-like cluster, on
   two BC networks: `smooth_nn_arrays`, on which the likelihood
   resolves the cluster, and, as the control, phase 11's, on which it
   is a needle on an outlier plateau.  On each, the likelihood at 8
   seeded thetas against the host in float64 (`LOGLIKE_TOL`), through
   `isochrone_loglike` and through `fit_cluster`'s posterior in one
   batch; then `fit_cluster` at its widths (2000 EEPs, 15 smf values,
   32 walkers, 1000 steps, every cluster parameter free) within
   `HELD_BOUNDS`, whose midpoints lie off the truth, timed in
   walker-steps/s and checked by `recovery` (medians within
   `RECOVERY`, outlier fraction, the MAP against the truth, posterior
   widths): the fit on `smooth_nn_arrays` must pass, the control must
   fail;
13. the applications after a fit: 2048 lattice stars on one sightline
   (phase 4's coordinate, 0.2-5 kpc, two clouds at distance moduli 8.5
   and 11.0, band 2's flux divided by 1.05) fitted by the funnel
   (in-kernel draws, Galactic and parallax priors, no dust prior)
   inside `profiling.trace` and `annotate`, counted by
   `profiling.Throughput`, and fitted again without the injection as
   the control; the trace must hold the annotation and the four
   kernels.  `LOS_clouds_loglike_samples` at `LOS_THETAS` thetas
   against a float64 numpy evaluation (`LOS_TOL`; three kernels,
   template and additive modes; `LOS_F32_TOL` for `fit_clouds`'s
   float32 likelihood); `fit_clouds` with one and two clouds
   and the evidence ladder at its defaults, timed in walker-steps/s:
   the two-cloud evidence must beat the one-cloud one and the best MAP
   of the ladder's chain and `RESTARTS` more put a cloud at each step
   (`EVIDENCE_GAP`, `EVIDENCE_SIGMA`, `MAP_DM_TOL`), and the same fits
   with the distance draws shuffled across stars must not;
   `bin_pdfs_distred` at 750 x 300 bins from saved draws, as CDFs and
   from regenerated draws (Nr=100), timed in stars/s, 64 stars against
   numpy's `histogram2d` and scipy's `gaussian_filter` (`EDGE_REL`,
   `PDF_TOL`, mass, CDF monotonicity); `photometric_offsets` (Nmc=150)
   on both fits: band 2 must stand out (`OFFSET_MIN`) where the
   control's bands do not (`OFFSET_CONTROL`, `OFFSET_SIGMA`); its model
   fluxes and weights and the plotting helpers against numpy in
   float64 (`HOST_TOL`).  `--cpu --tiny` rehearses it with 256 stars,
   75 x 30 bins, 16 walkers, 200 steps, 6 rungs and one restart, the
   science checks reported, not held;
14. the device mesh, `BruteForce.fit(mesh=...)` on `torch.distributed`:
   the lattice written to `build/phase14/` for spawned ranks that load
   the kernels phase 2 built; (a) a world of one over NCCL on a 1 x 1
   mesh, phase 4's first batch of stars; (b)-(d) a world of two ranks
   on the one card over gloo (NCCL refuses two ranks on one device;
   gloo moves CUDA tensors through host memory, every kernel still
   runs on the card): (b) the funnel on 1 x 2 (the grid sharded over
   models, the block shortlists merged) on phase 4's stars, (c) the
   funnel and the dense engine on 2 x 1 (the stars split) on phase 4's
   and phase 6's first 64, (d) the reference-semantics funnel and dense
   engine on 1 x 2 on phase 8's, and `ops.optimize.loglike_grid` with
   `polish_k=2048` (`MESH_POLISH_K`) on 1 x 2 on phase 8's first 16
   stars with their parallaxes, the grid cut by `shard_grid`, with the
   init cull and without it (`MESH_POLISH_CULL`).  Each
   fit held against the single process's rows in `MESH_KEYS`: equal
   bit for bit, or within the JAX package's limits (`MESH_EVID_TOL`,
   `MESH_CHI2_TOL`, `MESH_AGREE`) with the reason printed; the
   `polish_k` call's rank rows against one process's call on the whole
   grid on the card, every field of `MESH_POLISH_KEYS` bit for bit
   (with its max |dev|, both calls' seconds and the iteration counts
   printed); every rank must launch its path's kernels
   (`MESH_KERNELS`), whose counts go to the `kernels` line as phase 14;
   stars/s per path, the slab all-reduce's time, the transport;
7. last, a `kernels` JSON line: each kernel's launches during the path
   that runs it (phase 4, 5 or 6; each must be > 0) and on every phase
   that launched it (K2, K3, K1 and K4 must have launched in phase 13's
   fit), and its phase-3 deviation and times; the
   registers and local bytes per thread of each (K4: of the main
   path's instance), for K1 the share of pairs moving in the polish,
   for K4 its time and bound at 16 stars.

Each fit phase prints its stars/s and median distance bias.  Any
failure exits non-zero.  The last line of a card run is the device
record `{"ok": true, "device": {...}}`.

`--profile` runs none of these phases.  On the card, at the same grid
and fit settings, it prints the host set-up each `fit` call repeats,
warm fits timed in turns (funnel / funnel with fed normals / funnel
with fed normals / funnel at 512 stars, dense twice at 256, the
reference-semantics funnel at 128 stars and its dense engine at 16,
twice each, then the funnel at 4096, then warm `make_grid` and
`fit_cluster` of phases 11-12 in turns, with the stage split of one
grid chunk and of a 10-step cluster fit), per path a `torch.profiler` trace
of one warm fit
(device time by kernel, busy time, idle share), and each hand-written
kernel's launches x (ms - bound) on the path that runs it (K1's bound
from the share of pairs moving on the path's first batch, K4's from its
valid and active columns per launch), the order
in which kernel redesigns would win the most time back; the last line
is one JSON object with these numbers.  `--rates N` times warm fits of
the funnel, the funnel with fed normals and the dense engine in turns,
N rounds forwards and backwards, and lists the host operations of one
funnel fit; a copy of the script in an older checkout times that
checkout the same way.  `--mesh` (four cards, never part of the
default run) runs phase 14's paths on 1 x 4, 2 x 2 and 4 x 1 meshes over
NCCL, and the funnel at 32768 stars on 4 x 1 and 1 x 4, each twice (cold,
warm) against its warm single-process run on card 0; `--mesh --cpu
--tiny` rehearses it with four gloo processes.  The script imports
nothing of JAX nor of the JAX package; its grid generator is its own
copy of the correlated lattice the repository's JAX benchmark uses.
"""

import argparse
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): the
# bound of a kernel is the larger of bytes / HBM rate and float32
# operations / float32 (non-tensor-core) rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def log(msg):
    print(msg, flush=True)


def correlated_grid(n_model, n_filt, seed=2):
    """Label-ordered correlated grid: a (mini, eep, feh) lattice with
    smooth coefficient surfaces, so neighbouring models are nearly
    degenerate and good fits cluster into contiguous bands (the structure
    the funnel's block selection faces on real MIST grids).  Returns the
    `(M, F, 3)` coefficients and the `(mini, feh, loga)` labels."""
    rng = np.random.default_rng(seed)
    n_feh, n_eep = 10, 320
    n_mini = -(-n_model // (n_feh * n_eep))
    mini = np.linspace(0.5, 2.0, n_mini)
    eep = np.linspace(202.0, 600.0, n_eep)
    feh = np.linspace(-1.0, 0.5, n_feh)
    mm, ee, ff = [a.ravel()[:n_model] for a in
                  np.meshgrid(mini, eep, feh, indexing="ij")]
    x = (ee - 202.0) / 398.0
    logt = 3.75 - 0.12 * (mm - 1.0) + 0.25 * np.sin(np.pi * x) - 0.04 * ff
    logl = 0.2 + 3.2 * np.log10(mm) + 1.8 * x ** 2
    lam = np.linspace(0.0, 1.0, n_filt)
    a1 = 2.0 - 3.5 * lam
    a2 = rng.uniform(-1.5, 1.5, n_filt)
    zp = rng.uniform(8.0, 10.0, n_filt)
    t = (logt - 3.75)[:, None]
    mags = zp[None] - 2.5 * logl[:, None] + a1[None] * t + a2[None] * t ** 2
    r0 = 1.15 * np.exp(-0.9 * lam)[None] * (1.0 + 0.08 * t)
    dr = 0.16 * r0 * (lam - 0.45)[None]
    mc = np.stack([mags, r0, dr], axis=-1).astype(np.float32)
    labels = np.zeros(n_model, [("mini", float), ("feh", float),
                                ("loga", float)])
    labels["mini"], labels["feh"], labels["loga"] = mm, ff, 8.0 + 2.0 * x
    return mc, labels


def stars(mc, n_star, seed=7, lo=0):
    """Observations of random grid models (of index `lo` or more) at
    0.3-3 kpc, with Av that follows the smoke dust map, 60-sigma
    photometry and 10% parallaxes."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(lo, mc.shape[0], n_star)
    dist = rng.uniform(0.3, 3.0, n_star)
    av = np.clip(0.15 * dist + rng.normal(size=n_star) * 0.1, 0.01, None)
    rv = rng.uniform(2.8, 3.8, n_star)
    sed = mc[idx, :, 0] + av[:, None] * (mc[idx, :, 1]
                                         + rv[:, None] * mc[idx, :, 2])
    flux = 10 ** (-0.4 * sed) / dist[:, None] ** 2
    err = flux / 60.0
    flux = flux + rng.normal(size=flux.shape) * err
    plx = 1.0 / dist + rng.normal(size=n_star) * 0.05 / dist
    return dict(flux=flux.astype(np.float32), err=err.astype(np.float32),
                idx=idx, dist=dist, plx=plx, plxe=0.1 / dist,
                coords=np.tile([204.7, -19.2], (n_star, 1)))


def smoke_dustmap():
    from brutus_tpu_torch.dustmap import DustMap

    class LadderMap(DustMap):
        """One 120-rung line-of-sight profile for every sightline."""

        def query(self, coord):
            n = np.size(coord[0])
            d = np.linspace(0.05, 10.0, 120)
            return (d, np.tile(np.linspace(0.0, 1.5, 120), (n, 1)),
                    np.full((n, 120), 0.2))

    return LadderMap()


def cuda_ms(fn, reps):
    """Mean time of `fn()` on the card over `reps` launches (after one
    warm-up), from CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, key, reps):
    """Mean device time per launch of the kernels whose name holds `key`
    over `reps` calls of `fn()` (after one warm-up), from
    `torch.profiler`: the kernel alone, without the host work of its
    wrapper that CUDA events around the call would also count once the
    kernel is shorter than that work."""
    fn()
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if key in e.key and _device_us(e) > 0]
    if not hits:
        raise AssertionError(f"the profiler saw no kernel named {key}")
    return sum(_device_us(e) for e in hits) / 1e3 / sum(e.count
                                                        for e in hits)


def _device_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


# A special function (exp, log, square root, division, sine, cosine)
# runs on the special-function units, or as ~24 float32 operations on
# the FMA pipes: a polynomial of ~10 FMAs and its range reduction, as
# libm evaluates log, sine and cosine.
SFU_AS_OPS = 24


def bound(nbytes, ops, sfu=0, sfu_per_s=1.0):
    """`(ms, "bytes" | "operations")`: the larger of the bytes over the
    HBM rate and the time of the float32 operations `ops` and special
    functions `sfu`, the two pipes working side by side: the operations
    at the float32 rate, the special functions at `sfu_per_s` or as
    `SFU_AS_OPS` operations each, so many of them moved to the FMA pipes
    that both finish together (the least time)."""
    b = nbytes / HBM_BYTES_PER_S
    t_ops, t_sfu = ops / F32_OPS_PER_S, sfu / sfu_per_s
    per_op, per_sfu = SFU_AS_OPS / F32_OPS_PER_S, 1.0 / sfu_per_s
    moved = min(max((t_sfu - t_ops) / (per_op + per_sfu), 0.0), sfu)
    o = max(t_ops + moved * per_op, t_sfu - moved * per_sfu)
    return 1e3 * max(b, o), ("bytes" if b >= o else "operations")


# Each kernel's bound, `(ms, "bytes" | "operations")`, from its shapes:
# every input read once and every output written once, and the float32
# operations the function needs for its inputs: per (star, model), plus
# once per model what does not depend on the star.
def screen_bound(B, Mp, F, block):
    """K2: per (star, model) 12 FMAs per filter (24 operations) and ~70
    of solve and score; per model the centered magnitude and its six
    star-independent products per filter (7F)."""
    return bound(4 * (3 * F * Mp + Mp + B * Mp // block + B * (2 * F + 5)),
                 B * Mp * (24 * F + 70) + Mp * 7 * F)


def gather_bound(C, B, P, nb):
    return bound(4 * (2 * C * B * P + B * nb), 0)


def fit_ops(F, mag_iters=6, flux_iters=6):
    """Float32 operations K1 needs (an exp, a division or a compare counts
    one), counted from the fit's steps, as `(per (star, model), per
    moving (star, model), per model)`.  Every pair: the direct seed (23
    per filter, 55 more), the magnitude-space solves (21 per filter and
    37 more each), the first flux-space expansion and its sums (34 per
    filter), each polish step's update (24), the final expansion with
    the precision parts (41 per filter, 7 more) and the epilogue (10).
    A pair the freeze lets move: each polish step's re-expansion and
    sums (34 per filter, 7 more).  Per model: exp(-0.4 ln10 mag) per
    filter."""
    pair = (F * (23 + 21 * mag_iters + 11 + 34 + 41)
            + 55 + 37 * mag_iters + 4 + 24 * flux_iters + 7 + 10)
    return pair, flux_iters * (34 * F + 7), 2 * F


def moving_pairs(chi2, tile, cfg):
    """(star, model) pairs whose flux-space polish moves them: lnlike
    after the first expansion at least the best of its `tile`-wide
    window + ln(init_thresh) (`pallas_loglike.py:248-252`).  `chi2`
    (B, P) is the plain version's, run with `no_polish(cfg)` and no
    padding mask.  Frozen pairs' polish steps leave them where they
    are, so that work is not counted in the bound."""
    lnl = -0.5 * chi2
    B, P = lnl.shape
    w = lnl.reshape(B, P // tile, tile)
    best = w.amax(-1, keepdim=True)
    return int((~(w < best + math.log(cfg.init_thresh))).sum().item())


def no_polish(cfg):
    return dataclasses.replace(cfg, kernel_flux_iters=0)


def fit_bound(B, P, C, F, n_rows, moving):
    """K1 stacked: every star fits its own P models; `moving` pairs take
    the polish's re-expansions."""
    pair, move, model = fit_ops(F)
    return bound(4 * (C * B * P + B * P + n_rows * B * P),
                 B * P * (pair + model) + moving * move)


def fit_dense_bound(B, Mp, F, moving):
    """K1 dense: every star fits the same Mp models."""
    pair, move, model = fit_ops(F)
    return bound(4 * (3 * F * Mp + 11 * B * Mp + B * (4 * F + 3)),
                 B * Mp * pair + moving * move + Mp * model)


# K4's counts per draw and per model, from the function's steps (an
# exp, a log, a square root or a division counts one special function;
# a division by a constant is a multiply).  A real draw of a valid
# model: the MVN transform (12 operations), parallax and distance (2
# special functions), the Galactic disks and halo with their
# logsumexp (~60 operations; 4 square roots, 4 exps, 3 logs, 1
# division), the feh and age mixtures (~24; 6 exps, 2 logs), the dust
# hat interpolation and pdf (~34; 1 division, 1 log), the parallax
# prior, bounds test and logsumexp step (~21; 1 exp).  A valid model's
# set-up: the inverse, one repair test and the Cholesky (~150; ~20
# special functions).  The random-number mode adds per draw Philox's
# ~100 integer operations (ten rounds of two 32-bit multiplies, two
# high multiplies, four xors, two key adds), counted twice because the
# card's int32 rate is half its float32 rate, and Box-Muller's ~23
# operations and 7 special functions (2 logs, 2 square roots, 2
# cosines, 1 sine).
MC_DRAW_OPS, MC_DRAW_SFU, MC_MODEL_OPS, MC_MODEL_SFU = 150, 25, 150, 20
PHILOX_OPS, BOX_MULLER_OPS, BOX_MULLER_SFU = 2 * 100, 23, 7
MC_RNG_OPS, MC_RNG_SFU = PHILOX_OPS + BOX_MULLER_OPS, BOX_MULLER_SFU
# The special-function units: 16 results per SM per clock (NVIDIA's
# CUDA C++ programming guide, throughput of arithmetic instructions,
# compute capability 9.0) on the H100 SXM's 132 SMs.
SFU_PER_SM_CLOCK, N_SM = 16, 132


def sm_clock_mhz():
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def mc_bound(B, K, nmc, n_valid, active, rng, clock_mhz):
    """K4's bound over B stars x K selected models, of which `n_valid`
    are valid and `active` columns lie in model tiles the skip leaves
    active: the largest of the bytes (valid plane, the 11 mapped table
    rows of active columns, per-star scalars and dust ladder, the fed
    normals of active columns or the seeds, and every output, constants
    of skipped columns included) over the HBM rate, and the time of the
    float32 operations of the real draws of valid models and their
    set-up with their special functions, at the special-function rate
    of `clock_mhz` or on the FMA pipes (`bound`)."""
    nmcp = -(-nmc // 8) * 8
    nbytes = 4 * (B * K + 11 * active + B * (10 + 2 * 128)
                  + 4 * B * nmcp * K + 8 * B * K)
    ops = n_valid * (nmc * MC_DRAW_OPS + MC_MODEL_OPS)
    sfu = n_valid * (nmc * MC_DRAW_SFU + MC_MODEL_SFU)
    if rng:
        nbytes += 8 * B
        ops += n_valid * nmc * MC_RNG_OPS
        sfu += n_valid * nmc * MC_RNG_SFU
    else:
        nbytes += 4 * 3 * nmcp * active
    return bound(nbytes, ops, sfu, SFU_PER_SM_CLOCK * N_SM * clock_mhz * 1e6)


def draws_bound(B, K, nmc, n_draws, z, clock_mhz):
    """`(ms, by, store_ms)` of the draws kernel (`rng.draws`) for B stars:
    the bound of `bound` and the stores' time alone.  Bytes: the rows
    read, the keys, `u`, the Gumbel noise and the normals of layout `z`
    (None, "mc" with its padding rows, "grid") written.  Operations: a
    Philox call per star key, uniform, Gumbel value and normal item;
    Box-Muller per normal item; two logs per Gumbel value."""
    nmcp = -(-nmc // 8) * 8
    n_z = {None: 0, "mc": 3 * nmcp * K, "grid": 3 * K * nmc}[z]
    items = 0 if z is None else K * nmc
    nbytes = B * (8 + 8 + 4 * (n_draws * (1 + nmc) + n_z))
    ops = B * (PHILOX_OPS * (1 + n_draws * (1 + nmc) + items)
               + BOX_MULLER_OPS * items)
    sfu = B * (2 * n_draws * nmc + BOX_MULLER_SFU * items)
    ms, by = bound(nbytes, ops, sfu, SFU_PER_SM_CLOCK * N_SM * clock_mhz * 1e6)
    return ms, by, 1e3 * nbytes / HBM_BYTES_PER_S


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# K1 limits (see `fit_deviation`), set from this script's readings on an
# H100 (PERF.md): all 0.00199, cap 0.082 (Rv, flat in the likelihood
# where Av ~ 0; every other field below 0.0061), frac 2.6e-5, crowd
# 0.002.  A fault at one window position gives crowd ~1.
K1_TOL = dict(all=0.005, cap=0.2, frac=1e-4, crowd=0.05)


def fit_deviation(k, q, gidx, n_real, tile):
    """How far K1's pack `k` is from its plain version `q`, on the
    fields of real models (rows lnlike .. ar).

    The fixed iteration budget branches on float comparisons (the
    tile-local freeze, step damping): where rounding in another order
    flips one, that model stops at another point of the same fit.  Such
    flips are rare, small and fall anywhere in the freeze window; a
    fault in the kernel's indexing is large, or falls on the same window
    positions in every window and star.  Returned: `near`, the max
    |dev| of lnlike within 20 nats of each star's best; `all`, its max
    relative to max(1, |lnlike|) over all models; `cap`, per field the
    max |dev| / (|plain| + the field's median |plain|); `frac`, the
    share of fields whose such deviation exceeds 1e-3; `crowd`, the
    largest share, over the positions of the `tile`-wide window, of the
    (star, window) pairs whose real model at that position has such a
    field (a fault at one position hits nearly all of them).
    """
    real = gidx < n_real
    # Equal values deviate by 0, infinities too (inf - inf is NaN).
    d = torch.where(k[:, :11] == q[:, :11], 0.0,
                    (k[:, :11] - q[:, :11]).abs())
    qa = q[:, :11].abs()
    lnl = q[:, 0]
    near = real & (lnl > lnl.amax(1, keepdim=True) - 20.0)
    med = qa.permute(1, 0, 2)[:, real].median(1).values
    rel = d / (qa + med[None, :, None] + 1e-30)
    relr = rel.permute(1, 0, 2)[:, real]
    B, P = real.shape
    off = ((rel > 1e-3).any(1) & real).reshape(B, P // tile, tile)
    n_pos = real.reshape(B, P // tile, tile).sum((0, 1)).clamp(min=1)
    return dict(
        near=d[:, 0][near].max().item(),
        all=(d[:, 0] / qa[:, 0].clamp(min=1.0))[real].max().item(),
        cap=relr.amax(1).tolist(),
        frac=relr.gt(1e-3).float().mean().item(),
        crowd=(off.sum((0, 1)) / n_pos).max().item())


def screen_deviation(k, q, wt_mag, mags):
    """How far K2's block maxima `k` are from its plain version `q`
    (B, nblk), against the per-star limit max(1, 2e-6 S).

    The score cancels weighted sums of squared magnitudes down to a chi2
    of order 10; float32 rounding in another order moves it by a few
    1e-7 of their size S = sum w (|m| + 4)^2 (bf16 products would move
    it by ~1e-3 of S).  Returned: `err` the max |dev| over real blocks,
    `rel` its max relative to max(1, |plain|), `tol` the largest
    per-star limit, `ok` whether every star is within its limit and the
    padding blocks are the same.
    """
    from brutus_tpu_torch.ops.funnel import SCREEN_MAG_CENTER
    real = q > -1e29
    d = (k - q).abs()
    S = (wt_mag * ((mags - SCREEN_MAG_CENTER).abs() + 4.0) ** 2).sum(1)
    tol = torch.clamp(2e-6 * S, min=1.0)
    dev_b = (d * real).amax(1)
    return dict(err=d[real].max().item(),
                rel=(d / q.abs().clamp(min=1.0))[real].max().item(),
                tol=tol.max().item(),
                ok=bool((dev_b <= tol).all())
                and bool(torch.equal(k > -1e29, real)))


def fit_ok(dev1):
    """Whether K1's deviation `fit_deviation` is within its limits: lnlike
    within 0.02 nats near the best, and `K1_TOL`."""
    return (dev1["near"] <= 0.02 and dev1["all"] <= K1_TOL["all"]
            and max(dev1["cap"]) <= K1_TOL["cap"]
            and dev1["frac"] <= K1_TOL["frac"]
            and dev1["crowd"] <= K1_TOL["crowd"])


def report_fit(what, dev1, ms, pms, bms, by, share, t0):
    """Print a K1 check against `K1_TOL` (lnlike within 0.02 nats near
    the best) and fail if it is off."""
    err, tol = dev1["near"], 0.02
    ok = fit_ok(dev1)
    log(f"{what}: max |dev| of lnlike within 20 nats of the best {err:.4g} "
        f"(tol {tol}), over all models {dev1['all']:.4g} relative (tol "
        f"{K1_TOL['all']}); per field max |dev| / (|plain| + median "
        f"|plain|) {', '.join(f'{c:.3g}' for c in dev1['cap'])} (tol "
        f"{K1_TOL['cap']}); fields off by >1e-3 of that {dev1['frac']:.3e} "
        f"(tol {K1_TOL['frac']}), models with one at the most crowded "
        f"window position {dev1['crowd']:.3g} (tol {K1_TOL['crowd']}); "
        f"kernel {ms:.3f} ms, plain {pms:.3f} ms, bound {bms:.4f} ms ({by}; "
        f"{share:.3f} of the pairs move in the polish)"
        f"  [{time.time() - t0:.1f} s]")
    if not ok:
        raise AssertionError(f"{what} disagrees with its plain version")


def phase_kernels(mc, labels, dev, results):
    """Phase 3: each kernel against its plain version on the card."""
    from brutus_tpu_torch.config import (FitConfig, PosteriorConfig,
                                         GalPriorConfig, DustPriorConfig)
    from brutus_tpu_torch.convert import from_numpy_grid
    from brutus_tpu_torch.dustmap import uniform_profile
    from brutus_tpu_torch.ops import fit as TFD, funnel as TF, mc as TMC
    from brutus_tpu_torch.ops import posterior as TP
    cfg = FitConfig()
    M, F, _ = mc.shape
    tabs = from_numpy_grid(mc, labels, device=dev)
    Mp, C = tabs.table.shape[1], tabs.table.shape[0]
    s = stars(mc, 128, seed=11)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    mask = torch.ones((128, F), dtype=torch.bool, device=dev)
    fp, wf, mg, wm, mk, ndim, tv = TF.prepare_star_data(
        t(s["flux"]), t(s["err"]), mask, cfg)
    plx, plxw = TF._screen_parallax(t(s["plx"]), t(s["plxe"]))
    star2, srow5 = TF._screen_star_mats(mg, wm, plx, plxw)
    block, nb = 256, 48

    # K2 at 8 stars (one partial star group of the kernel) and at the
    # funnel's batch of 128 (two full groups)
    t0 = time.time()
    a8 = (tabs.table, tabs.maskrow, star2[:8].contiguous(),
          srow5[:8].contiguous(), F, block, cfg)
    sd8 = screen_deviation(TF.screen_blocks(*a8), TF.screen_blocks_plain(*a8),
                           wm[:8], mg[:8])
    ms8 = cuda_ms(lambda: TF.screen_blocks(*a8), 20)
    bms8, _ = screen_bound(8, Mp, F, block)
    a128 = (tabs.table, tabs.maskrow, star2, srow5, F, block, cfg)
    sd = screen_deviation(TF.screen_blocks(*a128),
                          TF.screen_blocks_plain(*a128), wm, mg)
    ms = cuda_ms(lambda: TF.screen_blocks(*a128), 20)
    pms = cuda_ms(lambda: TF.screen_blocks_plain(*a128), 3)
    bms, by = screen_bound(128, Mp, F, block)
    err = max(sd8["err"], sd["err"])
    results["screen"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                             bound_ms=bms, bound_by=by, library_ms=None,
                             ms_8_stars=ms8, bound_8_stars_ms=bms8)
    log(f"phase 3 K2 screen ({M} models): max |dev| at 8 stars "
        f"{sd8['err']:.4g}, at 128 stars {sd['err']:.4g} (tol per star "
        f"max(1, 2e-6 S), at most {max(sd8['tol'], sd['tol']):.3g}), max "
        f"relative dev {max(sd8['rel'], sd['rel']):.3g}; kernel at 8 stars "
        f"{ms8:.3f} ms, bound {bms8:.4f} ms; at 128 stars: kernel {ms:.3f} "
        f"ms, plain {pms:.3f} ms, bound {bms:.4f} ms ({by})  "
        f"[{time.time() - t0:.1f} s]")
    if not (sd8["ok"] and sd["ok"]):
        raise AssertionError("K2 screen disagrees with its plain version")

    # K3 and K1 at 128 stars x 12288 shortlist models
    t0 = time.time()
    bscore = TF.screen_blocks(tabs.table, tabs.maskrow, star2, srow5, F,
                              block, cfg)
    bidx, idx = TF._select_blocks(bscore, nb, block)
    P = nb * block
    k = TF.gather_slabs(tabs.table, bidx, block)
    q = TF.gather_slabs_plain(tabs.table, bidx, block)
    err = (k - q).abs().max().item()
    ms = cuda_ms(lambda: TF.gather_slabs(tabs.table, bidx, block), 20)
    pms = cuda_ms(lambda: TF.gather_slabs_plain(tabs.table, bidx, block), 20)
    flat = (bidx.long()[:, :, None] * block + torch.arange(
        block, device=dev)).reshape(-1)
    lms = cuda_ms(lambda: tabs.table[:, flat], 20)
    bms, by = gather_bound(C, 128, P, nb)
    results["gather"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                             bound_ms=bms, bound_by=by, library_ms=lms)
    log(f"phase 3 K3 gather (128 stars x {P}): max |dev| {err:.4g} "
        f"(tol 0, exact), kernel {ms:.3f} ms, plain {pms:.3f} ms, "
        f"torch index copy {lms:.3f} ms, bound {bms:.4f} ms ({by})  "
        f"[{time.time() - t0:.1f} s]")
    if err != 0.0:
        raise AssertionError("K3 gather is not exact")

    t0 = time.time()
    star4 = torch.stack([fp, wf, mg, wm], 1).contiguous()
    args = (star4, k, idx.contiguous(), TF.post_consts(mk, ndim, tv), 3, 15,
            tabs.n_real, 512, cfg)
    pack = TF.fit_pack(*args)
    q = TF.fit_pack_plain(*args)
    dev1 = fit_deviation(pack, q, idx, tabs.n_real, 512)
    del q
    ms = cuda_ms(lambda: TF.fit_pack(*args), 10)
    pms = cuda_ms(lambda: TF.fit_pack_plain(*args), 3)
    moving = moving_pairs(TF.fit_pack_plain(
        *args[:6], -1, 512, no_polish(cfg))[:, 1], 512, cfg)
    bms, by = fit_bound(128, P, C, F, 15, moving)
    results["fit"] = dict(max_abs_err=dev1["near"], ms=ms, plain_ms=pms,
                          bound_ms=bms, bound_by=by, library_ms=None,
                          moving_share=moving / (128 * P))
    report_fit(f"phase 3 K1 fit (128 stars x {P})", dev1, ms, pms, bms, by,
               moving / (128 * P), t0)

    # K1 in dense mode at 16 stars x every model of the grid
    t0 = time.time()
    coeffs, n_real = TFD.prepare_coeffs(mc, tile=512, device=dev)
    Mpd = coeffs.shape[2]
    b16 = slice(0, 16)
    dargs = (star4[b16].contiguous(), coeffs,
             TF.post_consts(mk[b16], ndim[b16], tv[b16]), n_real, 512, cfg)
    k = TFD.fit_dense(*dargs)
    q = TFD.fit_dense_plain(*dargs)
    dev1 = fit_deviation(k.transpose(0, 1), q.transpose(0, 1),
                         torch.arange(Mpd, device=dev).expand(16, Mpd),
                         n_real, 512)
    del k, q
    ms = cuda_ms(lambda: TFD.fit_dense(*dargs), 10)
    pms = cuda_ms(lambda: TFD.fit_dense_plain(*dargs), 2)
    moving = moving_pairs(TFD.fit_dense_plain(
        *dargs[:3], -1, 512, no_polish(cfg))[1], 512, cfg)
    bms, by = fit_dense_bound(16, Mpd, F, moving)
    results["fit_dense"] = dict(max_abs_err=dev1["near"], ms=ms,
                                plain_ms=pms, bound_ms=bms, bound_by=by,
                                library_ms=None,
                                moving_share=moving / (16 * Mpd))
    report_fit(f"phase 3 K1 dense (16 stars x {Mpd} models)", dev1, ms, pms,
               bms, by, moving / (16 * Mpd), t0)

    # K4 on the select stage of the 128 stars (the funnel path's shape,
    # 2048 selected models) and of its first 16, in both modes
    pcfg = PosteriorConfig()
    names = TF.pack_row_names(tabs.aux_names)
    dd, dm, ds = smoke_dustmap().query((s["coords"][:, 0],
                                        s["coords"][:, 1]))
    prof = tuple(t(x) for x in uniform_profile(dd, dm, ds, n=TMC.NL_PAD))
    coord, plx, plxe = t(s["coords"]), t(s["plx"]), t(s["plxe"])
    sel = TP._select_stage(pack, names, ndim, coord, plx, plxe, prof, pcfg,
                           GalPriorConfig(), DustPriorConfig(), True)
    scal, dust = TP._star_scalars(coord, plx, plxe, prof, True)
    clock = sm_clock_mhz()
    at16 = {}
    for nb in (16, 128):
        for name, r in phase_mc(sel, names, scal, dust, pcfg, nb, clock,
                                dev).items():
            if nb == 16:
                at16[name] = dict(ms_16_stars=r["ms"],
                                  bound_16_stars_ms=r["bound_ms"])
            else:
                results[name] = dict(r, **at16[name])
    results["draws"] = phase_draws(pcfg, clock, dev)


# The draws kernel on each fused path: `(name, B, K, normals layout)`.
DRAW_PATHS = (("funnel", 128, 2048, None), ("funnel_fed", 128, 2048, "mc"),
              ("dense", 16, 2048, "grid"))


def phase_draws(pcfg, clock, dev):
    """The draws kernel against its plain version (`rng.star_keys` then
    `rng.posterior_draws`) at each fused path's batch, bit for bit, with
    rows past 2**32 and a seed with the high bit set; each path's device
    time per launch, the plain version's time and the bound; returns the
    `kernels` entry (the funnel's numbers, the others by path)."""
    from brutus_tpu_torch.ops import mc as TMC, rng
    nmc, nd = pcfg.n_mc_prior, pcfg.n_draws
    nmcp = TMC.nmc_pad_of(nmc)
    seed = 2 ** 63 + 2 ** 40 + 17
    out = {}
    for path, B, K, z in DRAW_PATHS:
        t0 = time.time()
        rows = torch.arange(2 ** 32 - 5, 2 ** 32 - 5 + B, device=dev)
        run = lambda: rng.draws(seed, rows, K, nmc, nd, z=z, nmc_pad=nmcp)

        def plain():
            keys = rng.star_keys(seed, rows)
            return (keys, *rng.posterior_draws(keys, K, nmc, nd, z=z,
                                               nmc_pad=nmcp))
        diff = sum(int((a != b).sum()) for a, b in zip(run(), plain())
                   if a is not None)
        ms = device_ms(run, "mc_kernel_draws", 20)
        call_ms = cuda_ms(run, 20)
        pms = cuda_ms(plain, 3)
        bms, by, sms = draws_bound(B, K, nmc, nd, z, clock)
        out[path] = dict(ms=ms, call_ms=call_ms, plain_ms=pms, bound_ms=bms,
                         bound_by=by, store_ms=sms, differing=diff)
        log(f"phase 3 draws, {path} ({B} stars, {nd} draws x {nmc} MC "
            f"rows, normals {z or 'none'}"
            + (f" over {K} models" if z else "") + f"): outputs differing "
            f"from the plain version {diff} (tol 0, bit for bit); kernel "
            f"{ms:.4f} ms (device), {call_ms:.4f} ms per call, plain "
            f"{pms:.3f} ms, bound {bms:.4f} ms ({by}; the stores alone "
            f"{sms:.4f} ms)  [{time.time() - t0:.1f} s]")
        if diff:
            raise AssertionError(f"the draws kernel differs from its plain "
                                 f"version on the {path} path")
    f = out["funnel"]
    return dict(max_abs_err=0.0, ms=f["ms"], plain_ms=f["plain_ms"],
                bound_ms=f["bound_ms"], bound_by=f["bound_by"],
                library_ms=None, paths=out)


def phase_mc(sel, names, scal, dust, pcfg, nb, clock, dev):
    """K4 in both modes against its plain version on the first `nb` stars
    of a select stage `sel`, at the funnel path's skip tile; returns each
    mode's `kernels` entry."""
    from brutus_tpu_torch.config import GalPriorConfig, DustPriorConfig
    from brutus_tpu_torch.ops import mc as TMC, posterior as TP, rng
    from brutus_tpu_torch.utils import inverse3_sym_parts, is_psd3_parts
    b = slice(0, nb)
    tab = sel["table"][b].contiguous()
    valid = sel["valid"][b].to(torch.float32)
    K = tab.shape[2]
    nmc, nmcp = pcfg.n_mc_prior, TMC.nmc_pad_of(pcfg.n_mc_prior)
    # The fit's draws of rows 0..nb-1 with seed 1: the fed normals are the
    # ones the random-number mode makes from the same star keys.
    rows = torch.arange(nb, device=dev)
    z = TP.draw_noise(1, rows, K, dataclasses.replace(
        pcfg, kernel_rng=False), dev).z
    seeds = TP.draw_noise(1, rows, K, pcfg, dev).seeds
    rm = TP._pack_row_map(names)
    cf = (pcfg, GalPriorConfig(), DustPriorConfig(), True, True, True)
    base = (tab, rm, valid, scal[b].contiguous(), dust[b].contiguous())
    tile = 512                  # the skip tile the funnel path passes
    flags = TMC.tile_flags(valid > 0.5, tile)
    active = int(flags.sum().item()) * tile
    n_valid = int((valid > 0.5).sum().item())
    # Compared on valid models whose precision is positive definite: the
    # fixed-pass PSD repair of indefinite ones is chaotic in float32.
    pd = is_psd3_parts(inverse3_sym_parts(tuple(
        tab[:, rm[3 + j]] for j in range(6))))
    v = (valid > 0.5) & pd
    modes = (("mc_fed", "fed normals", z, None, lambda: z),
             ("mc_rng", "in-kernel Philox normals", None, seeds,
              lambda: rng.normals(seeds, K, nmc, nmcp)))
    out = {}
    for name, what, zk, sk, plain_z in modes:
        t0 = time.time()
        run = lambda: TMC.mc_integrate(*base, zk, nmc, tile, *cf, seeds=sk)
        plain = lambda: TMC.mc_integrate_plain(*base, plain_z(), flags, nmc,
                                               tile, *cf)
        kk, qq = run(), plain()
        dl = (kk[4][:, 0] - qq[4][:, 0]).abs()[v]
        err = dl.max().item()
        # The log-integral per model within 1e-3 relative (absolute
        # below 1); every output within rtol = atol = 1e-3; the same
        # outputs finite.
        rel_l = (dl / qq[4][:, 0][v].abs().clamp(min=1.0)).max().item()
        n_far = sum(int((~torch.isclose(a, q, rtol=1e-3, atol=1e-3))[
            v[:, None, :].expand_as(a)].sum()) for a, q in zip(kk, qq))
        finite = all(torch.equal(torch.isfinite(a), torch.isfinite(q))
                     for a, q in zip(kk, qq))
        fields = {f: (a - q).abs()[v[:, None, :].expand_as(a)].max().item()
                  for f, a, q in zip(("dist", "red", "dred"), kk[1:4],
                                     qq[1:4])}
        del kk, qq
        ms = device_ms(run, "mc_kernel", 20)
        call_ms = cuda_ms(run, 20)
        pms = cuda_ms(plain, 3)
        bms, by = mc_bound(nb, K, nmc, n_valid, active, sk is not None,
                           clock)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                         bound_by=by, library_ms=None)
        log(f"phase 3 K4 mc, {what} ({nb} stars x {K}, {int(v.sum())} valid "
            f"positive-definite models, {active} active columns at tiles of "
            f"{tile}): max |dev| of the MC log-integral {err:.4g}, relative "
            f"to max(1, |plain|) {rel_l:.3g} (tol 1e-3), outputs outside "
            f"rtol = atol = 1e-3 {n_far} (tol 0), finiteness equal "
            f"{finite}; max |dev| of dist {fields['dist']:.4g}, red "
            f"{fields['red']:.4g}, dred {fields['dred']:.4g}; kernel "
            f"{ms:.4f} ms (device), {call_ms:.4f} ms per call, plain "
            f"{pms:.3f} ms, bound {bms:.4f} ms ({by})  "
            f"[{time.time() - t0:.1f} s]")
        if not (rel_l <= 1e-3 and n_far == 0 and finite):
            raise AssertionError(f"K4 MC ({what}) disagrees with its plain "
                                 f"version at {nb} stars")
    return out


def fit_kwargs(s, batch, screen_k, n_sel_max, **extra):
    """The `BruteForce.fit` keywords of every smoke fit of the stars `s`
    (`extra` adds or replaces some)."""
    return dict(dict(parallax=s["plx"], parallax_err=s["plxe"],
                     data_coords=s["coords"], dustmap=smoke_dustmap(),
                     batch_size=batch, screen_k=screen_k, screen_block=256,
                     n_sel_max=n_sel_max, Nmc_prior=50, Ndraws=250,
                     tile=512, save_file=None, verbose=False), **extra)


def fit_stars(bf, s, dev, batch, screen_k, n_sel_max, kernel_rng=True,
              **extra):
    """One `BruteForce.fit` of the stars `s`: the funnel (`screen_k`
    below the grid size) or the dense engine (`screen_k=0`), of the
    fused engine or, with `engine="xla"` in `extra`, of the
    reference-semantics one.  `kernel_rng=False` switches the funnel's
    MC kernel to fed normals through `PosteriorConfig`, as the JAX
    package's drive recipe switches its own flags.  Returns the
    results, the seconds to the final synchronise, and the launch
    counts of this fit alone."""
    import functools
    from brutus_tpu_torch import fitting
    from brutus_tpu_torch.ops import _native
    kw = fit_kwargs(s, batch, screen_k, n_sel_max, return_results=True,
                    **extra)
    post_cfg = fitting.PosteriorConfig
    fitting.PosteriorConfig = functools.partial(post_cfg,
                                                kernel_rng=kernel_rng)
    try:
        _native.reset_launches()
        t0 = time.time()
        out = bf.fit(s["flux"], s["err"], np.ones(s["flux"].shape, bool),
                     **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.time() - t0
        launches = {k: v.launches for k, v in _native.KERNELS.items()}
    finally:
        fitting.PosteriorConfig = post_cfg
    return out, dt, launches


def phase_fit(mc, labels, dev, n_star, batch, screen_k, n_sel_max,
              kernel_rng=True, s=None, bf=None, max_bias=0.25, **extra):
    """A cold `fit_stars` of `n_star` stars (`stars(mc, n_star)` unless
    `s` is given), checked: finite outputs of the expected shapes and a
    median distance bias below `max_bias` (None: reported only).  The
    results are returned under `out`."""
    from brutus_tpu_torch import BruteForce
    s = stars(mc, n_star) if s is None else s
    bf = BruteForce(mc, labels, device=dev) if bf is None else bf
    out, dt, launches = fit_stars(bf, s, dev, batch, screen_k, n_sel_max,
                                  kernel_rng, **extra)
    for key, v in out.items():
        if v.dtype.kind == "f" and not np.isfinite(v).all():
            raise AssertionError(f"non-finite values in {key}")
    n = len(s["idx"])
    if out["dist"].shape != (n, 250) or out["model_idx"].shape != (n, 250):
        raise AssertionError("unexpected output shapes")
    recall = float(np.mean((out["model_idx"] == s["idx"][:, None]).any(1)))
    d_med = np.median(out["dist"], axis=1)
    bias = float(np.median(d_med / s["dist"] - 1.0))
    p90 = float(np.quantile(np.abs(d_med / s["dist"] - 1.0), 0.9))
    if max_bias is not None and not abs(bias) < max_bias:
        raise AssertionError(f"posterior distances are off: median "
                             f"bias {bias:+.3f}")
    return dict(seconds=dt, stars_per_s=n / dt, recall=recall,
                dist_bias=bias, dist_p90=p90, launches=launches,
                finite_evidence=float(np.isfinite(out["log_evidence"]).mean()),
                out=out)


def _tensors(s, dev, sl=slice(None)):
    """The stars `s[sl]` as the fit uploads them: float32 flux, errors,
    parallaxes, and an all-true mask."""
    t = lambda x: torch.as_tensor(np.asarray(x)[sl], dtype=torch.float32,
                                  device=dev)
    flux = t(s["flux"])
    return (flux, t(s["err"]), torch.ones(flux.shape, dtype=torch.bool,
                                          device=dev), t(s["plx"]),
            t(s["plxe"]))


# The reference-semantics funnel on the card held against the reference
# engine in float64 on the host, on each star's own shortlist, and the
# dense reference engine against itself in float64: at most a share
# `XLA_SHARE_TOL` of the real models may have a field past `XLA_TOL`
# (rtol, atol; the limits of `tests/test_screen_xla.py::
# test_screened_xla_matches_dense`).  In float32 the convergence loops
# stop at other iterations than in float64 on a few of the lattice's
# models (nats apart at a star's best, so that distance is reported,
# not held); the share sits between the card's sound readings and
# those of a lower-precision control, the same engines in float32 on
# coefficients rounded to TF32's 10-bit mantissa, which must miss it
# (readings in PERF.md).
XLA_TOL = dict(lnlike=(1e-4, 0.1), chi2=(2e-3, 2e-3), scale=(2e-3, 2e-3),
               av=(2e-3, 2e-3), rv=(2e-3, 2e-3))
XLA_SHARE_TOL = 0.05


def _round_tf32(x):
    """float32 values rounded to the nearest of TF32's 10-bit mantissa."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _field_deviation(fun, ref, real, acc):
    """Fold into `acc` each field's largest |dev| over its `XLA_TOL`
    limit and the count of values past it, and the largest |dev| of the
    lnlike relative to the star's best over the models within 10 nats of
    it (`near`), and the count of models with a field past its limit, on
    the real models `real`; `ref` decides the scale."""
    ref = {k: ref[k].to(fun[k]) for k in XLA_TOL}
    off = torch.zeros_like(real)
    for k, (rtol, atol) in XLA_TOL.items():
        ratio = (fun[k] - ref[k]).abs() / (atol + rtol * ref[k].abs())
        off |= ratio > 1
        ratio = ratio[real]
        acc["worst"][k] = max(acc["worst"][k], ratio.max().item())
        acc["n_off"][k] += int((ratio > 1).sum().item())
    acc["models_off"] += int((off & real).sum().item())
    acc["models"] += int(real.sum().item())
    ninf = lambda x: torch.where(real, x, torch.full_like(x, -math.inf))
    lf, lr = ninf(fun["lnlike"]), ninf(ref["lnlike"])
    top_f, top_r = lf.amax(1, keepdim=True), lr.amax(1, keepdim=True)
    near = lr > top_r - 10.0
    d = ((lf - top_f) - (lr - top_r)).abs()[near]
    acc["near"] = max(acc["near"], d.max().item())


def _deviation_acc():
    return dict(worst=dict.fromkeys(XLA_TOL, 0.0),
                n_off=dict.fromkeys(XLA_TOL, 0), near=0.0, models_off=0,
                models=0)


def _share_off(acc):
    return acc["models_off"] / max(acc["models"], 1)


def _acc_text(acc):
    worst = {k: round(v, 4) for k, v in acc["worst"].items()}
    return (f"worst {worst}, past the limit {acc['n_off']}, share of "
            f"models with a field past it {_share_off(acc):.4g}, near the "
            f"best {acc['near']:.4g} nats")


def _within(acc):
    return _share_off(acc) <= XLA_SHARE_TOL


def xla_deviation(mc, labels, s, dev, n_check, batch, screen_k):
    """The reference-semantics funnel (`loglike_grid_screened_xla`) on the
    first `n_check` stars of `s`, in batches of `batch`.

    `f64`, held (`XLA_SHARE_TOL`): against the reference engine
    (`optimize.loglike_grid`) in float64 on the host, on each star's
    shortlist taken from the host grid at the funnel's `global_idx`
    (padding as the funnel pads), from the same float32 star data.
    `control`, which must miss those limits: the same engine on the
    device in float32 on those shortlists rounded to TF32
    (`_round_tf32`), against the same reference.  `dense64`, held at
    the same limits: the dense reference engine (float32, the grid's
    dtype) against itself in float64 on the device over the whole grid;
    `dense_control`, which must miss them: the float32 dense engine on
    the TF32-rounded grid.

    `dense`, reported: against the dense reference engine over the
    whole grid on the device, every shortlisted model's fields, and
    each star's best shortlisted lnlike against the dense maximum
    (`best_gap` over the stars whose dense maximum is shortlisted,
    `best_gap_all` over every star).  On this
    near-degenerate lattice the reference engine's convergence tests
    range over thousands of good models that a shortlist lacks, so the
    funnel stops at other iterations than the dense engine and misses
    the random-grid limits there, more than a nat at a star's best,
    as the JAX package's own funnel does (`tests/
    test_torch_screen_xla.py::test_lattice_funnel_matches_the_jax_funnel`).
    """
    from brutus_tpu_torch.config import FitConfig
    from brutus_tpu_torch.convert import from_numpy_grid
    from brutus_tpu_torch.ops.optimize import loglike_grid
    from brutus_tpu_torch.ops.screen_xla import loglike_grid_screened_xla
    cfg = FitConfig(mag_direct_init=True)        # as `fit` sets it
    tabs = from_numpy_grid(mc, labels, device=dev)
    coeffs = torch.as_tensor(mc, device=dev)
    host = torch.as_tensor(mc, dtype=torch.float64)
    M = mc.shape[0]
    faint = host[M - 1].clone()
    faint[:, 0] += 60.0
    coeffs64 = coeffs.double()
    f64, control, dense64, dense_control, dense = (
        _deviation_acc() for _ in range(5))
    gaps, gaps_all, on_list = [], [], 0
    t_ref = 0.0
    for lo in range(0, n_check, batch):
        sl = slice(lo, min(lo + batch, n_check))
        flux, err, mask, plx, plxe = _tensors(s, dev, sl)
        fun = loglike_grid_screened_xla(
            flux, err, mask, tabs.table, tabs.maskrow, tabs.n_real,
            tabs.aux_names, parallax=plx, parallax_err=plxe, cfg=cfg,
            tile=512, screen_k=screen_k, screen_block=256)
        g = fun["global_idx"].long()
        real = g < M
        gc = g.clamp(max=M - 1)
        short = torch.where(real.cpu()[..., None, None], host[gc.cpu()],
                            faint)
        h = lambda x: x.cpu().double()
        t0 = time.time()
        ref = loglike_grid(h(flux), h(err), mask.cpu(), short,
                           parallax=h(plx), parallax_err=h(plxe), cfg=cfg)
        t_ref += time.time() - t0
        fun_h = {k: h(fun[k]) for k in XLA_TOL}
        _field_deviation(fun_h, ref, real.cpu(), f64)
        low = loglike_grid(flux, err, mask, _round_tf32(
            short.to(dev, torch.float32)), parallax=plx, parallax_err=plxe,
            cfg=cfg)
        _field_deviation({k: h(low[k]) for k in XLA_TOL}, ref, real.cpu(),
                         control)
        full = loglike_grid(flux, err, mask, coeffs, parallax=plx,
                            parallax_err=plxe, cfg=cfg)
        d = lambda x: x.double()
        full64 = loglike_grid(d(flux), d(err), mask, coeffs64,
                              parallax=d(plx), parallax_err=d(plxe),
                              cfg=cfg)
        every = torch.ones_like(full["lnlike"], dtype=torch.bool)
        _field_deviation(full, full64, every, dense64)
        low = loglike_grid(flux, err, mask, _round_tf32(coeffs),
                           parallax=plx, parallax_err=plxe, cfg=cfg)
        _field_deviation(low, full64, every, dense_control)
        del full64, low
        _field_deviation(fun, {k: torch.gather(full[k], 1, gc)
                               for k in XLA_TOL}, real, dense)
        best_f = torch.where(real, fun["lnlike"],
                             torch.full_like(fun["lnlike"], -math.inf))
        gap = (full["lnlike"].amax(1) - best_f.amax(1)).abs()
        hit = (g == full["lnlike"].argmax(1, keepdim=True)).any(1)
        gaps += gap[hit].tolist()
        gaps_all += gap.tolist()
        on_list += int(hit.sum().item())
        del fun, full
    ok = (_within(f64) and not _within(control) and _within(dense64)
          and not _within(dense_control))
    return dict(f64=f64, control=control, dense64=dense64,
                dense_control=dense_control, dense=dense,
                best_gap=max(gaps, default=math.nan),
                best_gap_all=max(gaps_all), on_list=on_list,
                ref_seconds=t_ref, ok=ok)


def phase_xla(mc, labels, dev, n_star, batch, screen_k, n_check,
              batch_check):
    """Phase 8: `BruteForce.fit(engine="xla")`, the reference-semantics
    funnel (K2, K3, then the convergence loops of `ops.optimize` on the
    shortlists and `lnpost_grid`), `n_star` stars in batches of
    `batch`; the dense reference engine (`screen_k=0`) on the first
    `n_check` stars; and the funnel's likelihoods held against the
    float64 reference engine (`xla_deviation`)."""
    from brutus_tpu_torch import BruteForce
    s = stars(mc, n_star, seed=9)
    bf = BruteForce(mc, labels, device=dev)
    fun = phase_fit(mc, labels, dev, n_star, batch, screen_k, 2048, s=s,
                    bf=bf, engine="xla")
    if dev.type == "cuda" and not (fun["launches"]["screen"]
                                   and fun["launches"]["gather"]):
        raise AssertionError("the reference-semantics funnel launched no "
                             "K2 or K3")
    sub = {k: (v[:n_check] if np.ndim(v) else v) for k, v in s.items()}
    dense = phase_fit(mc, labels, dev, n_check, batch_check, 0, 2048,
                      s=sub, bf=bf, engine="xla")
    return dict(funnel=fun, dense_fit=dense, **xla_deviation(
        mc, labels, s, dev, n_check, batch_check, screen_k))


def feh_offset(labels, out, s):
    """The median over all draws of |feh(drawn model) - feh(true model)|."""
    feh = np.asarray(labels["feh"])
    return float(np.median(np.abs(feh[out["model_idx"]]
                                  - feh[s["idx"]][:, None])))


def phase_rest(mc, labels, dev, s, batch, screen_k, n_sel, base):
    """Phase 9: the rest of `BruteForce` on the fused funnel for the stars
    `s` (phase 4's): a per-star Gaussian `lnprior_ext` on feh (std 0.1
    around each star's true model) with `scan_batches=2` and
    `return_sel=True`, against the same fit with `scan_batches=1`
    (identical rows: model indices equal, log-evidence and distances
    within rtol 1e-5) and against phase 4's fit without the prior
    (`base`: the drawn feh must move closer to the truth); then `_fit`'s
    first `batch` tuples against that fit's rows."""
    from brutus_tpu_torch import BruteForce
    bf = BruteForce(mc, labels, device=dev)
    n = len(s["idx"])
    ext = {"feh": np.stack([np.asarray(labels["feh"])[s["idx"]],
                            np.full(n, 0.1)], 1)}
    kw = dict(lnprior_ext=ext, return_sel=True)
    scan = phase_fit(mc, labels, dev, n, batch, screen_k, n_sel, s=s, bf=bf,
                     scan_batches=2, **kw)
    one = phase_fit(mc, labels, dev, n, batch, screen_k, n_sel, s=s, bf=bf,
                    **kw)
    a, b = scan["out"], one["out"]
    same = bool(np.array_equal(a["model_idx"], b["model_idx"])) and all(
        np.allclose(a[k], b[k], rtol=1e-5, atol=0) for k in
        ("log_evidence", "dist"))
    sel_ok = all(np.isin(a["model_idx"][i], a["sel_idx"][i]).all()
                 for i in range(n))
    gen = bf._fit(s["flux"], s["err"], np.ones(s["flux"].shape, bool),
                  **fit_kwargs(s, batch, screen_k, n_sel, lnprior_ext=ext))
    tup = [next(gen) for _ in range(batch)]
    gen.close()
    gen_ok = all(np.array_equal(t[0], b["model_idx"][i])
                 and np.allclose(t[9], b["dist"][i], rtol=1e-5)
                 for i, t in enumerate(tup))
    return dict(scan=scan, one=one, same=same, sel_ok=sel_ok, gen_ok=gen_ok,
                feh_ext=feh_offset(labels, a, s),
                feh_base=feh_offset(labels, base, s),
                ok=same and sel_ok and gen_ok)


def phase_fallback(dev, tiny, screen_k, n_sel):
    """Phase 10: a grid of 2**24 + 4096 models (float32 throughout,
    `BruteForce(dtype=np.float32)`), 64 stars planted at models of index
    2**24 or more, one batch of the fused funnel.  Past 2**24 float32
    holds only even integers, so odd drawn indices there show that the
    selected models' indices came from the funnel's integer map; each
    star's drawn models must lie in its shortlist (`global_idx` of the
    same screen).  `--tiny` runs the same path on a 4096-model grid
    with the stars planted past 2048."""
    from brutus_tpu_torch import BruteForce
    from brutus_tpu_torch.config import FitConfig
    from brutus_tpu_torch.convert import from_numpy_grid
    from brutus_tpu_torch.ops.funnel import loglike_grid_screened
    limit = 2048 if tiny else 2 ** 24
    M = 2 * limit if tiny else limit + 4096
    n = 8 if tiny else 64
    t0 = time.time()
    mc, labels = correlated_grid(M, 8)
    grid_s = time.time() - t0
    s = stars(mc, n, seed=13, lo=limit)
    bf = BruteForce(mc, labels, dtype=np.float32, device=dev)
    r = phase_fit(mc, labels, dev, n, n, screen_k, n_sel, s=s, bf=bf,
                  return_sel=True)
    midx = r["out"]["model_idx"]
    above = (midx >= limit) & (midx < 2 * limit)
    odd = int((above & (midx % 2 == 1)).sum())
    tabs = from_numpy_grid(mc, labels, device=dev)
    flux, err, mask, plx, plxe = _tensors(s, dev)
    short = loglike_grid_screened(
        flux, err, mask, tabs.table, tabs.maskrow, tabs.n_real,
        tabs.aux_names, parallax=plx, parallax_err=plxe, cfg=FitConfig(),
        tile=512, screen_k=screen_k,
        screen_block=256)["global_idx"].cpu().numpy()
    in_short = all(np.isin(midx[i], short[i]).all() for i in range(n))
    return dict(r, M=M, limit=limit, grid_s=grid_s, above=int(above.sum()),
                odd=odd, in_short=in_short, ok=odd > 0 and in_short)


# Phases 11-12: grid generation and the cluster fit, on tables of the MIST
# schema built in memory from a seed (the card machine has no h5py, and
# the repository has no MIST or C3K files).

GRID_FILTERS = ["PS_g", "PS_r", "PS_i", "PS_z", "PS_y", "2MASS_J",
                "2MASS_H", "2MASS_Ks"]
# The [Fe/H] nodes of the MIST v1.2 track and isochrone libraries.
MIST_FEH = np.array([-4.0, -3.5, -3.0, -2.5, -2.0, -1.75, -1.5, -1.25,
                     -1.0, -0.75, -0.5, -0.25, 0.0, 0.25, 0.5])


def analytic_physics(mini, eep, feh, afe):
    """Smooth synthetic stellar physics, monotone age along EEP (a copy
    of `examples/_synth.py::analytic_physics`)."""
    eep = np.asarray(eep, dtype=float)
    loga = 9.0 + 0.004 * (eep - 350.0) - 1.2 * np.log10(mini)
    logt = 3.75 - 0.2 * (eep - 350.0) / 600.0 + 0.03 * feh \
        + 0.1 * np.log10(mini)
    logl = 3.5 * np.log10(mini) + 0.0015 * (eep - 202.0)
    logg = 4.4 - 0.0012 * (eep - 202.0) - 0.05 * np.log10(mini)
    return {"log_age": loga, "log_Teff": logt, "log_L": logl,
            "log_g": logg, "[Fe/H]": feh - 0.05 + 0 * eep,
            "[a/Fe]": afe + 0 * eep, "star_mass": mini + 0 * eep,
            "log_R": 0.5 * logl - 2 * (logt - 3.76)}


def synth_nn_arrays(seed=42):
    """An 8-band, 8-wide BC network in the layout and with the weight
    scales of `examples/_synth.py:59-75` (corrections varying by 1-2 mag
    over the label grid), as `read_nn_file` returns a file's arrays."""
    rng = np.random.default_rng(seed)
    nf, h = len(GRID_FILTERS), 8
    return (rng.normal(size=(nf, h, 6)) * 5.0,
            rng.normal(size=(nf, h, 1)) * 1.0,
            rng.normal(size=(nf, h, h)) * 1.5,
            rng.normal(size=(nf, h, 1)) * 0.5,
            rng.normal(size=(nf, 1, h)) * 6.0,
            rng.normal(size=(nf, 1, 1)) * 0.3,
            np.array([2000.0, 0.0, -3.0, -0.3, 0.0, 1.0]),
            np.array([20000.0, 6.0, 1.0, 0.7, 2.5, 6.0]))


def smooth_nn_arrays(seed=42):
    """The same layout with the first layer weighted toward Teff (scales
    3, 0.5, 0.5, 0.5, 0.5, 0.5 on Teff, logg, feh, afe, Av, Rv) and the
    other layers at the scales of the JAX package's cluster test
    (`tests/test_models.py:48-60`): colours that change along the
    isochrone and magnitudes that change smoothly with Av, Rv and
    [Fe/H]."""
    rng = np.random.default_rng(seed)
    nf, h = len(GRID_FILTERS), 8
    cols = np.array([3.0, 0.5, 0.5, 0.5, 0.5, 0.5])
    return (rng.normal(size=(nf, h, 6)) * cols,
            rng.normal(size=(nf, h, 1)) * 0.1,
            rng.normal(size=(nf, h, h)) * 0.5,
            rng.normal(size=(nf, h, 1)) * 0.1,
            rng.normal(size=(nf, 1, h)) * 0.5,
            rng.normal(size=(nf, 1, 1)) * 0.1,
            np.array([2000.0, 0.0, -3.0, -0.3, 0.0, 1.0]),
            np.array([20000.0, 6.0, 1.0, 0.7, 2.5, 6.0]))


def synth_nn(dev, arrays=None):
    from brutus_tpu_torch.models import FastNNPredictor
    return FastNNPredictor(filters=GRID_FILTERS, device=dev, verbose=False,
                           arrays=synth_nn_arrays() if arrays is None
                           else arrays)


def synth_library(tiny):
    """MIST-schema track rows: mini 0.5-2.0 in steps of 0.01, EEP 202-808
    in steps of 1, the 15 MIST [Fe/H] nodes, afe 0 (`--tiny`: mini in
    steps of 0.05, EEP in steps of 4)."""
    from brutus_tpu_torch.models.tracks import tracks_library
    step_m, step_e = (0.05, 4.0) if tiny else (0.01, 1.0)
    return tracks_library(np.arange(0.5, 2.0 + 1e-9, step_m),
                          np.arange(202.0, 808.0 + 1e-9, step_e), MIST_FEH,
                          np.array([0.0]), analytic_physics)


def synth_maker(library, dev):
    from brutus_tpu_torch.models import SEDmaker
    return SEDmaker(filters=GRID_FILTERS, library=library, nn=synth_nn(dev),
                    device=dev, verbose=False)


def grid_kwargs(tiny):
    """`make_grid`'s keywords of phase 11: the default mini, EEP and
    [Fe/H] grids and (Av, Rv) lattice, one afe, single stars (818,620
    labels, the reference's count); `--tiny` coarser label grids."""
    kw = dict(afe_grid=np.array([0.0]), smf_grid=np.array([0.0]),
              verbose=False)
    if tiny:
        kw.update(mini_grid=np.arange(0.5, 2.0 + 1e-5, 0.1),
                  eep_grid=np.arange(202.0, 808.0 + 1e-5, 12.0),
                  feh_grid=np.arange(-2.0, 0.5 + 1e-5, 0.25))
    return kw


# Phase 11 holds the card's grid against the port on the host in float64
# on a sample of the labels: the same validity and NaN pattern, finite
# coefficients within GRID_TOL mag and predictions within GRID_TOL.
GRID_TOL = 1e-8


def grid_labels(mk, sel):
    """The grid's label array as `io.load_models` builds it from a
    generated file (inputs and predictions, single stars), for `sel`."""
    names = [n for n in ("mini", "feh", "eep", "loga", "logl", "logt",
                         "logg", "agewt") if n in mk.grid_label.dtype.names
             or n in mk.grid_param.dtype.names]
    out = np.zeros(int(sel.sum()), [(n, float) for n in names])
    for n in names:
        src = mk.grid_label if n in mk.grid_label.dtype.names \
            else mk.grid_param
        out[n] = src[n][sel]
    return out


def grid_sample_check(mk, library, n_sample, seed=3):
    """`n_sample` seeded labels of the card's grid regenerated by the
    port on the host in float64 (`grid_rows` of a CPU `SEDmaker` on the
    same tables): the validity flags and NaN patterns equal, and the
    largest |dev| of the finite coefficients and predictions."""
    from brutus_tpu_torch.models.sedmaker import (extinction_lattice,
                                                  split_rows)
    cpu = torch.device("cpu")
    host = synth_maker(library, cpu)
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(len(mk.grid_label), n_sample, replace=False))
    g = mk.grid_label[idx]
    flat = host.grid_rows(g["mini"], g["eep"], g["feh"], g["afe"], g["smf"],
                          *extinction_lattice(cpu)).numpy()
    coeffs, params, good = split_rows(flat, len(host.filters),
                                      len(host.predictions))
    card_c = np.stack([mk.grid_sed[f][idx] for f in mk.filters], axis=1)
    card_p = np.stack([mk.grid_param[n][idx] for n in mk.predictions], 1)
    same = (np.array_equal(good, mk.grid_sel[idx])
            and np.array_equal(np.isnan(coeffs), np.isnan(card_c))
            and np.array_equal(np.isnan(params), np.isnan(card_p)))
    dev_c = np.nanmax(np.abs(coeffs - card_c)) if good.any() else 0.0
    dev_p = np.nanmax(np.abs(params - card_p))
    return dict(same_pattern=same, coeff_dev=float(dev_c),
                param_dev=float(dev_p), n_valid=int(good.sum()),
                n_sample=n_sample,
                ok=same and dev_c <= GRID_TOL and dev_p <= GRID_TOL)


def phase_grid(dev, tiny, screen_k, n_sel):
    """Phase 11: `SEDmaker.make_grid` on the card in float64 (labels/s,
    peak device memory), a sample of it against the host, then the
    funnel on the generated grid's valid models (512 stars of phase 4's
    settings, batches of 128)."""
    from brutus_tpu_torch import BruteForce
    t0 = time.time()
    library = synth_library(tiny)
    mk = synth_maker(library, dev)
    build_s = time.time() - t0
    kw = grid_kwargs(tiny)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    mk.make_grid(**kw)
    gen_s = time.time() - t0
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if dev.type == "cuda" else math.nan)
    n_grid = len(mk.grid_label)
    check = grid_sample_check(mk, library, min(4096, n_grid))
    sel = mk.grid_sel
    mc = np.stack([mk.grid_sed[f][sel] for f in mk.filters],
                  axis=1).astype(np.float32)
    labels = grid_labels(mk, sel)
    n_star, batch = (16, 8) if tiny else (512, 128)
    s = stars(mc, n_star)
    bf = BruteForce(mc, labels, device=dev)
    fit = phase_fit(mc, labels, dev, n_star, batch, screen_k, n_sel, s=s,
                    bf=bf, max_bias=None)
    cols = (mc_columns(bf, s, dev, batch, screen_k, n_sel)
            if dev.type == "cuda" else (math.nan, math.nan))
    # Reported: the reference-semantics funnel against the dense
    # reference engine on this grid (phase 8 holds them on the lattice).
    n_xla = 8 if tiny else 16
    xla = xla_deviation(mc, labels, s, dev, n_xla, 8, screen_k)
    return dict(fit, n_grid=n_grid, build_s=build_s, gen_s=gen_s, xla=xla,
                n_xla=n_xla,
                labels_per_s=n_grid / gen_s, peak_gib=peak,
                valid_share=float(sel.mean()), n_models=int(sel.sum()),
                check=check, mc_valid_share=cols[0] / (batch * n_sel),
                mc_active_share=cols[1] / (batch * n_sel))


def synth_isochrone_arrays(tiny):
    """Isochrone tables in the layout of `examples/_synth.py:77-105`: the
    15 MIST [Fe/H] nodes, afe 0, log age 5.0-10.3 in steps of 0.05, EEP
    202-808 in steps of 1 (`--tiny`: ages in steps of 0.1, EEP in steps
    of 4), mini from inverting the analytic loga(mini, eep), NaN outside
    0.3-2.5 Msun; as `read_isochrone_file` returns a file's arrays."""
    loga_u = np.round(np.arange(5.0, 10.3 + 1e-9, 0.1 if tiny else 0.05), 10)
    eep_u = np.arange(202.0, 808.0 + 1e-9, 4.0 if tiny else 1.0)
    labels = ["mini", "mass", "logl", "logt", "logr", "logg", "feh_surf",
              "afe_surf"]
    grid = np.full((len(MIST_FEH), 1, len(loga_u), len(eep_u),
                    len(labels)), np.nan)
    for i, z in enumerate(MIST_FEH):
        for k, la in enumerate(loga_u):
            mini = 10 ** ((9.0 + 0.004 * (eep_u - 350.0) - la) / 1.2)
            ok = (mini > 0.3) & (mini < 2.5)
            p = analytic_physics(mini, eep_u, z, 0.0)
            cols = [mini, mini, p["log_L"], p["log_Teff"], p["log_R"],
                    p["log_g"], z - 0.05 + 0 * mini, 0 * mini]
            for j, v in enumerate(cols):
                grid[i, 0, k, :, j] = np.where(ok, v, np.nan)
    return MIST_FEH, np.array([0.0]), loga_u, eep_u, grid, labels


def synth_isochrone(arrays, dev, nn_arrays=None):
    from brutus_tpu_torch.models import Isochrone
    return Isochrone(filters=GRID_FILTERS, arrays=arrays,
                     nn=synth_nn(dev, nn_arrays), device=dev, verbose=False)


# The cluster of phase 12, M67-like: [Fe/H], log age, Av, Rv, distance (pc).
CLUSTER_TRUTH = dict(feh=0.0, loga=9.6, av=0.1, rv=3.1, dist=850.0)


def synth_cluster(iso, n_member, seed=12):
    """A co-eval cluster at `CLUSTER_TRUTH` in the isochrone's bands:
    `n_member` single stars along the isochrone, uniform in initial mass
    (the likelihood's own mass measure, reference cluster.py:367-375),
    plus 5% as many field stars (magnitudes spread over the members'
    range, distances 0.3-3 kpc); SNR 50-100 per star and parallax
    errors of 0.05 mas."""
    rng = np.random.default_rng(seed)
    eep = np.linspace(202.0, 808.0, 6000)
    seds, p1, _ = iso.get_seds(eep=eep, mini_bound=0.08, **CLUSTER_TRUTH)
    seds = seds.cpu().numpy()
    ok = np.isfinite(seds).all(1) & np.isfinite(p1["mini"])
    mini, seds = p1["mini"][ok], seds[ok]
    pick = np.clip(np.searchsorted(mini, rng.uniform(
        mini.min(), mini.max(), n_member)), 0, len(mini) - 1)
    mags = seds[pick]
    n_field = n_member // 20
    lo, hi = mags.min(0), mags.max(0)
    field = lo + rng.uniform(size=(n_field, mags.shape[1])) * (hi - lo)
    mags = np.concatenate([mags, field])
    flux = 10 ** (-0.4 * mags)
    snr = rng.uniform(50.0, 100.0, (len(mags), 1))
    err = flux / snr
    flux = flux + rng.normal(size=flux.shape) * err
    dist = np.r_[np.full(n_member, CLUSTER_TRUTH["dist"]),
                 rng.uniform(300.0, 3000.0, n_field)]
    plxe = np.full(len(mags), 0.05)
    plx = 1e3 / dist + rng.normal(size=len(mags)) * plxe
    return dict(phot=flux, err=err, parallax=plx, parallax_err=plxe,
                member=np.r_[np.ones(n_member, bool), np.zeros(n_field,
                                                               bool)])


# Phase 12 holds the cluster likelihood on the card against the port on
# the host in float64 at `CLUSTER_THETAS` seeded parameter sets, through
# `isochrone_loglike` one set at a time and through `fit_cluster`'s
# posterior all sets at once: relative deviation at most LOGLIKE_TOL.
LOGLIKE_TOL = 1e-9
CLUSTER_THETAS = 8
# The uniform prior of phase 12's fits (Rv and the outlier fraction at
# `DEFAULT_BOUNDS`' 2.4-4.2 and 1e-4-0.5): a user's prior for an old
# open cluster, with ages over 2 Gyr, and off the truth, so that a chain
# that never moves, or a flat likelihood, leaves its medians outside
# RECOVERY (midpoints [Fe/H] -0.25, log age 9.8, Av 0.5, 950 pc, Rv
# 3.3, fout 0.25).
HELD_BOUNDS = dict(feh=(-1.0, 0.5), loga=(9.3, 10.3), av=(0.0, 1.0),
                   dist=(700.0, 1200.0))
# A fit recovers the cluster when (1) its posterior medians lie within
# the limits of `tests/test_applications.py::
# test_fit_cluster_recovers_params` (RECOVERY: [Fe/H], log age, Av
# within 0.15, the distance within 60 pc), (2) the median outlier
# fraction is below FOUT_MAX (5% of the stars are field stars), (3) the
# log-likelihood at its MAP is at least that at the truth (outlier
# fraction 0.05) less MAP_SLACK nats, as that test asks, and (4) each
# parameter of RECOVERY has a 16-84% posterior width below WIDTH_SHARE
# of its bounds.
RECOVERY = dict(feh=0.15, loga=0.15, av=0.15, dist=60.0)
FOUT_MAX = 0.2
MAP_SLACK = 2.0
WIDTH_SHARE = 0.1


def cluster_thetas(n, seed=8):
    """`n` seeded parameter sets around `CLUSTER_TRUTH`: half within a
    per-star posterior width of it (most stars inliers), half further
    (most stars outliers); all inside phase 12's prior."""
    rng = np.random.default_rng(seed)
    t = CLUSTER_TRUTH
    base = np.array([t["feh"], t["loga"], t["av"], t["rv"], t["dist"], 0.05])
    scale = np.array([0.05, 0.05, 0.02, 0.1, 10.0, 0.02])
    far = np.arange(n) >= n // 2
    step = rng.normal(size=(n, 6)) * scale * np.where(far, 10.0, 1.0)[:, None]
    lo, hi = cluster_bounds()
    return np.clip(base + step, lo + 0.01 * (hi - lo), hi - 0.01 * (hi - lo))


def cluster_bounds():
    """Phase 12's prior as `(lo, hi)` arrays in `theta` order."""
    from brutus_tpu_torch.cluster import DEFAULT_BOUNDS
    b = dict(DEFAULT_BOUNDS, **HELD_BOUNDS)
    rows = [b[k] for k in ("feh", "loga", "av", "rv", "dist", "fout")]
    return np.array(rows).T


def cluster_loglikes(iso, host, data, kw, dev):
    """The likelihood at `cluster_thetas` on the card, one set at a time
    through `isochrone_loglike` and all at once through the posterior
    that `fit_cluster` samples (the same `_cluster_core` call, the sets
    in its groups), each against `isochrone_loglike` on the host in
    float64."""
    from brutus_tpu_torch import cluster as TC
    cpu = torch.device("cpu")
    args = (data["phot"], data["err"])
    thetas = cluster_thetas(CLUSTER_THETAS)
    ref = np.array([TC.isochrone_loglike(th, host, *args, device=cpu, **kw)
                    for th in thetas])
    one = np.array([TC.isochrone_loglike(th, iso, *args, device=dev, **kw)
                    for th in thetas])
    post = TC._cluster_posterior(
        iso, *args, "free", "fixed", "fixed", 0.08, 480.0, None,
        kw["eep_grid"], kw["parallax"], kw["parallax_err"], 0.95, True,
        HELD_BOUNDS, dev)
    lo, hi = post["lo"].cpu().numpy(), post["hi"].cpu().numpy()
    batch = post["logpost"](torch.as_tensor((thetas - lo) / (hi - lo),
                                            device=dev)).cpu().numpy()
    per_set = len(TC.DEFAULT_SMF_GRID) * len(kw["eep_grid"]) * len(args[0])
    rel = lambda a: float(np.max(np.abs(a - ref) / np.abs(ref)))
    return dict(loglikes=ref.tolist(), dev_one=rel(one), dev_batch=rel(batch),
                group=max(1, TC.BLOCK_ELEMENTS // per_set))


def recovery(out, loglike):
    """Phase 12's recovery check of a `fit_cluster` result, with the
    reading of each of its four parts."""
    s = out["samples"]
    names = out["names"]
    med = dict(zip(names, np.median(s, axis=0)))
    width = dict(zip(names, np.percentile(s, 84, axis=0)
                     - np.percentile(s, 16, axis=0)))
    b = dict(zip(("feh", "loga", "av", "rv", "dist", "fout"),
                 cluster_bounds().T))
    t = CLUSTER_TRUTH
    truth = np.array([t["feh"], t["loga"], t["av"], t["rv"], t["dist"],
                      0.05])
    off = {k: abs(med[k] - t[k]) for k in RECOVERY}
    share = {k: width[k] / (b[k][1] - b[k][0]) for k in RECOVERY}
    ll_map = loglike(out["theta_full"]["cluster"])
    ll_truth = loglike(truth)
    parts = dict(medians=all(off[k] <= RECOVERY[k] for k in RECOVERY),
                 fout=bool(med["fout"] < FOUT_MAX),
                 map=bool(ll_map >= ll_truth - MAP_SLACK),
                 widths=all(share[k] < WIDTH_SHARE for k in RECOVERY))
    return dict(median=med, off=off, width_share=share, ll_map=ll_map,
                ll_truth=ll_truth, parts=parts,
                recovered=all(parts.values()))


def fit_text(c, n_steps, n_burn):
    """A phase-12 fit's report."""
    r = c["rec"]
    rnd = lambda d: {k: round(float(v), 4) for k, v in d.items()}
    return (f"fit_cluster, {c['n_obj']} stars, {c['n_eep']} EEPs x 15 smf "
            f"values, 32 walkers x {n_steps} steps ({n_burn} burn-in): "
            f"{c['fit_s']:.1f} s, {c['walker_steps_per_s']:.1f} "
            f"walker-steps/s, peak device memory {c['peak_gib']:.3f} GiB, "
            f"acceptance {c['acceptance']:.3f}; posterior medians "
            f"{rnd(r['median'])} against {CLUSTER_TRUTH}, 16-84% widths "
            f"over the bounds {rnd(r['width_share'])}, log-likelihood at "
            f"the MAP {r['ll_map']:.2f}, at the truth (fout 0.05) "
            f"{r['ll_truth']:.2f}; checks {r['parts']}: recovered "
            f"{r['recovered']}")


def phase_cluster(dev, tiny, n_steps, n_burn, nn_arrays=None):
    """Phase 12 on one BC network (`nn_arrays`, phase 11's by default):
    an `Isochrone` built in memory, a synthetic M67-like cluster, the
    likelihood on the card against the host in float64
    (`cluster_loglikes`), and `fit_cluster` at its widths (every cluster
    parameter free, 2,000 EEPs, `DEFAULT_SMF_GRID`, 32 walkers) within
    `HELD_BOUNDS`, timed in walker-steps/s and checked by `recovery`."""
    from brutus_tpu_torch.cluster import fit_cluster, isochrone_loglike
    cpu = torch.device("cpu")
    t0 = time.time()
    arrays = synth_isochrone_arrays(tiny)
    iso = synth_isochrone(arrays, dev, nn_arrays)
    host = synth_isochrone(arrays, cpu, nn_arrays)
    data = synth_cluster(host, 40 if tiny else 1000)
    build_s = time.time() - t0
    n_eep = 150 if tiny else 2000
    kw = dict(parallax=data["parallax"], parallax_err=data["parallax_err"],
              eep_grid=np.linspace(202.0, 808.0, n_eep))
    args = (data["phot"], data["err"])
    t0 = time.time()
    lls = cluster_loglikes(iso, host, data, kw, dev)
    check_s = time.time() - t0
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fit_cluster(iso, *args, n_walkers=32, n_steps=n_steps,
                      n_burn=n_burn, seed=1, device=dev, bounds=HELD_BOUNDS,
                      **kw)
    fit_s = time.time() - t0
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if dev.type == "cuda" else math.nan)
    rec = recovery(out, lambda th: isochrone_loglike(th, iso, *args,
                                                     device=dev, **kw))
    return dict(lls, n_obj=len(args[0]), n_eep=n_eep, build_s=build_s,
                check_s=check_s, fit_s=fit_s,
                walker_steps_per_s=32 * n_steps / fit_s, peak_gib=peak,
                rec=rec, acceptance=out["acceptance"],
                rhat=out["rhat"].tolist())


# Phase 13: a sightline of lattice stars behind two clouds, Av = 0.2 +
# 0.8 [mu > 8.5] + 0.7 [mu > 11.0] (distance modulus mu), with a 5%
# zero-point error put into band 2 (its flux divided by 1.05).
CLOUDS_DM = (8.5, 11.0)
INJECT_BAND, INJECT = 2, 1.05
# What phase 13 holds.  The card against the host in float64: the LOS
# log-likelihood at `LOS_THETAS` seeded thetas (relative LOS_TOL, every
# kernel, template and additive modes; LOS_F32_TOL for the float32
# likelihood of `fit_clouds`'s walkers), the model fluxes, leave-one-
# band-out weights and plotting helpers of `HOLD_STARS` stars against
# numpy (relative HOST_TOL); the binned PDFs of `HOLD_STARS` stars against numpy's
# `histogram2d` and scipy's `gaussian_filter` (histograms equal but for
# draws within EDGE_REL of an edge, PDFs within PDF_TOL).  Science, with
# controls that must fail: the two-cloud evidence beats the one-cloud
# one by more than EVIDENCE_GAP nats and EVIDENCE_SIGMA sigma, and the
# best two-cloud MAP puts a cloud within MAP_DM_TOL of each step of
# `CLOUDS_DM` (the control: the same fits with each star's distance
# draws given to another star).  The best MAP is that of the highest
# log-likelihood among the ladder's beta=1 chain and RESTARTS chains
# without the ladder from other seeds: from the unit cube a chain of 64
# walkers at the defaults can settle in a mode that merges the steps,
# and which seeds do is a matter of the random stream, the JAX
# package's as the port's (given JAX's random numbers the port follows
# its chain step for step, `tests/test_torch_los.py`; over the same 48
# seeds of `tools/los_seeds.py` each finds both steps in about six of
# ten, PERF.md §6);
# `photometric_offsets` reads band 2 as the band farthest from 1, by more
# than OFFSET_MIN, while on the control fit (no injection) every band
# lies within OFFSET_CONTROL of 1, and the two band-2 readings differ by
# more than OFFSET_SIGMA bootstrap sigma.
LOS_THETAS = 8
LOS_TOL, LOS_F32_TOL = 1e-9, 1e-5
HOST_TOL = 1e-9
HOLD_STARS = 64
EDGE_REL = 1e-12
PDF_TOL = 1e-6
EVIDENCE_GAP, EVIDENCE_SIGMA = 5.0, 3.0
MAP_DM_TOL, RESTARTS = 0.5, 4
OFFSET_MIN, OFFSET_CONTROL, OFFSET_SIGMA = 0.03, 0.005, 3.0
# The kernels of the funnel fit that feeds phase 13, by their names in a
# `torch.profiler` trace, as patterns: K4's name is also the start of the
# draws kernel's.
K4_NAME, DRAWS_NAME = r"mc_kernel(?!_draws)", "mc_kernel_draws"
TRACE_NAMES = dict(screen="screen_kernel", gather="gather_kernel",
                   fit="fit_kernel", mc_rng=K4_NAME, draws=DRAWS_NAME)


def sightline(mc, n_star, seed=13):
    """Phase 13's catalogue: `n_star` lattice models at phase 4's
    coordinate, distances log-uniform over 0.2-5 kpc, the two-cloud Av
    profile plus N(0, 0.05), Rv 2.8-3.8, SNR 60 and 10% parallaxes as
    in `stars`; `flux` carries the band-2 injection, `flux_control` is
    the same photometry without it."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, mc.shape[0], n_star)
    dm = rng.uniform(6.5, 13.5, n_star)
    dist = 10 ** (dm / 5.0 - 2.0)
    av = (0.2 + 0.8 * (dm > CLOUDS_DM[0]) + 0.7 * (dm > CLOUDS_DM[1])
          + rng.normal(size=n_star) * 0.05).clip(0.01, None)
    rv = rng.uniform(2.8, 3.8, n_star)
    sed = mc[idx, :, 0] + av[:, None] * (mc[idx, :, 1]
                                         + rv[:, None] * mc[idx, :, 2])
    flux = 10 ** (-0.4 * sed) / dist[:, None] ** 2
    err = flux / 60.0
    flux = flux + rng.normal(size=flux.shape) * err
    inj = flux.copy()
    inj[:, INJECT_BAND] /= INJECT
    return dict(flux=inj.astype(np.float32),
                flux_control=flux.astype(np.float32),
                err=err.astype(np.float32), idx=idx, dist=dist, dm=dm,
                av=av, plx=1.0 / dist + rng.normal(size=n_star) * 0.1 / dist,
                plxe=0.1 / dist, coords=np.tile([204.7, -19.2], (n_star, 1)))


def traced_fit(bf, s, dev, batch, screen_k, n_sel, logdir):
    """`fit_stars` of the sightline inside `profiling.trace` with an
    `annotate` region and a `profiling.Throughput` counting its stars;
    returns the fit, the meter's rate, the trace files and whether the
    trace names the annotation and each kernel of `TRACE_NAMES` (read as
    text: the parsed events of a CPU trace run to millions of objects)."""
    import glob
    from brutus_tpu_torch import profiling
    shutil.rmtree(logdir, ignore_errors=True)
    with profiling.trace(logdir):
        with profiling.annotate("phase13_fit"):
            meter = profiling.Throughput(total=len(s["idx"]), unit="stars",
                                         stream=None)
            out, dt, launches = fit_stars(bf, s, dev, batch, screen_k, n_sel,
                                          dustmap=None)
            meter.update(len(s["idx"]))
            rate = meter.rate
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    text = open(files[0]).read() if files else ""
    shutil.rmtree(logdir, ignore_errors=True)
    seen = {k: re.search(v, text) is not None
            for k, v in TRACE_NAMES.items()}
    seen["annotation"] = '"phase13_fit"' in text
    return out, dt, launches, rate, files, seen


def los_host(theta, ds, rs, kernel="gauss", template=None, additive=False,
             area=6.0):
    """The cloud model's log-likelihood in float64 on the host (numpy,
    and torch's logsumexp: scipy's fails where jax is blocked with a
    None module), written out from the reference's definition
    (`brutus/los.py:119-248`)."""
    pb, s0, s = theta[:3]
    reds, dists = theta[3::2], theta[4::2]
    edges = np.r_[0.0, dists, 1e10]
    sig = np.r_[s0 * area, np.full(len(dists), s * area)]
    logw = np.empty((len(reds),) + rs.shape)
    for c in range(len(reds)):
        mean = reds[c] * (1.0 if template is None or c == 0
                          else template[:, None])
        if additive and c > 0:
            mean = mean + reds[0]
        z = (rs - mean) / sig[c]
        if kernel == "gauss":
            lw = -0.5 * z ** 2 - np.log(np.sqrt(2.0 * np.pi) * sig[c])
        elif kernel == "lorentz":
            lw = -np.log1p(z ** 2) - np.log(np.pi * sig[c])
        else:
            lw = np.where((rs >= mean - sig[c]) & (rs < mean + sig[c]),
                          -np.log(2.0 * sig[c]), -np.inf)
        logw[c] = np.where((ds >= edges[c]) & (ds < edges[c + 1]), lw,
                           -np.inf)
    ll = (torch.logsumexp(torch.from_numpy(logw), dim=(0, 2)).numpy()
          - np.log(rs.shape[1]))
    return float(np.logaddexp(np.log1p(-pb) + ll,
                              np.log(pb) - np.log(area)).sum())


def los_thetas(n, seed=14):
    """`n` seeded two-cloud thetas `[pb, s0, s, fg, d1, r1, d2, r2]`."""
    rng = np.random.default_rng(seed)
    th = np.empty((n, 8))
    th[:, 0] = rng.uniform(0.01, 0.2, n)
    th[:, 1:3] = rng.uniform(0.01, 0.1, (n, 2))
    th[:, [4, 6]] = np.sort(rng.uniform(6.0, 14.0, (n, 2)), axis=1)
    th[:, [3, 5, 7]] = np.sort(rng.uniform(0.0, 2.5, (n, 3)), axis=1)
    return th


def los_holds(ds, rs, dev):
    """`LOS_clouds_loglike_samples` on the card at `los_thetas` against
    `los_host`, per mode, and the float32 likelihood of `fit_clouds`'s
    walkers (`fit32`, the Gaussian kernel on float32 draws and thetas)
    against `los_host` on the same rounded values: the largest relative
    deviation of each."""
    from brutus_tpu_torch.los import (LOS_clouds_loglike_samples,
                                      _los_loglike_core)
    tmpl = np.random.default_rng(15).uniform(0.5, 2.0, len(ds))
    d, r = (np.asarray(v, np.float64)[:, :25] for v in (ds, rs))
    modes = dict(gauss={}, tophat=dict(kernel="tophat"),
                 lorentz=dict(kernel="lorentz"),
                 template=dict(template=tmpl),
                 additive=dict(additive=True))
    out = {}
    for name, kw in modes.items():
        dev_max = 0.0
        for th in los_thetas(LOS_THETAS):
            host = los_host(th, d, r, **kw)
            card = LOS_clouds_loglike_samples(
                th, ds, rs, kernel=kw.get("kernel", "gauss"),
                template_reds=kw.get("template"),
                additive_foreground=kw.get("additive", False), device=dev)
            dev_max = max(dev_max, abs(card - host) / abs(host))
        out[name] = dev_max
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    d32, r32 = (np.asarray(v, np.float32)[:, :25] for v in (ds, rs))
    dev_max = 0.0
    for th in los_thetas(LOS_THETAS).astype(np.float32):
        host = los_host(th.astype(np.float64), d32.astype(np.float64),
                        r32.astype(np.float64))
        card = _los_loglike_core(
            f32(th[3::2])[None], f32(th[4::2])[None], f32(th[:1]),
            f32(th[1:2]) * 6.0, f32(th[2:3]) * 6.0, f32(d32), f32(r32))
        dev_max = max(dev_max, abs(float(card[0]) - host) / abs(host))
    out["fit32"] = dev_max
    return out


def cloud_fits(ds, rs, dev, tiny):
    """`fit_clouds` with one and with two clouds and the evidence ladder
    (the defaults: 64 walkers, 1500 steps, 750 burn-in, 25 draws, 16
    rungs), timed; then `RESTARTS` two-cloud chains without the ladder
    from other seeds (one in the rehearsal).  Whether the evidence finds two clouds, and
    whether the best two-cloud MAP of all these chains (the highest
    log-likelihood) puts a cloud at each step."""
    from brutus_tpu_torch.los import fit_clouds
    kw = (dict(n_walkers=16, n_steps=200, n_burn=100, n_temps=6) if tiny
          else dict(n_walkers=64, n_steps=1500, n_burn=750, n_temps=16))
    fits = {}
    for nc in (1, 2):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        f = fit_clouds(ds, rs, n_clouds=nc, evidence=True, seed=nc,
                       device=dev, **kw)
        f["seconds"] = time.time() - t0
        f["walker_steps_per_s"] = (kw["n_temps"] * kw["n_walkers"]
                                   * kw["n_steps"] / f["seconds"])
        fits[nc] = f
    gap = fits[2]["logz"] - fits[1]["logz"]
    sigma = float(np.hypot(fits[1]["logz_err"], fits[2]["logz_err"]))
    t0 = time.time()
    maps = [(float(fits[2]["logl"].max()), fits[2]["map_theta"])]
    plain = {k: v for k, v in kw.items() if k != "n_temps"}
    restarts = 1 if tiny else RESTARTS
    for seed in range(3, 3 + restarts):
        f = fit_clouds(ds, rs, n_clouds=2, seed=seed, device=dev, **plain)
        maps.append((float(f["logl"].max()), f["map_theta"]))
    restart_s = time.time() - t0
    steps = lambda m: [float(abs(m[4] - CLOUDS_DM[0])),
                       float(abs(m[6] - CLOUDS_DM[1]))]
    found = [bool(max(steps(m)) < MAP_DM_TOL) for _, m in maps]
    m = max(maps, key=lambda x: x[0])[1]
    map_off = steps(m)
    ok = bool(gap > EVIDENCE_GAP and gap > EVIDENCE_SIGMA * sigma
              and max(map_off) < MAP_DM_TOL)
    return dict(fits=fits, gap=float(gap), sigma=sigma, map=m.tolist(),
                map_off=map_off, found=found, restart_s=restart_s, ok=ok,
                restarts=restarts, settings=kw)


def los_text(c):
    f1, f2 = c["fits"][1], c["fits"][2]
    return (f"logz 1 cloud {f1['logz']:.3f} +/- {f1['logz_err']:.3f}, 2 "
            f"clouds {f2['logz']:.3f} +/- {f2['logz_err']:.3f} (gap "
            f"{c['gap']:.3f} nats, {c['gap'] / c['sigma']:.2f} sigma), "
            f"{f1['walker_steps_per_s']:.0f} and "
            f"{f2['walker_steps_per_s']:.0f} walker-steps/s "
            f"({f1['seconds']:.1f} s, {f2['seconds']:.1f} s), acceptance "
            f"{f2['acceptance']:.3f}; both steps found by the ladder's "
            f"chain and {c['restarts']} more ({c['restart_s']:.1f} s): "
            f"{c['found']}, the best MAP {[round(v, 4) for v in c['map']]} "
            f"(clouds off by {[round(v, 4) for v in c['map_off']]}); held "
            f"{c['ok']}")


def pdf_holds(s, out, dev, bins, pdfs, cdfs):
    """The binned PDFs of the first `HOLD_STARS` stars against the host:
    numpy's `histogram2d` of the same draws (saved draws as given; the
    regenerated mode's draws and weights as the card made them) and
    scipy's `gaussian_filter` as the JAX function smooths; each star's
    mass against its in-span weight; the CDFs' monotonicity."""
    from scipy.ndimage import gaussian_filter
    from brutus_tpu_torch import pdf as TP
    n = HOLD_STARS
    plx, plxe = s["plx"][:n], s["plxe"][:n]
    res = dict(cdf_monotone=bool((np.diff(cdfs, axis=1) >= 0).all()))
    regen = dict(coord=s["coords"][:n], Nr=100, bins=bins, parallaxes=plx,
                 parallax_errors=plxe, device=dev)
    data_r = tuple(out[k][:n] for k in ("scale", "av", "rv", "cov_sar"))
    card_r = TP.bin_pdfs_distred(data_r, **regen)[0]
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64,
                                  device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    _, ddr, adr, _, wts = TP._regenerate(
        gen, *(t(v) for v in data_r), 100, (0.0, 6.0), (1.0, 8.0), None,
        t(s["coords"][:n]), t(plx), t(plxe))
    modes = dict(
        saved=(np.asarray(out["dist"][:n], np.float64),
               np.asarray(out["red"][:n], np.float64), None, pdfs[:n]),
        regenerated=(ddr.reshape(n, -1).cpu().numpy(),
                     adr.reshape(n, -1).cpu().numpy(),
                     wts.reshape(n, -1).cpu().numpy(), card_r))
    nsamps = out["dist"].shape[1]
    xe, ye = TP.bin_pdfs_distred((out["dist"][:1], out["red"][:1],
                                  out["dred"][:1]), bins=bins,
                                 device=dev)[1:]
    dx, dy = xe[1] - xe[0], ye[1] - ye[0]
    xsig = TP._x_smoothing(0.01 * (xe[-1] - xe[0]), plx, plxe,
                           "distance_modulus") / dx
    ysig = 0.01 * (ye[-1] - ye[0]) / dy
    for name, (d, y, w, card) in modes.items():
        x = 5.0 * np.log10(d) + 10.0
        xt = TP._to_dist_type(t(d), "distance_modulus")
        Hc = TP._histogram(xt, t(y), None if w is None else t(w), t(xe),
                           t(ye)).cpu().numpy()
        near = miss = 0
        pdf_dev = mass_dev = 0.0
        for i in range(n):
            wi = None if w is None else w[i]
            H = np.histogram2d(x[i], y[i], bins=(xe, ye), weights=wi)[0]
            near += int((edge_near(x[i], xe) | edge_near(y[i], ye)).sum())
            if np.abs(Hc[i] - H).sum() > 1e-9 * max(1.0, H.sum()):
                miss += 1
                continue
            host = gaussian_filter((H / nsamps).astype(np.float32),
                                   (xsig[i], ysig))
            pdf_dev = max(pdf_dev, float(np.abs(card[i] - host).max()))
            span = ((x[i] >= xe[0]) & (x[i] <= xe[-1]) & (y[i] >= ye[0])
                    & (y[i] <= ye[-1]))
            inspan = (span.sum() if wi is None else wi[span].sum()) / nsamps
            mass_dev = max(mass_dev, abs(float(card[i].astype(np.float64)
                                               .sum()) - inspan))
        res[name] = dict(edge_draws=near, stars_differing=miss,
                         pdf_dev=pdf_dev, mass_dev=mass_dev,
                         ok=bool((miss == 0 or miss <= near)
                                 and pdf_dev <= PDF_TOL and mass_dev <= 1e-5))
    res["ok"] = bool(res["cdf_monotone"] and res["saved"]["ok"]
                     and res["regenerated"]["ok"])
    return res


def edge_near(v, edges):
    """Which values lie within `EDGE_REL` (relative) of an edge."""
    i = np.clip(np.searchsorted(edges, v), 1, len(edges) - 1)
    gap = np.minimum(np.abs(v - edges[i]), np.abs(v - edges[i - 1]))
    return gap <= EDGE_REL * np.abs(v)


def rel_dev(card, host):
    return float(np.max(np.abs(card - host)
                        / np.maximum(np.abs(host), 1e-300)))


def host_lnweights(lnl):
    """Weights normalised over the last axis from log-weights, numpy."""
    m = lnl.max(axis=-1, keepdims=True)
    w = np.exp(lnl - m)
    return w / w.sum(axis=-1, keepdims=True)


def host_chi2_logpdf(x, df):
    """The chi-square log-density with `df` degrees of freedom at `x`
    (-inf at x <= 0), numpy and `math.lgamma`."""
    k = 0.5 * df
    with np.errstate(divide="ignore", invalid="ignore"):
        v = (k - 1.0) * np.log(x) - 0.5 * x - k * math.log(2.0) \
            - math.lgamma(k)
    return np.where(x > 0, v, -np.inf)


def offsets_host(s, out, mc, n):
    """What `offsets_holds` holds the card to, written out in numpy
    float64 from the reference's definitions (`brutus/utils.py:
    1162-1215, 1330-1368`, `brutus/plotting.py:1073-1116`): the draws'
    magnitudes `c0 + Av (c1 + Rv c2)`, their fluxes over distance
    squared and magnitudes plus 5 log10(distance); per left-out band,
    the flux weights of `photometric_offsets` (chi-square log-density
    of the other bands' chi2 with F - 4 degrees of freedom) and the
    magnitude weights of the plotting helpers (NaN terms skipped, at
    least one degree of freedom, -1e300 for a non-finite value)."""
    idx = np.asarray(out["model_idx"][:n])
    c = np.asarray(mc, np.float64)[idx]                  # (n, S, F, 3)
    av, rv, dist = (np.asarray(out[k][:n], np.float64)[..., None]
                    for k in ("red", "dred", "dist"))
    sed = c[..., 0] + av * (c[..., 1] + rv * c[..., 2])
    flux = 10 ** (-0.4 * sed) / dist ** 2
    mags = sed + 5.0 * np.log10(dist)
    phot, err = (np.asarray(s[k][:n], np.float64) for k in ("flux", "err"))
    mo = -2.5 * np.log10(phot)
    me = 2.5 / math.log(10.0) * err / phot
    F = phot.shape[1]
    wflux, wmag = [], []
    for band in range(F):
        keep = np.arange(F) != band
        chi2 = (((phot[:, None, keep] - flux[..., keep])
                 / err[:, None, keep]) ** 2).sum(-1)
        wflux.append(host_lnweights(host_chi2_logpdf(chi2, F - 4)))
        chi2 = np.nansum(((mo[:, None, keep] - mags[..., keep])
                          / me[:, None, keep]) ** 2, axis=-1)
        lnl = host_chi2_logpdf(chi2, max(F - 4, 1))
        wmag.append(host_lnweights(np.where(np.isfinite(lnl), lnl,
                                            -1e300)))
    return flux, mags, np.stack(wflux), np.stack(wmag)


def offsets_holds(s, out, mc, dev):
    """The model fluxes and leave-one-band-out weights of
    `photometric_offsets` for the first `HOLD_STARS` stars, and the
    plotting helpers `_posterior_predictive_mags` and
    `_leave_band_weights` (every band), on the card against
    `offsets_host` in numpy float64: the largest relative deviation of
    each."""
    from brutus_tpu_torch import offsets as TO
    from brutus_tpu_torch import plotting as TPL
    n = HOLD_STARS
    flux, mags, wflux, wmag = offsets_host(s, out, mc, n)
    draws = [out[k][:n] for k in ("model_idx", "red", "dred", "dist")]
    seds = TO._model_fluxes(mc, *draws, dev)
    phot, err = (torch.as_tensor(s[k][:n], dtype=torch.float64, device=dev)
                 for k in ("flux", "err"))
    mask = torch.ones(phot.shape, dtype=torch.bool, device=dev)
    card_mags = TPL._posterior_predictive_mags(mc, *draws, device=dev)
    mo, me = TPL.magnitude(s["flux"][:n].astype(np.float64),
                           s["err"][:n].astype(np.float64))
    wdev = lw = 0.0
    for band in range(phot.shape[1]):
        w = TO._band_weights(phot, err, mask, seds, band, True)
        wdev = max(wdev, rel_dev(w.cpu().numpy(), wflux[band]))
        w = TPL._leave_band_weights(mo, me, np.ones(mo.shape, bool),
                                    card_mags, band, device=dev)[1]
        lw = max(lw, rel_dev(w, wmag[band]))
    return dict(seds=rel_dev(seds.cpu().numpy(), flux), band_weights=wdev,
                mags=rel_dev(card_mags, mags), leave_band=lw)


def offsets_text(r):
    return (f"ratios {np.round(r['ratios'], 4).tolist()} +/- "
            f"{np.round(r['errors'], 4).tolist()} ({r['seconds']:.2f} s)")


def phase_apps(mc, labels, dev, tiny, batch, screen_k, n_sel):
    """Phase 13: the applications after a fit, fed by the funnel on the
    card (K2, K3, K1, K4).  The sightline fitted twice (with the band-2
    injection, traced, and without it); `LOS_clouds_loglike_samples`
    against the host; `fit_clouds` with the evidence ladder and its
    shuffled control; `bin_pdfs_distred` in its three modes against the
    host; `photometric_offsets` on both fits; the plotting helpers."""
    from brutus_tpu_torch import BruteForce
    from brutus_tpu_torch.offsets import photometric_offsets
    from brutus_tpu_torch.pdf import bin_pdfs_distred
    r = {}
    t0 = time.time()
    n_star = 256 if tiny else 2048
    s = sightline(mc, n_star)
    bf = BruteForce(mc, labels, device=dev)
    logdir = os.path.join("build", "phase13_trace")
    out, dt, launches, rate, files, seen = traced_fit(
        bf, s, dev, batch, screen_k, n_sel, logdir)
    annotated = seen.pop("annotation")
    r.update(n_star=n_star, launches=launches, stars_per_s=n_star / dt,
             meter_rate=rate,
             trace=dict(files=len(files), annotated=annotated, kernels=seen))
    ctrl = dict(s, flux=s["flux_control"])
    out_c = fit_stars(bf, ctrl, dev, batch, screen_k, n_sel, dustmap=None)[0]
    r["fit_s"] = time.time() - t0
    for o in (out, out_c):
        if not all(np.isfinite(v).all() for v in o.values()
                   if v.dtype.kind == "f"):
            raise AssertionError("non-finite values in phase 13's fit")
    dm_med = np.median(5.0 * np.log10(out["dist"]) + 10.0, axis=1)
    r["dm_bias"] = float(np.median(dm_med - s["dm"]))

    t0 = time.time()
    ds = 5.0 * np.log10(out["dist"]) + 10.0
    rs = out["red"]
    r["los_dev"] = los_holds(ds, rs, dev)
    r["los"] = cloud_fits(ds, rs, dev, tiny)
    perm = np.random.default_rng(16).permutation(n_star)
    r["los_control"] = cloud_fits(ds[perm], rs, dev, tiny)
    r["los_s"] = time.time() - t0

    t0 = time.time()
    bins = (75, 30) if tiny else (750, 300)
    kw = dict(bins=bins, parallaxes=s["plx"], parallax_errors=s["plxe"],
              device=dev)
    saved = (out["dist"], out["red"], out["dred"])
    tp = {}
    for name, call in (
            ("saved", lambda: bin_pdfs_distred(saved, **kw)[0]),
            ("cdf", lambda: bin_pdfs_distred(saved, cdf=True, **kw)[0]),
            ("regenerated", lambda: bin_pdfs_distred(
                tuple(out[k] for k in ("scale", "av", "rv", "cov_sar")),
                coord=s["coords"], Nr=100, **kw)[0])):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.time()
        tp[name] = call()
        r[f"pdf_{name}_stars_per_s"] = n_star / (time.time() - t1)
    r["pdf"] = pdf_holds(s, out, dev, bins, tp["saved"], tp["cdf"])
    r["bins"] = bins
    r["pdf_s"] = time.time() - t0
    del tp

    t0 = time.time()
    mask = np.ones(s["flux"].shape, bool)
    for name, o, flux in (("offsets", out, s["flux"]),
                          ("offsets_control", out_c, s["flux_control"])):
        t1 = time.time()
        ratios, errors, nratio = photometric_offsets(
            flux, s["err"], mask, mc, o["model_idx"], o["red"], o["dred"],
            o["dist"], Nmc=150, verbose=False, device=dev)
        r[name] = dict(ratios=ratios, errors=errors, nratio=nratio,
                       seconds=time.time() - t1)
    inj, ctl = r["offsets"], r["offsets_control"]
    off = np.abs(inj["ratios"] - 1.0)
    r["offsets_ok"] = bool(
        np.argmax(off) == INJECT_BAND and off[INJECT_BAND] > OFFSET_MIN
        and np.abs(ctl["ratios"] - 1.0).max() < OFFSET_CONTROL
        and abs(inj["ratios"][INJECT_BAND] - ctl["ratios"][INJECT_BAND])
        > OFFSET_SIGMA * np.hypot(inj["errors"][INJECT_BAND],
                                  ctl["errors"][INJECT_BAND]))
    r["host"] = offsets_holds(s, out, mc, dev)
    r["offsets_s"] = time.time() - t0
    return r


def report_apps(a, tiny, t0):
    """Phase 13's line, and its checks (the science ones held at full
    size only)."""
    los, ctl = a["los"], a["los_control"]
    held = not tiny
    log(f"phase 13 applications on a sightline of {a['n_star']} stars, "
        f"fed by the funnel (in-kernel draws, Galactic and parallax "
        f"priors, no dust prior): fit inside profiling.trace "
        f"{a['stars_per_s']:.1f} stars/s, Throughput {a['meter_rate']:.1f} "
        f"stars/s, trace files {a['trace']['files']}, annotation "
        f"{a['trace']['annotated']}, kernels in the trace "
        f"{a['trace']['kernels']}, median distance-modulus bias "
        f"{a['dm_bias']:+.4f}, launches {a['launches']}, two fits "
        f"{a['fit_s']:.1f} s; LOS likelihood against the host at "
        f"{LOS_THETAS} thetas, max relative dev "
        f"{ {k: float(f'{v:.3g}') for k, v in a['los_dev'].items()} } (tol "
        f"{LOS_TOL}, fit32 {LOS_F32_TOL}); fit_clouds {los['settings']}: {los_text(los)}; "
        f"control (distance draws shuffled across stars, must fail): "
        f"{los_text(ctl)} ({a['los_s']:.1f} s); bin_pdfs_distred at bins "
        f"{a['bins'][0]}x{a['bins'][1]}: "
        f"saved draws {a['pdf_saved_stars_per_s']:.1f} stars/s, CDF "
        f"{a['pdf_cdf_stars_per_s']:.1f}, regenerated (Nr=100) "
        f"{a['pdf_regenerated_stars_per_s']:.1f}; {HOLD_STARS} stars "
        f"against numpy/scipy: {a['pdf']} (edge {EDGE_REL}, PDF tol "
        f"{PDF_TOL}; {a['pdf_s']:.1f} s); photometric_offsets, band "
        f"{INJECT_BAND} divided by {INJECT}: {offsets_text(a['offsets'])}; "
        f"control: {offsets_text(a['offsets_control'])}; held (band "
        f"{INJECT_BAND} farthest, off by > {OFFSET_MIN}, control within "
        f"{OFFSET_CONTROL}, apart by > {OFFSET_SIGMA} sigma) "
        f"{a['offsets_ok']}; {HOLD_STARS} stars against the host in "
        f"float64, max relative dev {a['host']} (tol {HOST_TOL}; "
        f"{a['offsets_s']:.1f} s)"
        + ("" if held else " (rehearsal: science checks not held)")
        + f"  [{time.time() - t0:.1f} s]")
    f32 = a["los_dev"]["fit32"]
    if (max(v for k, v in a["los_dev"].items() if k != "fit32") > LOS_TOL
            or f32 > LOS_F32_TOL):
        raise AssertionError("the LOS likelihood on the card disagrees "
                             "with the host's")
    if max(a["host"].values()) > HOST_TOL:
        raise AssertionError("the offsets or plotting helpers on the card "
                             "disagree with the host's")
    if not a["pdf"]["ok"]:
        raise AssertionError("the binned PDFs disagree with numpy/scipy")
    if not (a["trace"]["files"] == 1 and a["trace"]["annotated"]):
        raise AssertionError("the trace of phase 13's fit is missing or "
                             "lacks its annotation")
    if not abs(a["meter_rate"] / a["stars_per_s"] - 1.0) < 0.1:
        raise AssertionError("Throughput's rate is not the fit's stars/s")
    if held:
        if not (los["ok"] and not ctl["ok"]):
            raise AssertionError(
                "the evidence or the MAP missed the clouds" if not los["ok"]
                else "the shuffled control passed the cloud check")
        if not a["offsets_ok"]:
            raise AssertionError("photometric_offsets did not single out "
                                 "the injected band against its control")


# ---------------------------------------------------------------------------
# Phase 14: the device mesh
# ---------------------------------------------------------------------------

# What phase 14 holds a mesh's fit to when it is not equal to the single
# process's bit for bit (`tests/test_parallel.py`'s limits): log-evidence
# rtol, atol; chi2min rtol; the share of equal drawn models.
MESH_EVID_TOL = (1e-6, 1e-5)
MESH_CHI2_TOL = 1e-6
MESH_AGREE = 0.95
# The outputs held: drawn models, log-evidence, chi2min, distance and Av
# draws.
MESH_KEYS = ("model_idx", "log_evidence", "chi2min", "dist", "red")
# Seconds a phase-14 world may run before it is killed (each collective
# of its process group times out sooner, at `MESH_COLLECTIVE_S`).
MESH_WORLD_S = 600
MESH_COLLECTIVE_S = 300
MESH_DIR = os.path.join("build", "phase14")
# The kernels each path must launch on every rank.
MESH_KERNELS = dict(funnel=("screen", "gather", "fit", "mc_rng", "draws"),
                    dense=("fit_dense", "draws"),
                    xla_funnel=("screen", "gather", "draws"),
                    xla_dense=("draws",), polish=(), polish_nocull=())
# The `polish` jobs: `ops.optimize.loglike_grid` with this `polish_k`
# on a model-sharded grid (its job's `n_sel` field), with the init cull
# (`apply_init_cull`) by path: with it, only the models near a star's
# best are polished, which may all lie in every shard's offer; without
# it, exactly the global top `polish_k` are, so the rows depend on the
# merged selection.  The fields the ranks' rows must equal bit for bit.
MESH_POLISH_K = 2048
MESH_POLISH_CULL = dict(polish=True, polish_nocull=False)
MESH_POLISH_KEYS = ("lnlike", "chi2", "scale", "av", "rv", "n_iter")


def mesh_jobs(tiny, four=False):
    """Phase 14's fits: `(name, path, mesh shape, stars, batch, screen_k,
    n_sel, engine)`, the stars given as `(n, seed, first n)` of
    `stars()`.  The single card's worlds: (b) the funnel on 1 x 2, (c)
    the funnel and the dense fused engine on 2 x 1, (d) the
    reference-semantics funnel and dense engine and `loglike_grid(
    polish_k=MESH_POLISH_K)` on 1 x 2; with `four`, the four cards'
    1 x 4, 2 x 2 and 4 x 1 meshes instead."""
    n4, b4, k, ns = (16, 8, 1024, 256) if tiny else (512, 128, 12288, 2048)
    n6, b6, f6 = (16, 8, 8) if tiny else (256, 16, 64)
    n8, b8, c8, bc8 = (16, 8, 8, 8) if tiny else (128, 128, 16, 8)
    fun = ((n4, 7, n4), b4, k, ns, None)
    dense = ((n6, 7, f6), b6, 0, ns, None)
    xfun = ((n8, 9, n8), b8, k, 2048, "xla")
    xdense = ((n8, 9, c8), bc8, 0, 2048, "xla")
    polish = ((n8, 9, c8), c8, 0, MESH_POLISH_K, None)
    if four:
        nb, bb = (64, 32) if tiny else (32768, 1024)
        big = ((nb, 7, nb), bb, k, ns, None)
        return [("funnel 1x4", "funnel", (1, 4)) + fun,
                ("funnel 2x2", "funnel", (2, 2)) + fun,
                ("funnel 4x1", "funnel", (4, 1)) + fun,
                (f"funnel 4x1, {nb} stars", "funnel", (4, 1)) + big,
                (f"funnel 1x4, {nb} stars", "funnel", (1, 4)) + big,
                ("dense 4x1", "dense", (4, 1)) + dense,
                ("xla funnel 1x4", "xla_funnel", (1, 4)) + xfun,
                ("xla dense 1x4", "xla_dense", (1, 4)) + xdense,
                ("polish_k 1x4", "polish", (1, 4)) + polish,
                ("polish_k 1x4, no init cull", "polish_nocull", (1, 4))
                + polish]
    return [("(b) funnel 1x2", "funnel", (1, 2)) + fun,
            ("(c) funnel 2x1", "funnel", (2, 1)) + fun,
            ("(c) dense 2x1", "dense", (2, 1)) + dense,
            ("(d) xla funnel 1x2", "xla_funnel", (1, 2)) + xfun,
            ("(d) xla dense 1x2", "xla_dense", (1, 2)) + xdense,
            ("(d) polish_k 1x2", "polish", (1, 2)) + polish,
            ("(d) polish_k 1x2, no init cull", "polish_nocull", (1, 2))
            + polish]


def mesh_stars(mc, spec):
    n, seed, first = spec
    s = stars(mc, n, seed=seed)
    return {k: (v[:first] if np.ndim(v) else v) for k, v in s.items()}


def polish_call(mag_coeffs, s, k, cull, group=None):
    """`ops.optimize.loglike_grid` of the stars `s` (with their
    parallaxes) against `mag_coeffs` (this rank's shard on a model
    `group`) with `polish_k=k` and `apply_init_cull=cull`: the fields
    of `MESH_POLISH_KEYS` on the host and the call's seconds to its
    final synchronise."""
    from brutus_tpu_torch.config import FitConfig
    from brutus_tpu_torch.ops.optimize import loglike_grid
    dev = mag_coeffs.device
    t = lambda x: torch.as_tensor(np.asarray(x), device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    out = loglike_grid(t(s["flux"]), t(s["err"]),
                       t(np.ones(s["flux"].shape, bool)), mag_coeffs,
                       parallax=t(s["plx"]), parallax_err=t(s["plxe"]),
                       cfg=FitConfig(polish_k=k, apply_init_cull=cull),
                       model_group=group)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    return {f: out[f].cpu().numpy() for f in MESH_POLISH_KEYS}, dt


def mesh_worker(rank, world, backend, device_type, rdv, jobs, out_dir,
                threads):
    """One rank of a phase-14 world (a spawned process): joins the world
    (`backend` over a file rendezvous), loads the kernels the parent
    built and the grid it wrote, and runs `jobs` on their meshes, on a
    CUDA device (rank modulo the card count) or the CPU.  Rank 0 saves
    each fit's results (every rank its rows of a `polish` job); every
    rank saves its seconds, launch counts and the time of its
    model-axis all-reduces (the funnel's slab merge)."""
    import datetime
    import torch.distributed as dist
    from brutus_tpu_torch import BruteForce
    from brutus_tpu_torch.ops import _native, funnel
    from brutus_tpu_torch.parallel import initialize, make_mesh, shard_grid
    from brutus_tpu_torch.parallel import mesh as pmesh
    torch.set_num_threads(threads)
    cuda = device_type == "cuda"
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        backend, init_method=f"file://{rdv}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_COLLECTIVE_S))
    initialize()                         # sees the world as joined
    slab = dict(seconds=0.0, calls=0, bytes=0)

    def timed_all_reduce(x, op, group):
        """The funnel's all-reduces, timed (the slab merge is the large
        one)."""
        if x.is_cuda:
            torch.cuda.synchronize()
        t0 = time.time()
        y = pmesh.all_reduce(x, op, group)
        if y.is_cuda:
            torch.cuda.synchronize()
        if pmesh.group_size(group) > 1:
            slab["seconds"] += time.time() - t0
            slab["calls"] += 1
            slab["bytes"] += x.numel() * x.element_size()
        return y
    funnel.all_reduce = timed_all_reduce
    mc = np.load(os.path.join(out_dir, "grid.npy"), mmap_mode="r")
    labels = np.load(os.path.join(out_dir, "labels.npy"))
    dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
           else torch.device("cpu"))
    rec, meshes = {}, {}
    for name, path, shape, spec, batch, screen_k, n_sel, engine in jobs:
        # one mesh per shape, made by every rank in job order: a new mesh
        # makes new process groups, whose first collective sets up its
        # communicator
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape, devices=[dev] * world)
        mesh = meshes[shape]
        s = mesh_stars(mc, spec)
        if path in MESH_POLISH_CULL:
            local = shard_grid(mesh, mc)[0]
            _native.reset_launches()
            dist.barrier()
            rows, dt = polish_call(local, s, n_sel, MESH_POLISH_CULL[path],
                                   mesh.get_group("model"))
            rec[name] = dict(seconds=dt, transport=mesh.transport(),
                             launches={k: v.launches for k, v
                                       in _native.KERNELS.items()},
                             slab=dict(seconds=0.0, calls=0, bytes=0),
                             coords=mesh.coords)
            np.savez(os.path.join(out_dir, f"{name}.rank{rank}.npz"), **rows)
            del local
            continue
        bf = BruteForce(mc, labels, device=mesh.device)
        kw = fit_kwargs(s, batch, screen_k, n_sel, return_results=True,
                        mesh=mesh, **({} if engine is None
                                      else dict(engine=engine)))
        slab.update(seconds=0.0, calls=0, bytes=0)
        _native.reset_launches()
        dist.barrier()
        t0 = time.time()
        out = bf.fit(s["flux"], s["err"], np.ones(s["flux"].shape, bool),
                     **kw)
        if cuda:
            torch.cuda.synchronize()
        dt = time.time() - t0
        rec[name] = dict(seconds=dt, transport=mesh.transport(),
                         launches={k: v.launches
                                   for k, v in _native.KERNELS.items()},
                         slab=dict(slab), coords=mesh.coords)
        if rank == 0:
            np.savez(os.path.join(out_dir, f"{name}.npz"),
                     **{k: out[k] for k in MESH_KEYS})
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def mesh_world(n, backend, device_type, jobs, out_dir, threads=2):
    """Spawn a phase-14 world of `n` ranks on `jobs` and wait for it
    (killing it past `MESH_WORLD_S`); any rank's failure raises here.
    Returns each rank's records and rank 0's results by job."""
    import torch.multiprocessing as mp
    os.makedirs(out_dir, exist_ok=True)
    rdv = os.path.abspath(os.path.join(out_dir, "rdv"))
    if os.path.exists(rdv):
        os.remove(rdv)
    ctx = mp.start_processes(mesh_worker, args=(n, backend, device_type,
                                                rdv, jobs, out_dir, threads),
                             nprocs=n, join=False, start_method="spawn")
    t_end = time.time() + MESH_WORLD_S
    try:
        while not ctx.join(timeout=2):
            if time.time() > t_end:
                raise AssertionError(f"a phase-14 world of {n} ranks ran "
                                     f"past {MESH_WORLD_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    recs = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    outs = {}
    for job in jobs:
        files = ([f"{job[0]}.rank{r}.npz" for r in range(n)]
                 if job[1] in MESH_POLISH_CULL else [f"{job[0]}.npz"])
        parts = []
        for fname in files:
            with np.load(os.path.join(out_dir, fname)) as z:
                parts.append({k: z[k] for k in z.files})
        outs[job[0]] = parts if job[1] in MESH_POLISH_CULL else parts[0]
    return recs, outs


# Why a mesh's rows may differ from the single process's in the last
# place, by the axis that splits the work.
MESH_REASON = dict(
    data="each data rank fits a share of every batch, and the plain "
         "PyTorch stages' CUDA reductions round by an ulp differently "
         "for batches of other sizes",
    model="each rank sums over its shard of the grid, in another order "
          "than over the whole grid")


def mesh_compare(out, ref, n_model):
    """A mesh's fit against the single process's rows: equal bit for bit
    in `MESH_KEYS`, or else within the JAX package's limits (`MESH_*`)
    with every drawn model in the grid."""
    equal = all(np.array_equal(out[k], ref[k]) for k in MESH_KEYS)
    lev = np.allclose(out["log_evidence"], ref["log_evidence"],
                      rtol=MESH_EVID_TOL[0], atol=MESH_EVID_TOL[1])
    chi = np.allclose(out["chi2min"], ref["chi2min"], rtol=MESH_CHI2_TOL)
    agree = float(np.mean(out["model_idx"] == ref["model_idx"]))
    inside = bool(((out["model_idx"] >= 0)
                   & (out["model_idx"] < n_model)).all())
    dev = {k: float(np.max(np.abs(out[k].astype(float)
                                  - ref[k].astype(float))))
           for k in ("log_evidence", "chi2min", "dist", "red")}
    return dict(equal=equal, agree=agree, inside=inside, dev=dev,
                ok=bool(inside and (equal or (lev and chi
                                              and agree > MESH_AGREE))))


def polish_compare(parts, ref, shape):
    """The ranks' rows of a `polish` job (in rank order, which is the
    model order of `shard_grid` on a `1 x n` mesh) against one
    process's call: each field's max |dev| over the real models (the
    per-star `n_iter` of every rank) and whether all are equal bit for
    bit."""
    assert shape[0] == 1
    n = ref["lnlike"].shape[-1]
    dev = {}
    for f in MESH_POLISH_KEYS:
        if f == "n_iter":
            got = np.stack([p[f] for p in parts])
            want = np.broadcast_to(ref[f], got.shape)
        else:
            got = np.concatenate([p[f] for p in parts], axis=-1)[..., :n]
            want = ref[f]
        same = np.array_equal(got, want, equal_nan=True)
        d = np.abs(got.astype(float) - want.astype(float))
        dev[f] = 0.0 if same else float(np.nanmax(np.where(
            np.isnan(d), np.inf, d)))
    return dict(equal=all(v == 0.0 for v in dev.values()), dev=dev)


def polish_report(name, path, per, parts, ref, shape, worlds):
    """Log a `polish` job against one process's call and raise unless
    every field is equal bit for bit."""
    cmp = polish_compare(parts, ref["rows"], shape)
    secs = max(p["seconds"] for p in per)
    it = ref["rows"]["n_iter"]
    log(f"  phase 14 {name} ({worlds}): ops.optimize.loglike_grid, "
        f"polish_k={MESH_POLISH_K}, apply_init_cull="
        f"{MESH_POLISH_CULL[path]}, {len(it)} stars x "
        f"{ref['rows']['lnlike'].shape[-1]} models, one process "
        f"{ref['seconds']:.3f} s, the mesh {secs:.3f} s (transport "
        f"{per[0]['transport']}); iterations (magnitude, flux) per star "
        f"{it.tolist()}; max |dev| of the rank rows against one process "
        f"{cmp['dev']}: "
        + ("equal bit for bit" if cmp["equal"] else "NOT equal"))
    if not cmp["equal"]:
        raise AssertionError(f"phase 14 {name}: the rank rows differ from "
                             f"one process's loglike_grid")
    return dict(cmp=dict(cmp, agree=1.0), stars_per_s=len(it) / secs,
                seconds=secs, one_seconds=ref["seconds"],
                slab=per[0]["slab"], launches=[p["launches"] for p in per])


def mesh_report(recs, outs, jobs, refs, n_model, worlds, cuda=True):
    """Check and log each job of a world (on `cuda`, each rank must have
    launched its path's kernels); returns the summed launches and the
    job records."""
    total = {}
    res = {}
    for name, path, shape, spec, *_ in jobs:
        per = [r[name] for r in recs]
        idle = [(i, k) for i, p in enumerate(per) for k in MESH_KERNELS[path]
                if p["launches"][k] <= 0]
        if idle and cuda:
            raise AssertionError(f"phase 14 {name}: rank(s) launched no "
                                 f"{idle}")
        for p in per:
            for k, v in p["launches"].items():
                total[k] = total.get(k, 0) + v
        if path in MESH_POLISH_CULL:
            res[name] = polish_report(name, path, per, outs[name],
                                      refs[name], shape, worlds)
            continue
        n = len(outs[name]["model_idx"])
        cmp = mesh_compare(outs[name], refs[name], n_model)
        secs = max(p["seconds"] for p in per)
        sl = per[0]["slab"]
        res[name] = dict(cmp=cmp, stars_per_s=n / secs, seconds=secs,
                         slab=sl, launches=[p["launches"] for p in per])
        why = ("equal bit for bit" if cmp["equal"] else
               f"not bit-equal (max |dev| {cmp['dev']}: "
               f"{MESH_REASON['data' if shape[0] > 1 else 'model']}); held "
               f"to the JAX package's limits: model_idx agreement "
               f"{cmp['agree']:.4f}")
        log(f"  phase 14 {name} ({worlds}): {n} stars, "
            f"{n / secs:.1f} stars/s, {why}, drawn models in the grid "
            f"{cmp['inside']}, transport {per[0]['transport']}"
            + (f", slab merge {sl['calls']} all-reduces "
               f"{sl['bytes'] / 1e6:.1f} MB {1e3 * sl['seconds']:.1f} ms"
               if sl["calls"] else "")
            + ", launches per rank " + "; ".join(
                "/".join(f"{k}={p['launches'][k]}"
                         for k in MESH_KERNELS[path]) or "none"
                for p in per))
        if not cmp["ok"]:
            raise AssertionError(f"phase 14 {name} disagrees with the "
                                 f"single process")
    return total, res


def phase_mesh(mc, labels, dev, tiny, runs, xla):
    """Phase 14: `BruteForce.fit(mesh=...)` on this card: (a) a world of
    one (NCCL on the card, gloo on the CPU) on a 1 x 1 mesh, phase 4's
    first `batch` stars; (b)-(d) a world of two ranks on the one card
    over gloo (NCCL refuses two ranks on one device; gloo carries the
    CUDA tensors through host copies, every kernel still runs on the
    card), the jobs of `mesh_jobs`, each against the single process's
    rows of phases 4, 6 and 8 (`runs`, and `xla` for phase 8).  Returns
    the launches by kernel, summed over ranks and jobs, and the
    records."""
    out_dir = MESH_DIR
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "grid.npy"), mc)
    np.save(os.path.join(out_dir, "labels.npy"), labels)
    n4, b4, k, ns = (16, 8, 1024, 256) if tiny else (512, 128, 12288, 2048)
    one = [("(a) funnel 1x1", "funnel", (1, 1), (n4, 7, b4), b4, k, ns,
            None)]
    jobs = mesh_jobs(tiny)
    refs = mesh_refs(one + jobs, runs, xla)
    refs.update(polish_refs(jobs, mc, dev))
    t0 = time.time()
    recs, outs = mesh_world(1, "nccl" if dev.type == "cuda" else "gloo",
                            dev.type, one, out_dir)
    total, res = mesh_report(recs, outs, one, refs, len(mc),
                             "a world of one", dev.type == "cuda")
    res["world_one_s"] = time.time() - t0
    t0 = time.time()
    recs, outs = mesh_world(2, "gloo", dev.type, jobs, out_dir)
    t2, r2 = mesh_report(recs, outs, jobs, refs, len(mc),
                         "two ranks on one device", dev.type == "cuda")
    res.update(r2, world_two_s=time.time() - t0)
    for kname, v in t2.items():
        total[kname] = total.get(kname, 0) + v
    return dict(launches=total, jobs=res)


def mesh_refs(jobs, runs, xla):
    """The single process's rows of each phase-14 fit: phase 4 (funnel),
    6 (dense), 8 (the reference-semantics engines)."""
    src = dict(funnel=runs[4]["out"], dense=runs[6]["out"],
               xla_funnel=xla["funnel"]["out"],
               xla_dense=xla["dense_fit"]["out"])
    return {name: {k: src[path][k][:spec[2]] for k in MESH_KEYS}
            for name, path, shape, spec, *_ in jobs
            if path not in MESH_POLISH_CULL}


def polish_refs(jobs, mc, dev):
    """One process's `polish_call` on the whole grid on `dev` for each
    `polish` job: its rows and the seconds of a warm call (the first
    call is not timed)."""
    refs = {}
    grid = torch.as_tensor(mc, device=dev)
    for name, path, shape, spec, batch, screen_k, n_sel, engine in jobs:
        if path in MESH_POLISH_CULL:
            s = mesh_stars(mc, spec)
            cull = MESH_POLISH_CULL[path]
            polish_call(grid, s, n_sel, cull)
            rows, dt = polish_call(grid, s, n_sel, cull)
            refs[name] = dict(rows=rows, seconds=dt)
    del grid
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return refs


def mesh_main(dev, tiny):
    """`--mesh`: phase 14's paths on four cards over NCCL (1 x 4, 2 x 2
    and 4 x 1 meshes, and the funnel at 32768 stars on 4 x 1 and 1 x 4)
    against their single-process runs on card 0; with `--cpu --tiny`,
    four gloo processes on the CPU at the rehearsal's sizes."""
    from brutus_tpu_torch import BruteForce
    from brutus_tpu_torch.ops import _native
    t_all = time.time()
    cuda = dev.type == "cuda"
    n = torch.cuda.device_count() if cuda else 4
    if n < 4:
        print(f"chip_smoke --mesh: needs 4 CUDA devices, found {n}",
              file=sys.stderr)
        return 1
    card = nvidia_smi() if cuda else "CPU"
    log(f"phase 1 devices: {card} x {n}")
    if cuda:
        t0 = time.time()
        _native.build()
        _native.library()
        log(f"phase 2 build  [{time.time() - t0:.1f} s]")
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", 0)
    mc, labels = correlated_grid(4000 if tiny else 750_000, 8)
    jobs = mesh_jobs(tiny, four=True)
    refs, ones = {}, {}
    bf = BruteForce(mc, labels, device=dev)
    refs.update(polish_refs(jobs, mc, dev))
    for name, path, shape, spec, batch, screen_k, n_sel, engine in jobs:
        key = (path, spec, batch)
        if path in MESH_POLISH_CULL:
            continue
        if key not in ones:
            s = mesh_stars(mc, spec)
            extra = {} if engine is None else dict(engine=engine)
            fit_stars(bf, s, dev, batch, screen_k, n_sel, **extra)  # warm
            out, dt, _ = fit_stars(bf, s, dev, batch, screen_k, n_sel,
                                   **extra)
            ones[key] = ({k: out[k] for k in MESH_KEYS}, dt)
            log(f"  single process on one device, {path}: "
                f"{len(s['idx'])} stars in batches of {batch}, "
                f"{len(s['idx']) / dt:.1f} stars/s (warm)")
        refs[name] = ones[key][0]
    del bf
    if cuda:
        torch.cuda.empty_cache()
    out_dir = MESH_DIR + "_four"
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "grid.npy"), mc)
    np.save(os.path.join(out_dir, "labels.npy"), labels)
    t0 = time.time()
    # each job twice: the first run is cold (tables, first launches)
    jobs2 = [(name + suffix,) + j[1:] for j in jobs
             for name, suffix in ((j[0], " cold"), (j[0], ""))]
    recs, outs = mesh_world(4, "nccl" if cuda else "gloo", dev.type,
                            jobs2, out_dir, threads=2 if cuda else 1)
    refs2 = {j[0]: refs[j[0].replace(" cold", "")] for j in jobs2}
    _, res = mesh_report(recs, outs, jobs2, refs2, len(mc),
                         "four cards, NCCL" if cuda else "four CPU "
                         "processes, gloo", cuda)
    log(f"phase 14 --mesh: four-rank world {time.time() - t0:.1f} s  "
        f"[{time.time() - t_all:.1f} s total]")
    log(card)
    log(json.dumps({"mesh": {
        name: dict(stars_per_s=r["stars_per_s"], equal=r["cmp"]["equal"],
                   agree=r["cmp"]["agree"],
                   slab_ms=1e3 * r["slab"]["seconds"],
                   slab_mb=r["slab"]["bytes"] / 1e6)
        for name, r in res.items()},
        "single": {f"{k[0]} {k[1][2]}": len(v[0]["model_idx"]) / v[1]
                   for k, v in ones.items()},
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": n}}))
    return 0


# --profile: the fit paths, their settings and the kernels each runs,
# with their bounds at that path's shapes (750,080 padded models,
# 8 bands; funnel batches of 128 with 48 blocks of 256 per star,
# 27 table rows, a 15-row pack and 2048 selected models; dense batches
# of 16).
PATHS = {
    "funnel": dict(batch=128, screen_k=12288, kernel_rng=True, n=512),
    "funnel_fed": dict(batch=128, screen_k=12288, kernel_rng=False, n=512),
    "dense": dict(batch=16, screen_k=0, kernel_rng=True, n=256),
    # the reference-semantics engines (`engine="xla"`), at phase 8's
    # sizes
    "xla_funnel": dict(batch=128, screen_k=12288, kernel_rng=True, n=128,
                       engine="xla"),
    "xla_dense": dict(batch=8, screen_k=0, kernel_rng=True, n=16,
                      engine="xla"),
}


def path_fit(bf, s, dev, path):
    """`fit_stars` of the stars `s` with the settings of `PATHS[path]`."""
    p = PATHS[path]
    return fit_stars(bf, s, dev, p["batch"], p["screen_k"], 2048,
                     p["kernel_rng"], engine=p.get("engine", "fused"))
# K1's bounds take the share of pairs its freeze lets move on the path
# (`path_moving_shares`), K4's its valid and active columns per launch
# (`mc_columns`) and the card's clock.
PATH_KERNELS = {
    ("funnel", "screen_kernel"): ("screen", lambda sh: screen_bound(
        128, 750_080, 8, 256)),
    ("funnel", "gather_kernel"): ("gather", lambda sh: gather_bound(
        27, 128, 12288, 48)),
    ("funnel", "fit_kernel"): ("fit", lambda sh: fit_bound(
        128, 12288, 27, 8, 15, sh["fit"] * 128 * 12288)),
    ("funnel", K4_NAME): ("mc_rng", lambda sh: mc_bound(
        128, 2048, 50, *sh["mc"], True, sh["clock"])),
    ("funnel_fed", K4_NAME): ("mc_fed", lambda sh: mc_bound(
        128, 2048, 50, *sh["mc"], False, sh["clock"])),
    ("dense", "fit_kernel"): ("fit_dense", lambda sh: fit_dense_bound(
        16, 750_080, 8, sh["fit_dense"] * 16 * 750_080)),
    ("xla_funnel", "screen_kernel"): ("screen_xla", lambda sh: screen_bound(
        128, 750_080, 8, 256)),
    ("xla_funnel", "gather_kernel"): ("gather_xla", lambda sh: gather_bound(
        27, 128, 12288, 48)),
    **{(path, DRAWS_NAME): ("draws", lambda sh, b=B, k=K, z=z: draws_bound(
        b, k, 50, 250, z, sh["clock"])[:2]) for path, B, K, z in DRAW_PATHS},
}


def path_moving_shares(mc, labels, dev):
    """The share of (star, model) pairs K1's freeze lets move on each of
    its paths, from the first batch of the profile's fits: the funnel's
    shortlists of the first 128 of `stars(mc, 512)` and the dense
    engine's first 16 of `stars(mc, 256)`, through the plain versions.
    The profile's K1 bounds take them for every batch of the path."""
    from brutus_tpu_torch.config import FitConfig
    from brutus_tpu_torch.convert import from_numpy_grid
    from brutus_tpu_torch.ops import fit as TFD, funnel as TF
    cfg = FitConfig()
    F = mc.shape[1]
    shares = {}
    for name, n, b in (("fit", 512, 128), ("fit_dense", 256, 16)):
        s = stars(mc, n)
        t = lambda x: torch.as_tensor(x[:b], dtype=torch.float32,
                                      device=dev)
        mask = torch.ones((b, F), dtype=torch.bool, device=dev)
        fp, wf, mg, wm, mk, nd, tv = TF.prepare_star_data(
            t(s["flux"]), t(s["err"]), mask, cfg)
        star4 = torch.stack([fp, wf, mg, wm], 1).contiguous()
        srow3 = TF.post_consts(mk, nd, tv)
        if name == "fit":
            tabs = from_numpy_grid(mc, labels, device=dev)
            plx, plxw = TF._screen_parallax(t(s["plx"]), t(s["plxe"]))
            star2, srow5 = TF._screen_star_mats(mg, wm, plx, plxw)
            bidx, idx = TF._select_blocks(TF.screen_blocks(
                tabs.table, tabs.maskrow, star2, srow5, F, 256, cfg), 48, 256)
            chi2 = TF.fit_pack_plain(
                star4, TF.gather_slabs(tabs.table, bidx, 256),
                idx.contiguous(), srow3, 3, 15, -1, 512, no_polish(cfg))[:, 1]
        else:
            coeffs, _ = TFD.prepare_coeffs(mc, tile=512, device=dev)
            chi2 = TFD.fit_dense_plain(star4, coeffs, srow3, -1, 512,
                                       no_polish(cfg))[1]
        shares[name] = moving_pairs(chi2, 512, cfg) / chi2.numel()
    return shares


def mc_columns(bf, s, dev, batch=128, screen_k=12288, n_sel=2048):
    """K4's (star, model) columns per launch in a funnel fit of the stars
    `s`, averaged over its launches: `(valid, active)`, active at the
    skip tile the path passes."""
    from brutus_tpu_torch.ops import mc as TMC, posterior as TP
    calls = []
    orig = TP.mc_integrate

    def record(*a, **kw):
        v, tile = a[2] > 0.5, a[7]
        calls.append((int(v.sum().item()),
                      int(TMC.tile_flags(v, tile).sum().item()) * tile))
        return orig(*a, **kw)

    TP.mc_integrate = record
    try:
        fit_stars(bf, s, dev, batch, screen_k, n_sel)
    finally:
        TP.mc_integrate = orig
    return tuple(sum(c[i] for c in calls) / len(calls) for i in (0, 1))


def mc_code():
    """K4's code, per instance on the main paths (every prior on), from
    the build: registers and stack bytes (the `-Xptxas=-v` log), and the
    static SASS instructions and MUFU (special-function) instructions of
    the whole kernel and of its draw loop, its largest loop
    (`cuobjdump -sass`).  Instances are named by their template flags
    (mode, Galactic, feh, age, dust)."""
    from brutus_tpu_torch.ops import _native
    path, blog = _native.build()
    ptxas, cur = {}, None
    for line in blog.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = ptxas.setdefault(m.group(1), {})
        elif cur is not None:
            for key, pat in (("stack_bytes", r"(\d+) bytes stack frame"),
                             ("registers", r"Used (\d+) registers")):
                m = re.search(pat, line)
                if m:
                    cur.setdefault(key, int(m.group(1)))
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    funcs, code = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            code = None
            if re.search(K4_NAME, m.group(1)):
                code = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and code is not None:
            code.append((int(m.group(1), 16), m.group(2)))
    out = {}
    for name, ins in funcs.items():
        flags = "".join(re.findall(r"Lb([01])E", name))
        if flags and not flags.endswith("1111"):
            continue
        loop = []
        for addr, text in ins:
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
                loop = max(loop, body, key=len)
        mufu = lambda xs: sum("MUFU" in t for t in xs)
        out[flags or "one instance"] = dict(
            ptxas.get(name, {}), sass=len(ins),
            sass_mufu=mufu(t for _, t in ins), loop_sass=len(loop),
            loop_mufu=mufu(loop))
    return out


def profile_path(bf, s, dev, path, shares, quiet=False):
    """Device busy time, idle share, the top device events and the
    hand-written kernels' launches, ms and lost time of one warm fit of
    `path` under `torch.profiler`."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    t0 = time.time()
    with torch.profiler.profile(activities=act) as prof:
        path_fit(bf, s, dev, path)
    wall = time.time() - t0
    # Device-side events only (kernels and copies): the host operators
    # that launched them carry the same time again.
    cuda_type = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == cuda_type
              and _device_us(e) > 0]
    if quiet or not events:
        return None
    busy = sum(_device_us(e) for e in events) / 1e6
    top = sorted(events, key=_device_us, reverse=True)[:10]
    kernels = {}
    for (kp, key), (name, kbound) in PATH_KERNELS.items():
        hits = [e for e in events if kp == path and re.search(key, e.key)]
        if hits:
            n = sum(e.count for e in hits)
            ms = sum(_device_us(e) for e in hits) / 1e3 / n
            bms, by = kbound(shares)
            kernels[name] = dict(launches=n, ms=ms, bound_ms=bms,
                                 bound_by=by, lost_ms=n * (ms - bms))
    log(f"profiled {path} fit of {len(s['idx'])} stars: wall {wall:.3f} s, "
        f"device busy {busy:.4f} s, idle share {1 - busy / wall:.3f}")
    for e in top:
        log(f"  {_device_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return dict(wall_s=wall, device_busy_s=busy, idle_share=1 - busy / wall,
                top_device_ms={e.key[:60]: _device_us(e) / 1e3 for e in top},
                kernels=kernels)


def path_stars(mc):
    """The stars of the paths' fits, by count."""
    s = {n: stars(mc, n) for n in (256, 512)}
    s.update({n: stars(mc, n, seed=9) for n in (16, 128)})
    return s


def warm_rates(bf, s, dev, order):
    """Stars/s of warm fits of the paths in `order`, in that order, each
    path warmed up once first."""
    seconds = lambda path: path_fit(bf, s[PATHS[path]["n"]], dev, path)[1]
    for path in dict.fromkeys(order):
        seconds(path)
    rates = {path: [] for path in dict.fromkeys(order)}
    for path in order:
        rates[path].append(PATHS[path]["n"] / seconds(path))
    return rates


def rates_main(dev, rounds):
    """`--rates`: warm stars/s of the three fused paths in turns
    (`rounds` times funnel / fed / dense, then the same backwards), and
    the host operations of one warm funnel fit by their own CPU time.
    Uses nothing that the fit of an earlier slice lacks, so a copy of
    this script placed in an older checkout times that checkout's
    package the same way."""
    from brutus_tpu_torch import BruteForce
    card = nvidia_smi()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    mc, labels = correlated_grid(750_000, 8)
    bf = BruteForce(mc, labels, device=dev)
    s = path_stars(mc)
    turn = ("funnel", "funnel_fed", "dense")
    rates = warm_rates(bf, s, dev, (turn + turn[::-1]) * rounds)
    log(f"warm fits, stars/s in turns: {rates}")
    act = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=act) as prof:
        path_fit(bf, s[PATHS["funnel"]["n"]], dev, "funnel")
    ev = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    host = {e.key[:60]: dict(self_ms=e.self_cpu_time_total / 1e3,
                             count=e.count) for e in ev[:25]}
    log("host operations of one funnel fit of 512 stars, by own CPU time:")
    for k, v in host.items():
        log(f"  {v['self_ms']:9.3f} ms  x{v['count']:<6d} {k}")
    log(json.dumps(dict(card=card, stars_per_s=rates,
                        median={k: float(np.median(v))
                                for k, v in rates.items()},
                        funnel_host_ops=host)))
    return 0


def stage_ms(fn, stages):
    """Run `fn()` once with each function `stages[label] = [(module,
    name), ...]` bracketed by CUDA events at every call; returns each
    label's summed milliseconds on the stream (a stage called inside
    another counts in both)."""
    marks = {label: [] for label in stages}
    saved = []
    for label, sites in stages.items():
        for mod, name in sites:
            f = getattr(mod, name)
            saved.append((mod, name, f))

            def wrapped(*a, _f=f, _l=label, **k):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = _f(*a, **k)
                e.record()
                marks[_l].append((s, e))
                return out
            setattr(mod, name, wrapped)
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)
    return {k: sum(s.elapsed_time(e) for s, e in v) for k, v in
            marks.items()}


def busy_trace(fn):
    """Wall seconds, device busy seconds, idle share and the top device
    events of `fn()` under `torch.profiler`."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    t0 = time.time()
    with torch.profiler.profile(activities=act) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.time() - t0
    cuda_type = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == cuda_type
              and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in events) / 1e6
    top = sorted(events, key=_device_us, reverse=True)[:8]
    return dict(wall_s=wall, device_busy_s=busy,
                idle_share=1 - busy / wall if events else math.nan,
                top_device_ms={e.key[:60]: _device_us(e) / 1e3 for e in top})


def profile_generation(dev, rounds=2):
    """`--profile` for phases 11-12: warm `make_grid` (phase 11's grid)
    and warm `fit_cluster` (phase 12's held fit, 100 steps) timed in
    turns, and the stage split (CUDA events) and busy time of one
    `make_grid` chunk of single stars, one of binaries (smf 0.5: the
    bisection and the secondary, which single-star chunks skip), and
    one `fit_cluster` run of 10 steps."""
    from brutus_tpu_torch import cluster as TC
    from brutus_tpu_torch.models import nn as TN, sedmaker as TS
    from brutus_tpu_torch.models import tracks as TT
    from brutus_tpu_torch.models.sedmaker import extinction_lattice
    from brutus_tpu_torch.cluster import fit_cluster
    mk = synth_maker(synth_library(False), dev)
    kw = grid_kwargs(False)
    arrays = synth_isochrone_arrays(False)
    nn = smooth_nn_arrays()
    iso = synth_isochrone(arrays, dev, nn)
    data = synth_cluster(synth_isochrone(arrays, torch.device("cpu"), nn),
                         1000)
    ckw = dict(parallax=data["parallax"], parallax_err=data["parallax_err"],
               eep_grid=np.linspace(202.0, 808.0, 2000), n_walkers=32,
               bounds=HELD_BOUNDS, device=dev)

    def grid():
        t0 = time.time()
        mk.make_grid(**kw)
        return len(mk.grid_label) / (time.time() - t0)

    def cluster(n_steps=100):
        t0 = time.time()
        fit_cluster(iso, data["phot"], data["err"], n_steps=n_steps,
                    n_burn=n_steps // 2, **ckw)
        torch.cuda.synchronize()
        return 32 * n_steps / (time.time() - t0)

    grid(), cluster()
    rates = dict(make_grid_labels_per_s=[], fit_cluster_walker_steps_per_s=[])
    for _ in range(rounds):
        for name, f in (("make_grid_labels_per_s", grid),
                        ("fit_cluster_walker_steps_per_s", cluster),
                        ("fit_cluster_walker_steps_per_s", cluster),
                        ("make_grid_labels_per_s", grid)):
            rates[name].append(f())
    log(f"warm grid generation and cluster fit, in turns: {rates}")

    lattice, fit = extinction_lattice(dev)
    stages = {"interpolation": [(TT, "interpn"), (TS, "interpn")],
              "bisection": [(TS, "interp1d_monotone_bisect")],
              "networks": [(TN, "nneval_params")],
              "reddening fit": [(TS, "_wls_line")]}
    # Labels whose binaries of smf 0.5 have a secondary (mini * smf at
    # least the tracks' 0.5 Msun, EEP at most 480).
    g = mk.grid_label[(mk.grid_label["mini"] >= 1.0)
                      & (mk.grid_label["eep"] <= 480.0)][:8192]
    out = {}
    for what, smf in (("single stars", 0.0), ("binaries, smf 0.5", 0.5)):
        lab = {k: np.asarray(g[k]) for k in ("mini", "eep", "feh", "afe")}
        lab["smf"] = np.full(len(g), smf)

        copies = []

        def chunk():
            flat = mk.grid_rows(lab["mini"], lab["eep"], lab["feh"],
                                lab["afe"], lab["smf"], lattice, fit)
            c0 = torch.cuda.Event(enable_timing=True)
            c1 = torch.cuda.Event(enable_timing=True)
            c0.record()
            flat.cpu()
            c1.record()
            copies.append((c0, c1))
        chunk()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        split = stage_ms(chunk, stages)
        e1.record()
        torch.cuda.synchronize()
        split["copy to host"] = copies[-1][0].elapsed_time(copies[-1][1])
        out[what] = dict(chunk_ms=e0.elapsed_time(e1), stages_ms=split,
                         **busy_trace(chunk))
        log(f"make_grid chunk of 8192 {what}: {out[what]}")
    split = stage_ms(lambda: cluster(10), {
        "population SEDs": [(TC, "population_seds_multi")],
        "chi-square products": [(TC, "_chi2_cmd")],
        "log-pdf": [(TC, "_chi2_lnl")],
        "logsumexp": [(torch, "logsumexp")]})
    out["fit_cluster 10 steps"] = dict(stages_ms=split,
                                       **busy_trace(lambda: cluster(10)))
    log(f"fit_cluster, 10 steps: {out['fit_cluster 10 steps']}")
    return dict(rates=rates, traces=out)


def profile_main(dev):
    """`--profile`: where the time of each fit path goes (module
    docstring)."""
    from brutus_tpu_torch import BruteForce
    from brutus_tpu_torch.convert import (default_grid_lnprior,
                                          dense_tables, from_numpy_grid)
    card = nvidia_smi()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    mc, labels = correlated_grid(750_000, 8)
    t0 = time.time()
    lnp = default_grid_lnprior(labels)
    setup = dict(prior_s=time.time() - t0)
    for name, build in (("funnel_tables_s", from_numpy_grid),
                        ("dense_tables_s", dense_tables)):
        t0 = time.time()
        build(mc, labels, device=dev, lnprior=lnp)
        torch.cuda.synchronize()
        setup[name] = time.time() - t0
    log(f"host set-up per fit call: {setup}")

    bf = BruteForce(mc, labels, device=dev)
    s = path_stars(mc)
    rates = warm_rates(bf, s, dev, (
        "funnel", "funnel_fed", "funnel_fed", "funnel", "dense", "dense",
        "xla_funnel", "xla_dense", "xla_dense", "xla_funnel"))
    log(f"warm fits, stars/s in turns: {rates}")
    n_big = 4096
    big = n_big / path_fit(bf, stars(mc, n_big, seed=8), dev, "funnel")[1]
    log(f"funnel fit of {n_big} stars: {big:.1f} stars/s")

    # The profiler's first window carries its own start-up (seconds of
    # wall): profile once untimed.
    shares = path_moving_shares(mc, labels, dev)
    shares["mc"] = mc_columns(bf, s[512], dev)
    shares["clock"] = sm_clock_mhz()
    log(f"K1 pairs moving in the polish, by path; K4's valid and active "
        f"columns per launch on the funnel; max SM clock: {shares}")
    code = mc_code()
    log(f"K4 code by instance (flags: random numbers, Galactic, feh, age, "
        f"dust): {code}")
    profile_path(bf, s[512], dev, "funnel", shares, quiet=True)
    prof = {path: profile_path(bf, s[p["n"]], dev, path, shares)
            for path, p in PATHS.items()}
    if any(v is None for v in prof.values()):
        log("profiler recorded no device time: breakdown not measured")
        return 1
    order = sorted(((k, v) for p in prof.values()
                    for k, v in p["kernels"].items()),
                   key=lambda kv: -kv[1]["lost_ms"])
    log("kernels by launches x (ms - bound) on their path:")
    for k, v in order:
        log(f"  {k:10s} {v['launches']:3d} x ({v['ms']:.4f} - "
            f"{v['bound_ms']:.4f} ms, {v['bound_by']}) = "
            f"{v['lost_ms']:.3f} ms")
    generation = profile_generation(dev)
    log(json.dumps(dict(card=card, setup=setup, stars_per_s=rates,
                        funnel_big_stars=n_big, funnel_big_stars_per_s=big,
                        path_shares=shares, mc_code=code, profiles=prof,
                        generation=generation)))
    return 0


# The kernel instances of the main paths (K1 and K2 at F=8, windows of
# 512, the dense kernel's star group; K3; K4 with every prior on):
# registers and local memory per thread.
INSTANCES = ("screen", "fit", "fit_dense", "gather", "mc_rng", "mc_fed",
             "draws")


def kernel_attrs(name, F):
    """Registers and local bytes per thread of a kernel instance: K1 and
    K2 at F filters, K3, and K4 in each mode with every prior on (the
    main path's instances)."""
    from brutus_tpu_torch.ops import _native
    if name == "screen":
        r = _native.attributes("bk_screen_attrs", F)
    elif name == "gather":
        r = _native.attributes("bk_gather_attrs")
    elif name == "draws":
        r = _native.attributes("bk_draws_attrs", 0)
    elif name.startswith("mc_"):
        r = _native.attributes("bk_mc_attrs", int(name == "mc_rng"), 1, 1,
                               1, 1)
    else:
        r = _native.attributes("bk_fit_attrs", F, 512,
                               int(name == "fit_dense"))
    return dict(registers=r[0], local_bytes=r[1])


# The kernels the funnel runs (phase 11's generated grid, phase 13).
FUNNEL_KERNELS = ("screen", "gather", "fit", "mc_rng", "draws")
# The phase whose run each kernel's launches are read from.
KERNEL_PHASE = dict(screen=4, gather=4, fit=4, mc_rng=4, mc_fed=5,
                    fit_dense=6, draws=4)
# Phase 4 as first ported, with fed normals (NVIDIA H100 80GB HBM3,
# 700 W; PERF.md).
FIRST_STARS_PER_S = "813.8 to 1111.7 stars/s over three card runs"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse phases 4-13 on the CPU (plain versions)")
    ap.add_argument("--tiny", action="store_true",
                    help="a 4000-model grid (padded, as the full one), 16 "
                         "stars, coarse grid-generation and cluster sizes")
    ap.add_argument("--profile", action="store_true",
                    help="time and profile each fit path on the card "
                         "instead of the smoke phases")
    ap.add_argument("--rates", type=int, default=0, metavar="ROUNDS",
                    help="time warm fits of the three fused paths in turns "
                         "on the card instead of the smoke phases")
    ap.add_argument("--mesh", action="store_true",
                    help="phase 14's paths on four cards over NCCL (1 x 4, "
                         "2 x 2, 4 x 1) against one card, instead of the "
                         "smoke phases")
    args = ap.parse_args()
    t_all = time.time()
    if args.mesh:
        return mesh_main(torch.device("cpu" if args.cpu else "cuda"),
                         args.tiny)
    if args.cpu:
        dev = torch.device("cpu")
        # The rehearsal's tensors are small: on 8 cores all threads
        # took 28 s against two threads' 47 s when idle, and 579 s
        # against 327 s beside five other multi-threaded jobs.
        torch.set_num_threads(min(2, torch.get_num_threads()))
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device (use --cpu --tiny to "
                  "rehearse on the CPU)", file=sys.stderr)
            return 1
        dev = torch.device("cuda")
        if args.profile:
            return profile_main(dev)
        if args.rates:
            return rates_main(dev, args.rates)

    from brutus_tpu_torch.ops import _native
    card = None
    attrs = {}
    if dev.type == "cuda":
        t0 = time.time()
        card = nvidia_smi()
        log(f"phase 1 card: {card}  [{time.time() - t0:.1f} s]")
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"python {sys.version.split()[0]}")
        t0 = time.time()
        path, blog = _native.build()
        _native.library()
        log(f"phase 2 build: {path} ({len(_native.sources())} sources, "
            f"one nvcc call; ptxas reports {blog.count('Used ')} kernel "
            f"instances)  [{time.time() - t0:.1f} s]")
        for name, F in [(n, 8) for n in INSTANCES] + [("fit", 49)]:
            a = kernel_attrs(name, F)
            if F == 8:
                attrs[name] = a
            at = f" at F={F}" if name in ("screen", "fit", "fit_dense") else ""
            log(f"  {name}{at}: {a['registers']} registers, "
                f"{a['local_bytes']} bytes of local memory per thread")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    M = 4000 if args.tiny else 750_000
    mc, labels = correlated_grid(M, 8)
    log(f"grid: {M} models x 8 bands, correlated lattice  "
        f"[{time.time() - t0:.1f} s]")

    results = {}
    if dev.type == "cuda":
        phase_kernels(mc, labels, dev, results)

    runs = {}
    t0 = time.time()
    n_star, batch = (16, 8) if args.tiny else (512, 128)
    screen_k, n_sel = (1024, 256) if args.tiny else (12288, 2048)
    r = runs[4] = phase_fit(mc, labels, dev, n_star, batch, screen_k, n_sel)
    log(f"phase 4 main path: BruteForce.fit, funnel, in-kernel draws, {M} "
        f"models x 8 bands x {n_star} stars in batches of {batch}: "
        f"{r['stars_per_s']:.1f} stars/s (as first ported, fed normals: "
        f"{FIRST_STARS_PER_S}), true model among the draws for "
        f"{r['recall']:.3f} of the stars, median distance bias "
        f"{r['dist_bias']:+.4f}, p90 |bias| {r['dist_p90']:.4f}, "
        f"launches {r['launches']}  [{time.time() - t0:.1f} s]")

    t0 = time.time()
    n_fed = 8 if args.tiny else 64
    r = runs[5] = phase_fit(mc, labels, dev, n_fed, batch, screen_k, n_sel,
                            kernel_rng=False)
    log(f"phase 5 funnel, fed normals: {n_fed} stars, "
        f"{r['stars_per_s']:.1f} stars/s, median distance bias "
        f"{r['dist_bias']:+.4f}, launches {r['launches']}  "
        f"[{time.time() - t0:.1f} s]")

    t0 = time.time()
    n_dense, batch_d = (16, 8) if args.tiny else (256, 16)
    r = runs[6] = phase_fit(mc, labels, dev, n_dense, batch_d, 0, n_sel)
    log(f"phase 6 dense path: BruteForce.fit(screen_k=0), {M} models x 8 "
        f"bands x {n_dense} stars in batches of {batch_d}: "
        f"{r['stars_per_s']:.1f} stars/s, median distance bias "
        f"{r['dist_bias']:+.4f}, p90 |bias| {r['dist_p90']:.4f}, finite "
        f"log-evidences {r['finite_evidence']:.3f}, launches "
        f"{r['launches']}  [{time.time() - t0:.1f} s]")

    t0 = time.time()
    n_x, batch_x, n_chk, batch_chk = ((16, 8, 8, 8) if args.tiny
                                      else (128, 128, 16, 8))
    x = phase_xla(mc, labels, dev, n_x, batch_x, screen_k, n_chk, batch_chk)
    runs[8] = x["funnel"]
    fr, dr = x["funnel"], x["dense_fit"]
    log(f"phase 8 reference-semantics funnel: BruteForce.fit(engine="
        f"\"xla\", screen_k={screen_k}), {M} models x 8 bands x {n_x} "
        f"stars in batches of {batch_x}: {fr['stars_per_s']:.1f} stars/s, "
        f"median distance bias {fr['dist_bias']:+.4f}, p90 |bias| "
        f"{fr['dist_p90']:.4f}, launches {fr['launches']}; dense reference "
        f"engine (screen_k=0) on the first {n_chk} stars in batches of "
        f"{batch_chk}: {dr['stars_per_s']:.1f} stars/s, median distance "
        f"bias {dr['dist_bias']:+.4f}; funnel likelihoods on those stars "
        f"against the reference engine in float64 on the host on each "
        f"star's shortlist ({x['ref_seconds']:.1f} s; fields as |dev| / "
        f"{XLA_TOL}; held: a share {XLA_SHARE_TOL} of models with a field "
        f"past its limit): "
        f"{_acc_text(x['f64'])}; TF32-rounded control (must miss them): "
        f"{_acc_text(x['control'])}; the dense engine against itself in "
        f"float64 on the device, held alike: {_acc_text(x['dense64'])}; its "
        f"TF32-rounded control: {_acc_text(x['dense_control'])}; best "
        f"against the dense engine's maximum {x['best_gap']:.4g} nats for "
        f"the {x['on_list']} stars whose dense maximum is shortlisted, "
        f"{x['best_gap_all']:.4g} over all (reported: the lattice's "
        f"near-degenerate models move the convergence tests, as in the "
        f"JAX package), every shortlisted model against the dense engine "
        f"{_acc_text(x['dense'])}  [{time.time() - t0:.1f} s]")
    if not x["ok"]:
        raise AssertionError("the reference-semantics funnel disagrees with "
                             "the float64 reference engine, the dense "
                             "engine with its float64 run, or a control "
                             "passed")

    t0 = time.time()
    r = phase_rest(mc, labels, dev, stars(mc, n_star), batch, screen_k,
                   n_sel, runs[4]["out"])
    runs[9] = r["scan"]
    log(f"phase 9 rest of BruteForce on the funnel: {n_star} stars in "
        f"batches of {batch}, lnprior_ext on feh (std 0.1 around each "
        f"star's true model), return_sel: scan_batches=2 "
        f"{r['scan']['stars_per_s']:.1f} stars/s, scan_batches=1 "
        f"{r['one']['stars_per_s']:.1f} stars/s, rows identical {r['same']}, "
        f"drawn models among the selections {r['sel_ok']}; median |feh(draw)"
        f" - feh(true)| {r['feh_ext']:.4f} with the prior, {r['feh_base']:.4f}"
        f" without (phase 4); _fit's first {batch} tuples equal the rows "
        f"{r['gen_ok']}; median distance bias {r['scan']['dist_bias']:+.4f},"
        f" launches {r['scan']['launches']}; resume not run here (it "
        f"writes HDF5 and the card machine has no h5py; tested on the CPU)"
        f"  [{time.time() - t0:.1f} s]")
    if not (r["ok"] and r["feh_ext"] < r["feh_base"]):
        raise AssertionError("scan_batches, return_sel, lnprior_ext or _fit "
                             "failed its check")

    t0 = time.time()
    fb = phase_fallback(dev, args.tiny, screen_k, n_sel)
    runs[10] = fb
    log(f"phase 10 fallback past 2**24 models: {fb['M']} models x 8 bands "
        f"(float32, grid made in {fb['grid_s']:.1f} s), "
        f"{len(fb['out']['model_idx'])} stars planted at index >= "
        f"{fb['limit']}, one batch: {fb['stars_per_s']:.1f} stars/s, drawn "
        f"indices in [{fb['limit']}, {2 * fb['limit']}) {fb['above']}, odd "
        f"among them {fb['odd']}, every drawn model in its star's shortlist "
        f"{fb['in_short']}, median distance bias {fb['dist_bias']:+.4f}, "
        f"launches {fb['launches']}"
        + (" (rehearsal: 4096 models, stars planted past 2048)"
           if args.tiny else "") + f"  [{time.time() - t0:.1f} s]")
    if not fb["ok"]:
        raise AssertionError("the integer grid-index path was not taken")

    t0 = time.time()
    g = runs[11] = phase_grid(dev, args.tiny, screen_k, n_sel)
    chk = g["check"]
    log(f"phase 11 grid generation: SEDmaker.make_grid on "
        f"{'the card' if dev.type == 'cuda' else 'the CPU'} in float64, "
        f"{g['n_grid']} labels (tables built in {g['build_s']:.1f} s), "
        f"{g['gen_s']:.2f} s, {g['labels_per_s']:.1f} labels/s, peak "
        f"device memory {g['peak_gib']:.3f} GiB; valid share (grid_sel) "
        f"{g['valid_share']:.4f}; {chk['n_sample']} seeded labels "
        f"regenerated on the host in float64: validity and "
        f"NaN pattern equal {chk['same_pattern']}, max |dev| of the "
        f"finite coefficients {chk['coeff_dev']:.3g} mag and predictions "
        f"{chk['param_dev']:.3g} (tol {GRID_TOL}); funnel on its "
        f"{g['n_models']} valid models, {len(g['out']['model_idx'])} stars: "
        f"{g['stars_per_s']:.1f} stars/s, true model among the draws for "
        f"{g['recall']:.3f} of the stars, median distance bias "
        f"{g['dist_bias']:+.4f}, p90 |bias| {g['dist_p90']:.4f}, K4's "
        f"valid columns {g['mc_valid_share']:.4f} (active at tiles of 512 "
        f"{g['mc_active_share']:.4f}), launches {g['launches']}; "
        f"reported, the reference-semantics funnel on its first "
        f"{g['n_xla']} stars against the host "
        f"in float64: {_acc_text(g['xla']['f64'])}, against the dense "
        f"reference engine: {_acc_text(g['xla']['dense'])}, best against "
        f"the dense maximum {g['xla']['best_gap']:.4g} nats for the "
        f"{g['xla']['on_list']} stars whose maximum is shortlisted, "
        f"{g['xla']['best_gap_all']:.4g} over all  "
        f"[{time.time() - t0:.1f} s]")
    if not chk["ok"]:
        raise AssertionError("the card's grid disagrees with the host's")

    n_steps, n_burn = (20, 10) if args.tiny else (1000, 500)
    for net, arrays in (("smooth_nn_arrays", smooth_nn_arrays()),
                        ("phase 11's network (the control)", None)):
        t0 = time.time()
        c = phase_cluster(dev, args.tiny, n_steps, n_burn, arrays)
        control = arrays is None
        log(f"phase 12 cluster fit on {net}: Isochrone built in "
            f"{c['build_s']:.1f} s, {c['n_obj']} stars (5% field); the "
            f"likelihood at {CLUSTER_THETAS} seeded thetas against the "
            f"host in float64, max relative dev through isochrone_loglike "
            f"{c['dev_one']:.3g}, through fit_cluster's posterior in one "
            f"call (groups of {c['group']}) {c['dev_batch']:.3g} (tol "
            f"{LOGLIKE_TOL}; values {[round(v, 2) for v in c['loglikes']]},"
            f" {c['check_s']:.1f} s); bounds {HELD_BOUNDS}, "
            + fit_text(c, n_steps, n_burn)
            + (" (rehearsal: not held)" if args.tiny else
               " (must not be recovered)" if control else "")
            + f"  [{time.time() - t0:.1f} s]")
        if max(c["dev_one"], c["dev_batch"]) > LOGLIKE_TOL:
            raise AssertionError("the cluster likelihood on the card "
                                 "disagrees with the host's")
        if not args.tiny and c["rec"]["recovered"] == control:
            raise AssertionError(
                "the recovery check passed the control's plateau fit"
                if control else "fit_cluster did not recover the cluster")

    t0 = time.time()
    runs[13] = phase_apps(mc, labels, dev, args.tiny, 128, screen_k, n_sel)
    report_apps(runs[13], args.tiny, t0)

    t0 = time.time()
    runs[14] = phase_mesh(mc, labels, dev, args.tiny, runs, x)
    j = runs[14]["jobs"]
    log(f"phase 14 device mesh: BruteForce.fit(mesh=...) and "
        f"loglike_grid(polish_k=..., model_group=...) on {M} models, "
        f"(a) a world of one over "
        f"{'NCCL' if dev.type == 'cuda' else 'gloo'} "
        f"({j['world_one_s']:.1f} s), (b)-(d) two ranks on one "
        f"{'card' if dev.type == 'cuda' else 'CPU'} over gloo "
        f"({j['world_two_s']:.1f} s): every path's rows "
        + ("equal the single process's bit for bit"
           if all(v["cmp"]["equal"] for v in j.values()
                  if isinstance(v, dict)) else
           "within the JAX package's limits (not all bit-equal; above)")
        + f", launches {runs[14]['launches']}  "
        f"[{time.time() - t0:.1f} s]")

    kernels = []
    for name, k in _native.KERNELS.items():
        entry = dict(name=name, route="cuda", source=k.source,
                     replaces=k.replaces,
                     launches=runs[KERNEL_PHASE[name]]["launches"][name],
                     launches_by_phase={
                         ph: runs[ph]["launches"][name]
                         for ph in sorted(runs)
                         if runs[ph]["launches"][name]})
        entry.update(results.get(name, {}))
        entry.update(attrs.get(name, {}))
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    if dev.type == "cpu":
        log(f"phase 7 rehearsal done on the CPU (plain versions; no kernel "
            f"launched)  [{time.time() - t_all:.1f} s total]")
        return 0
    missing = [e["name"] for e in kernels if e["launches"] <= 0]
    if missing:
        raise AssertionError(f"no launch of {missing} on its path")
    if runs[4]["launches"]["mc_fed"] or runs[5]["launches"]["mc_rng"]:
        raise AssertionError("K4 ran in the wrong mode")
    idle = [k for k in FUNNEL_KERNELS if runs[11]["launches"][k] <= 0]
    if idle:
        raise AssertionError(f"no launch of {idle} on the generated grid")
    idle = [k for k in FUNNEL_KERNELS if runs[13]["launches"][k] <= 0
            or not runs[13]["trace"]["kernels"][k]]
    if idle:
        raise AssertionError(f"no launch of {idle} in phase 13's fit, or "
                             f"none in its trace")
    log(f"phase 7 every kernel ran on its path  "
        f"[{time.time() - t_all:.1f} s total]")
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
