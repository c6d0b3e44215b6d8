#!/usr/bin/env python3
"""Smoke run of `brutus_tpu_torch` on one NVIDIA H100.

    python3 chip_smoke.py               # the card run (needs one CUDA card)
    python3 chip_smoke.py --cpu --tiny  # rehearsal: phases 4-7 on the CPU
    python3 chip_smoke.py --profile     # where each fit path's time goes

Phases, each printing one line with its elapsed seconds:

1. the card's name and power limit (`nvidia-smi`);
2. build of the CUDA kernels (one nvcc call, `build/kernels/`), and the
   registers and local memory per thread of the instances of the main
   paths (K1 and K2 at F=8, K3, K4 in both modes with every prior on)
   and of K1's run-time-F instance;
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
   models, with its special functions on either pipe, `mc_bound`);
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
7. a `kernels` JSON line: each kernel's launches during the path that
   runs it (phase 4, 5 or 6; each must be > 0) and its phase-3
   deviation and times; the registers and local bytes per thread of
   each (K4: of the main path's instance), for K1 the share of pairs
   moving in the polish, for K4 its time and bound at 16 stars.

Any failure exits non-zero.  The last line of a card run is the device
record `{"ok": true, "device": {...}}`.

`--profile` runs none of these phases.  On the card, at the same grid
and fit settings, it prints the host set-up each `fit` call repeats,
warm fits timed in turns (funnel / funnel with fed normals / funnel
with fed normals / funnel at 512 stars, dense twice at 256, then the
funnel at 4096), per path a `torch.profiler` trace of one warm fit
(device time by kernel, busy time, idle share), and each hand-written
kernel's launches x (ms - bound) on the path that runs it (K1's bound
from the share of pairs moving on the path's first batch, K4's from its
valid and active columns per launch), the order
in which kernel redesigns would win the most time back; the last line
is one JSON object with these numbers.  The script imports nothing of
JAX nor of the JAX package; its grid generator is its own copy of the
correlated lattice the repository's JAX benchmark uses.
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


def stars(mc, n_star, seed=7):
    """Observations of random grid models at 0.3-3 kpc, with Av that
    follows the smoke dust map, 60-sigma photometry and 10% parallaxes."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, mc.shape[0], n_star)
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
MC_RNG_OPS, MC_RNG_SFU = 2 * 100 + 23, 7
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


def fit_stars(bf, s, dev, batch, screen_k, n_sel_max, kernel_rng=True):
    """One `BruteForce.fit` of the stars `s`: the funnel (`screen_k`
    below the grid size) or the dense engine (`screen_k=0`).
    `kernel_rng=False` switches the funnel's MC kernel to fed normals
    through `PosteriorConfig`, as the JAX package's drive recipe
    switches its own flags.  Returns the results, the seconds to the
    final synchronise, and the launch counts of this fit alone."""
    import functools
    from brutus_tpu_torch import fitting
    from brutus_tpu_torch.ops import _native
    kw = dict(parallax=s["plx"], parallax_err=s["plxe"],
              data_coords=s["coords"], dustmap=smoke_dustmap(),
              batch_size=batch, screen_k=screen_k, screen_block=256,
              n_sel_max=n_sel_max, Nmc_prior=50, Ndraws=250, tile=512,
              save_file=None, verbose=False, return_results=True)
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
              kernel_rng=True):
    """A cold `fit_stars` of `n_star` stars, checked: finite outputs of
    the expected shapes and a median distance bias below 25%."""
    from brutus_tpu_torch import BruteForce
    s = stars(mc, n_star)
    out, dt, launches = fit_stars(BruteForce(mc, labels, device=dev), s,
                                  dev, batch, screen_k, n_sel_max,
                                  kernel_rng)
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
    if not abs(bias) < 0.25:
        raise AssertionError(f"posterior distances are off: median "
                             f"bias {bias:+.3f}")
    return dict(seconds=dt, stars_per_s=n / dt, recall=recall,
                dist_bias=bias, dist_p90=p90, launches=launches,
                finite_evidence=float(np.isfinite(out["log_evidence"]).mean()))


# --profile: the fit paths, their settings and the kernels each runs,
# with their bounds at that path's shapes (750,080 padded models,
# 8 bands; funnel batches of 128 with 48 blocks of 256 per star,
# 27 table rows, a 15-row pack and 2048 selected models; dense batches
# of 16).
PATHS = {
    "funnel": dict(batch=128, screen_k=12288, kernel_rng=True, n=512),
    "funnel_fed": dict(batch=128, screen_k=12288, kernel_rng=False, n=512),
    "dense": dict(batch=16, screen_k=0, kernel_rng=True, n=256),
}
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
    ("funnel", "mc_kernel"): ("mc_rng", lambda sh: mc_bound(
        128, 2048, 50, *sh["mc"], True, sh["clock"])),
    ("funnel_fed", "mc_kernel"): ("mc_fed", lambda sh: mc_bound(
        128, 2048, 50, *sh["mc"], False, sh["clock"])),
    ("dense", "fit_kernel"): ("fit_dense", lambda sh: fit_dense_bound(
        16, 750_080, 8, sh["fit_dense"] * 16 * 750_080)),
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


def mc_columns(bf, s, dev):
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
        fit_stars(bf, s, dev, 128, 12288, 2048)
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
            if "mc_kernel" in m.group(1):
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
    p = PATHS[path]
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    t0 = time.time()
    with torch.profiler.profile(activities=act) as prof:
        fit_stars(bf, s, dev, p["batch"], p["screen_k"], 2048,
                  p["kernel_rng"])
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
        hits = [e for e in events if kp == path and key in e.key]
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
    s = {n: stars(mc, n) for n in (256, 512)}
    seconds = lambda path, st: fit_stars(
        bf, st, dev, PATHS[path]["batch"], PATHS[path]["screen_k"], 2048,
        PATHS[path]["kernel_rng"])[1]
    for path, p in PATHS.items():                   # warm-up
        seconds(path, s[p["n"]])
    rates = {path: [] for path in PATHS}
    for path in ("funnel", "funnel_fed", "funnel_fed", "funnel", "dense",
                 "dense"):
        n = PATHS[path]["n"]
        rates[path].append(n / seconds(path, s[n]))
    log(f"warm fits, stars/s in turns: {rates}")
    n_big = 4096
    big = n_big / seconds("funnel", stars(mc, n_big, seed=8))
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
    log(json.dumps(dict(card=card, setup=setup, stars_per_s=rates,
                        funnel_big_stars=n_big, funnel_big_stars_per_s=big,
                        path_shares=shares, mc_code=code, profiles=prof)))
    return 0


# The kernel instances of the main paths (K1 and K2 at F=8, windows of
# 512, the dense kernel's star group; K3; K4 with every prior on):
# registers and local memory per thread.
INSTANCES = ("screen", "fit", "fit_dense", "gather", "mc_rng", "mc_fed")


def kernel_attrs(name, F):
    """Registers and local bytes per thread of a kernel instance: K1 and
    K2 at F filters, K3, and K4 in each mode with every prior on (the
    main path's instances)."""
    from brutus_tpu_torch.ops import _native
    if name == "screen":
        r = _native.attributes("bk_screen_attrs", F)
    elif name == "gather":
        r = _native.attributes("bk_gather_attrs")
    elif name.startswith("mc_"):
        r = _native.attributes("bk_mc_attrs", int(name == "mc_rng"), 1, 1,
                               1, 1)
    else:
        r = _native.attributes("bk_fit_attrs", F, 512,
                               int(name == "fit_dense"))
    return dict(registers=r[0], local_bytes=r[1])


# The phase whose run each kernel's launches are read from.
KERNEL_PHASE = dict(screen=4, gather=4, fit=4, mc_rng=4, mc_fed=5,
                    fit_dense=6)
# Phase 4 as first ported, with fed normals (NVIDIA H100 80GB HBM3,
# 700 W; PERF.md).
FIRST_STARS_PER_S = "813.8 to 1111.7 stars/s over three card runs"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse phases 4-7 on the CPU (plain versions)")
    ap.add_argument("--tiny", action="store_true",
                    help="a 4096-model grid and 16 stars")
    ap.add_argument("--profile", action="store_true",
                    help="time and profile each fit path on the card "
                         "instead of the smoke phases")
    args = ap.parse_args()
    t_all = time.time()
    if args.cpu:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device (use --cpu --tiny to "
                  "rehearse on the CPU)", file=sys.stderr)
            return 1
        dev = torch.device("cuda")
        if args.profile:
            return profile_main(dev)
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
    M = 4096 if args.tiny else 750_000
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

    kernels = []
    for name, k in _native.KERNELS.items():
        entry = dict(name=name, route="cuda", source=k.source,
                     replaces=k.replaces,
                     launches=runs[KERNEL_PHASE[name]]["launches"][name])
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
    log(f"phase 7 every kernel ran on its path  "
        f"[{time.time() - t_all:.1f} s total]")
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
