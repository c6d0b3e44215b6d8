#!/usr/bin/env python3
"""Where the time of `brutus_tpu_torch.BruteForce.fit` goes, on one card.

    python3 tools/profile_fit.py

Uses `chip_smoke.py`'s 750,000-model correlated grid, stars and dust
map and the fit settings of its phase 4 (batches of 128, screen_k
12288, n_sel_max 2048, Nmc 50, 250 draws).  Prints:

- the host set-up every `fit` call repeats: the default grid prior and
  the device tables (`convert.from_numpy_grid`);
- the wall time of a warm `fit` of 512 and of 4096 stars, as stars/s,
  so the set-up's share shows;
- a `torch.profiler` trace of a warm 512-star `fit`: device time by
  kernel or operator (top 12), the device's busy time and its idle
  share of the wall time.

The last line is one JSON object with these numbers.  Needs a CUDA
card; imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import correlated_grid, smoke_dustmap, stars  # noqa: E402
from brutus_tpu_torch import BruteForce  # noqa: E402
from brutus_tpu_torch.convert import (default_grid_lnprior,  # noqa: E402
                                      from_numpy_grid)


def fit_seconds(bf, s, dev):
    kw = dict(parallax=s["plx"], parallax_err=s["plxe"],
              data_coords=s["coords"], dustmap=smoke_dustmap(),
              batch_size=128, screen_k=12288, screen_block=256,
              n_sel_max=2048, Nmc_prior=50, Ndraws=250, verbose=False,
              return_results=True)
    t0 = time.time()
    bf.fit(s["flux"], s["err"], np.ones(s["flux"].shape, bool), **kw)
    torch.cuda.synchronize()
    return time.time() - t0


N_BIG = 4096


def main():
    if not torch.cuda.is_available():
        print("profile_fit: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    mc, labels = correlated_grid(750_000, 8)
    t0 = time.time()
    lnp = default_grid_lnprior(labels)
    t_prior = time.time() - t0
    t0 = time.time()
    from_numpy_grid(mc, labels, device=dev, lnprior=lnp)
    torch.cuda.synchronize()
    t_tables = time.time() - t0
    print(f"host set-up per fit call: grid prior {t_prior:.3f} s, device "
          f"tables {t_tables:.3f} s", flush=True)

    bf = BruteForce(mc, labels, device=dev)
    s512, sbig = stars(mc, 512), stars(mc, N_BIG, seed=8)
    fit_seconds(bf, s512, dev)                      # warm-up
    t512 = fit_seconds(bf, s512, dev)
    tbig = fit_seconds(bf, sbig, dev)
    print(f"fit: 512 stars {t512:.3f} s ({512 / t512:.1f} stars/s); "
          f"{N_BIG} stars {tbig:.3f} s ({N_BIG / tbig:.1f} "
          f"stars/s)", flush=True)

    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    t0 = time.time()
    with torch.profiler.profile(activities=act) as prof:
        fit_seconds(bf, s512, dev)
    wall = time.time() - t0
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    # Device-side events only (kernels and copies): the host operators
    # that launched them carry the same time again.
    cuda_type = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == cuda_type
              and dev_us(e) > 0]
    if not events:
        print("profiler recorded no device time: breakdown not measured")
        return 1
    busy = sum(dev_us(e) for e in events) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:12]
    print(f"profiled 512-star fit: wall {wall:.3f} s, device busy "
          f"{busy:.4f} s, idle share {1 - busy / wall:.3f}", flush=True)
    for e in top:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}",
              flush=True)
    print(json.dumps(dict(
        card=card, setup_prior_s=t_prior, setup_tables_s=t_tables,
        fit512_s=t512, fit512_stars_per_s=512 / t512,
        fit_big_stars=N_BIG, fit_big_s=tbig,
        fit_big_stars_per_s=N_BIG / tbig, profiled_wall_s=wall,
        device_busy_s=busy, idle_share=1 - busy / wall,
        top_device_ms={e.key[:60]: dev_us(e) / 1e3 for e in top})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
