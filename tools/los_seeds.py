#!/usr/bin/env python3
"""How often `fit_clouds` finds both clouds of a 2048-star sightline.

    python3 tools/los_seeds.py --seeds 10 14                 # the port, CPU
    python3 tools/los_seeds.py --seeds 0 48 --device cuda    # the port, card
    python3 tools/los_seeds.py --seeds 10 14 --package jax   # the JAX package

A synthetic sightline with the layout of `chip_smoke.py` phase 13:
distance moduli uniform over 6.5-13.5, Av = 0.2 + 0.8 [mu > 8.5] + 0.7
[mu > 11.0] + N(0, 0.05), 25 draws per star with distance-modulus errors
of 0.2 mag and reddening errors of 0.1.  For each seed, one two-cloud
`fit_clouds` at its defaults without the evidence ladder (64 walkers,
1500 steps, 750 burn-in), on `brutus_tpu_torch` (on `--device`, whose
card it names) or on `brutus_tpu` (`--package jax`, on the CPU).
Prints each MAP, whether both clouds lie within 0.5 of 8.5 and 11.0, and
the count.  Run it from the repository's root with
`PYTHONPATH=.`.
"""

import argparse
import time

import numpy as np

STEPS = (8.5, 11.0)


def sightline(n, seed=13):
    r = np.random.default_rng(seed)
    dm = r.uniform(6.5, 13.5, n)
    av = (0.2 + 0.8 * (dm > STEPS[0]) + 0.7 * (dm > STEPS[1])
          + r.normal(size=n) * 0.05)
    return (dm[:, None] + r.normal(0, 0.2, (n, 25)),
            av[:, None] + r.normal(0, 0.1, (n, 25)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs=2, default=(10, 18),
                    metavar=("FIRST", "STOP"))
    ap.add_argument("--stars", type=int, default=2048)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--package", choices=("torch", "jax"), default="torch",
                    help="the port (torch) or the JAX package's fit_clouds")
    args = ap.parse_args()
    if args.device.startswith("cuda"):
        import subprocess
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip(), flush=True)
    ds, rs = sightline(args.stars)
    if args.package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        from brutus_tpu.los import fit_clouds
        kw, pkg = {}, "brutus_tpu"
    else:
        from brutus_tpu_torch.los import fit_clouds
        kw, pkg = dict(device=args.device), "brutus_tpu_torch"
    found = []
    for seed in range(*args.seeds):
        t0 = time.time()
        m = fit_clouds(ds, rs, 2, seed=seed, **kw)["map_theta"]
        both = bool(abs(m[4] - STEPS[0]) < 0.5 and abs(m[6] - STEPS[1]) < 0.5)
        found.append(both)
        print(f"{pkg} seed {seed}: MAP {np.round(m, 3).tolist()} both "
              f"steps {both} ({time.time() - t0:.0f} s)", flush=True)
    print(f"{pkg}: both steps in {sum(found)} of {len(found)} seeds "
          f"({args.stars} stars)", flush=True)


if __name__ == "__main__":
    main()
