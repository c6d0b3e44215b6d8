"""Readings the limits of `correct` are set from: the compared numbers
of the program on many seeds, and of the control (the reference in TF32
in the program's place) on some, in one process on one card.

    python3 gpubench/readings.py --workload funnel.survey16k \\
        --seeds 11 12 13 --control 11 12 13

Each seed makes its cell's inputs, fits as many of its calls as a run
needs to compare as many stars (the calls a short window at the cell's
own load makes), and prints one JSON line: the seed, the program's
numbers and, for the `--control` seeds, the control's.  The benchmark's
own runs do not run this.
"""

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, nargs="*", default=[])
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from gpubench import cell, check
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    for seed in a.seeds:
        t0 = time.perf_counter()
        c = cell.Cell(a.workload, seed, "cuda")
        st = c.s["settings"]
        n = max(2, math.ceil(st["check_stars"] / st["keep_rows_per_call"]))
        sizes = [len(x["flux"]) for x in c.cats]
        for i in range(max(n, len(sizes))):
            c.call(i)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        c.bf = None
        torch.cuda.empty_cache()
        largest = max(c.sizes, key=lambda x: x[2])[1]
        recs = check.sample(c.kept, st["check_stars"], seed, largest,
                            c.sizes[-1][1])
        args = (recs, c.cats, c.mc, c.labels, c.dmap, c.s["config"]["fit"],
                "cuda", seed)
        t1 = time.perf_counter()
        out = dict(seed=seed, calls=len(c.sizes), fit_s=fit_s,
                   program=check.numbers(*args))
        out["reference_s"] = time.perf_counter() - t1
        if seed in a.control:
            t1 = time.perf_counter()
            out["control"] = check.numbers(*args, prec="tf32")
            out["control_s"] = time.perf_counter() - t1
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
