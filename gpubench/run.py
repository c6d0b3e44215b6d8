"""Run one cell of the benchmark of `brutus_tpu_torch` once.

    python3 gpubench/run.py --workload funnel.survey16k --seed 7 \\
        --seconds 40 --trace 0

Prints, as the last line of standard output, one JSON object: whether
the timed calls' results agree with the plain reference (`correct`),
the calls made (`attempted`, `failed`), the cell's end-to-end metrics
(`--trace 0`) or its per-layer metrics read from a `torch.profiler`
trace (`--trace 1`), the card and its peak memory, and each compared
number beside its limit (`checks`, also the last lines on standard
error).  Needs a CUDA card; exits non-zero without one, and without
the program beside this folder.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# One process with few threads, on fixed cores: the host's share of
# every call (Python, launches, numpy) is most of its time.
THREADS = 4
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_v] = str(THREADS)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_limit():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    try:
        cores = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, cores[:THREADS])
    except (AttributeError, OSError):
        pass
    import torch
    torch.set_num_threads(THREADS)
    from gpubench import cell
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        entry = {w["name"]: w for w in json.load(f)["workloads"]}[a.workload]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"needs {entry['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = cell.run(a.workload, a.seed, a.seconds, bool(a.trace), T_START)
    result["device"]["power_limit"] = card_limit()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
