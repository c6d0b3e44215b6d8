"""One run of one cell: set-up, the measured (or traced) window of
`BruteForce.fit` calls, the comparison with the reference, the result.

Everything particular to a cell is data found by name: the cell's entry
in `BENCHMARK.json` names its configuration (`configs/<config>.json`)
and traffic mix (`traffic/<traffic>.json`); `workloads/<cell>.json`
holds the cell's own settings (calls traced, rows kept per call, stars
compared, the limits of the compared numbers); each per-layer metric is
read by `metrics/<metric>.py`.
"""

import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "brutus_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def spec(cell, root=ROOT, shrink=None):
    """The cell's entry, configuration, traffic mix, own settings and
    the benchmark's metric entries.  `shrink` (tests on the CPU only)
    updates sections of the configuration (`grid`, `fit`), the
    `traffic` mix and the `settings`."""
    bench = load_json(root, "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}[cell]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    here = os.path.join(root, bench["paths"][0])
    out = dict(bench=bench, entry=entry,
               config=load_json(root, conf["file"]),
               traffic=load_json(here, "traffic", entry["traffic"] + ".json"),
               settings=load_json(here, "workloads", cell + ".json"),
               here=here)
    for key, new in (shrink or {}).items():
        part = out["config"] if key in ("grid", "fit") else out
        part[key] = dict(part[key], **new)
    return out


def metrics_of(bench, cell, trace):
    """Names of the metrics the cell reports: with `trace` its per-layer
    metrics, else its end-to-end ones."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return [m["name"] for m in e2e]
    moved = {m["name"] for m in e2e}
    listed = lambda m: (cell in m["workloads"] if "workloads" in m
                        else m["moves"] in moved)
    return [m["name"] for m in bench["per_layer"] if listed(m)]


def reader(here, name):
    path = os.path.join(here, "metrics", name + ".py")
    s = importlib.util.spec_from_file_location("gpubench_metric_" + name,
                                               path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def fit_kwargs(config, cat, dmap, seed):
    kw = dict(config["fit"])
    kw.update(parallax=cat["plx"], parallax_err=cat["plxe"],
              data_coords=cat["coords"], dustmap=dmap, save_file=None,
              verbose=False, return_results=True, seed=seed)
    return kw


def call_seed(seed, i):
    """The `seed=` of call `i` of a run with `--seed` `seed` (`i` -1:
    the warm-up call): no two calls of a run share one."""
    return int(np.random.default_rng([seed, 9, i + 1]).integers(2 ** 62))


class Cell:
    """A cell's inputs and its program objects on `device`."""

    def __init__(self, cell, seed, device, root=ROOT, shrink=None):
        from . import traffic
        self.s = spec(cell, root, shrink)
        self.name, self.seed, self.device = cell, int(seed), device
        self.mc, self.labels, self.dmap, self.cats = traffic.make(
            self.s["config"], self.s["traffic"], self.seed)
        from brutus_tpu_torch import BruteForce
        self.bf = BruteForce(self.mc, self.labels, device=device)
        self.kept, self.sizes = [], []
        self.rng = np.random.default_rng([self.seed, 5])

    def call(self, i, keep=True, k=None):
        """Fit call `i` (of catalogue `k`; by default the cycle of
        catalogues, in turn) with its own `seed=`; keeps the rows the
        seed picks for the comparison."""
        k = i % len(self.cats) if k is None else k
        cat = self.cats[k]
        out = self.bf.fit(cat["flux"], cat["err"], cat["mask"],
                          **fit_kwargs(self.s["config"], cat, self.dmap,
                                       call_seed(self.seed, i)))
        n = len(cat["flux"])
        if keep:
            from .check import keep_rows
            per = min(n, self.s["settings"]["keep_rows_per_call"])
            rows = np.sort(self.rng.choice(n, per, replace=False))
            rec = keep_rows(out, rows)
            self.kept += [(k, int(r), {key: v[j] for key, v in rec.items()})
                          for j, r in enumerate(rows)]
            self.sizes.append((i, k, n))
        return n

    def warm(self):
        """One call at the largest of the cell's calls."""
        big = int(np.argmax([len(c["flux"]) for c in self.cats]))
        self.call(-1, keep=False, k=big)


def now():
    return time.perf_counter()


def window(cell, seconds, sync):
    """Calls one after another until `seconds` have passed; the window
    ends when the last call returns, and, where the calls' sizes vary,
    at the end of a whole cycle of them (the same sizes for every seed),
    so that every run does the same work.  Returns the call durations,
    the stars and the window's length."""
    durs, stars = [], 0
    cycle = (len(cell.cats) if "fixed" not in cell.s["traffic"]["call_stars"]
             else 1)
    t0 = now()
    i = 0
    while True:
        t1 = now()
        stars += cell.call(i)
        sync()
        t2 = now()
        durs.append(t2 - t1)
        i += 1
        if t2 - t0 >= seconds and i % cycle == 0:
            return durs, stars, t2 - t0


def traced(cell, n_calls, sync):
    """`n_calls` calls under `torch.profiler` (host and card), each in
    a `gpubench.call` span; returns the parsed trace and the calls."""
    import torch
    from . import tracing
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    calls = []
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(n_calls):
            with torch.profiler.record_function("gpubench.call"):
                n = cell.call(i)
            sync()
            calls.append(i)
    t0 = now()
    tmp = tempfile.mkdtemp(prefix="gpubench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        t1 = now()
        tr = tracing.Trace(path)
        print(f"trace: written in {t1 - t0:.1f} s "
              f"({os.path.getsize(path) / 2 ** 20:.0f} MiB), read in "
              f"{now() - t1:.1f} s", file=sys.stderr)
        return tr, calls
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(cell_name, seed, seconds, trace, t_start, device="cuda",
        root=ROOT, shrink=None):
    """One run of `cell_name`; returns the result line's object.  The
    caller has checked the card (`device` "cpu", `root` and `shrink`
    only in tests)."""
    import torch
    from . import check
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cell = Cell(cell_name, seed, device, root, shrink)
    if cuda:
        from brutus_tpu_torch.ops import _native
        _native.build()
    cell.warm()
    sync()
    setup_s = now() - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    want = metrics_of(cell.s["bench"], cell_name, trace)
    metrics, device_info, breakdown = {}, {}, None
    units = {m["name"]: m["unit"] for m in
             cell.s["bench"]["end_to_end"] + cell.s["bench"]["per_layer"]}
    if trace:
        t0 = now()
        tr, calls = traced(cell, cell.s["settings"]["trace_calls"], sync)
        ctx = tr.context(cell, calls)
        print(f"trace: {now() - t0:.1f} s to here", file=sys.stderr)
        for name in want:
            v = reader(cell.s["here"], name)(ctx)
            if v is not None:
                metrics[name] = {"value": v, "unit": units[name]}
        if cuda:
            device_info = dict(busy_s=ctx.busy_s, window_s=ctx.window_s)
        breakdown = tr.breakdown(ctx)
        attempted = len(calls)
        print(f"trace: {now() - t0:.1f} s with the metrics", file=sys.stderr)
    else:
        durs, stars, win = window(cell, seconds, sync)
        values = dict(stars_per_s=stars / win,
                      call_p90_ms=1e3 * float(np.percentile(durs, 90)),
                      setup_s=setup_s)
        for name in want:
            metrics[name] = {"value": values[name], "unit": units[name]}
        attempted = len(durs)
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    # the program's state goes before the reference runs
    cell.bf = None
    if cuda:
        torch.cuda.empty_cache()
    largest = max(cell.sizes, key=lambda x: x[2])[1]
    last = cell.sizes[-1][1]
    st = cell.s["settings"]
    records = check.sample(cell.kept, st["check_stars"], seed, largest, last)
    values = check.numbers(records, cell.cats, cell.mc, cell.labels,
                           cell.dmap, cell.s["config"]["fit"], device, seed)
    correct, checks = check.judge(values, st["limits"])
    result = dict(correct=correct, attempted=attempted, failed=0,
                  metrics=metrics)
    result["device"] = dict(platform="gpu" if cuda else "cpu",
                            kind=(torch.cuda.get_device_name(0) if cuda
                                  else "cpu"),
                            count=1, memory_peak_bytes=peak, **device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {k: v for k, v in values.items()
                          if k not in checks}
    result["checks"] = checks
    return result
