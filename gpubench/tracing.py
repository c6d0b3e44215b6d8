"""Reduction of a `torch.profiler` Chrome trace to what the per-layer
metric readers (`metrics/*.py`) and the result's `breakdown` read.

The benchmark's own span, `gpubench.call`, marks each traced call.
Device events are kernels, copies and memsets; each kernel's launch on
the host is the runtime event with the same correlation id.
"""

import bisect
import json

import numpy as np

HAND_WRITTEN = ("screen_kernel", "gather_kernel", "fit_kernel", "mc_kernel")
SPAN = "gpubench.call"


class Trace:
    def __init__(self, path):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        self.kernels, self.copies, self.memsets = [], [], []
        self.launch_ts, self.host, self.spans = {}, [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat"), float(e["ts"]), float(e.get("dur", 0))
            args = e.get("args", {})
            if cat == "kernel":
                self.kernels.append((e["name"], ts, dur,
                                     args.get("correlation")))
            elif cat == "gpu_memcpy":
                self.copies.append((e["name"], ts, dur))
            elif cat == "gpu_memset":
                self.memsets.append((e["name"], ts, dur))
            elif cat in ("cuda_runtime", "cuda_driver"):
                if "correlation" in args:
                    self.launch_ts[args["correlation"]] = ts
                self.host.append((ts, ts + dur, e["name"]))
            elif cat == "user_annotation" and e["name"] == SPAN:
                self.spans.append((ts, ts + dur))
            elif cat == "cpu_op":
                self.host.append((ts, ts + dur, e["name"]))
        self.spans.sort()
        self.kernels.sort(key=lambda k: k[1])
        self.host.sort()

    def context(self, cell, calls):
        return Context(self, cell, calls)

    def breakdown(self, ctx, top=10):
        """The device operations that took most time, and the idle time
        of the card summed by what the host was running in each gap."""
        by = {}
        for name, _, dur, *_ in ctx.kernels + ctx.copies + ctx.memsets:
            by[name] = by.get(name, 0.0) + dur * 1e-6
        ops = sorted(by.items(), key=lambda x: -x[1])[:top]
        starts = [h[0] for h in self.host]
        idle = {}
        for g0, g1 in ctx.gaps:
            mid = 0.5 * (g0 + g1)
            i = bisect.bisect_right(starts, mid) - 1
            label = "host code outside torch ops"
            # the innermost host operation running at the gap's middle:
            # the latest to start that has not ended (a few steps back)
            for j in range(i, max(i - 64, -1), -1):
                if self.host[j][1] >= mid:
                    label = self.host[j][2]
                    break
            idle[label] = idle.get(label, 0.0) + (g1 - g0) * 1e-6
        gaps = sorted(idle.items(), key=lambda x: -x[1])[:top]
        return dict(device_ops=[[n[:120], v] for n, v in ops],
                    idle_gaps=[[n[:120], v] for n, v in gaps])


class Context:
    """What a metric reader reads: the traced calls (`calls`: start and
    end in us, stars, the usable band count of each star and its
    batches), the device events inside the traced window, the kernels'
    launch times, the device's busy union and idle gaps, and the cell
    (configuration, grid sizes, engine)."""

    def __init__(self, tr, cell, call_ids):
        cfg = cell.s["config"]
        self.config = cfg
        self.engine = "dense" if cfg["fit"].get("screen_k", 1) == 0 \
            else "funnel"
        self.n_model, self.n_band = cell.mc.shape[0], cell.mc.shape[1]
        self.batch_size = cfg["fit"]["batch_size"]
        self.calls = []
        for (t0, t1), i in zip(tr.spans, call_ids):
            cat = cell.cats[i % len(cell.cats)]
            self.calls.append(dict(t0=t0, t1=t1, n=len(cat["flux"]),
                                   bands=cat["mask"].sum(1)))
        self.t0 = self.calls[0]["t0"]
        self.t1 = self.calls[-1]["t1"]
        inside = lambda ev: [e for e in ev if self.t0 <= e[1] <= self.t1]
        self.kernels = inside(tr.kernels)
        self.copies = inside(tr.copies)
        self.memsets = inside(tr.memsets)
        self.launch_ts = tr.launch_ts
        self.stars = sum(c["n"] for c in self.calls)
        self.window_s = (self.t1 - self.t0) * 1e-6
        spans = sorted((e[1], min(e[1] + e[2], self.t1)) for e in
                       self.kernels + self.copies + self.memsets)
        busy, gaps, cur = 0.0, [], None
        last_end = self.t0
        for a, b in spans:
            if cur is None or a > cur[1]:
                if cur is not None:
                    busy += cur[1] - cur[0]
                if a > last_end:
                    gaps.append((last_end, a))
                cur = [a, b]
            else:
                cur[1] = max(cur[1], b)
            last_end = max(last_end, cur[1])
        if cur is not None:
            busy += cur[1] - cur[0]
        if self.t1 > last_end:
            gaps.append((last_end, self.t1))
        self.busy_s = busy * 1e-6
        self.gaps = gaps

    def kernels_named(self, key):
        return [k for k in self.kernels if key in k[0]]

    def in_call(self, events, call):
        return [e for e in events if call["t0"] <= e[1] <= call["t1"]]

    def per_kstar(self, seconds):
        return seconds * 1e3 / (self.stars / 1e3)


def device_seconds(events):
    return float(np.sum([e[2] for e in events])) * 1e-6 if events else 0.0
