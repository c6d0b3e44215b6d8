"""The program's own spans and counters, for the per-layer readers that
split a call by stage.

`brutus_tpu_torch.profiling.calls()` keeps a record of every `fit` call
made while a profiler records: its counters, its `bf.*` spans (name,
start, end) and the time of each hand-written kernel's launch, all on
the host's `time.time_ns()` clock.  The trace holds the same launches
on its own clock (the runtime event of each kernel), so the median gap
between the two places the records on the trace's clock, where the
card's kernels and idle gaps are.  Where the program keeps no records
(a program without them), every helper returns None and the readers
report nothing.

The records stand in for the trace's own `bf.*` events, which
`tracing.Trace` does not keep: once it keeps them (and the bytes of
each host-to-device copy), the readers can read both from the trace
and the records' times can go.
"""

import bisect
import sys

import numpy as np

from gpubench.tracing import HAND_WRITTEN


def records(ctx):
    """The records of the traced calls, oldest first, or None."""
    try:
        from brutus_tpu_torch import profiling
        recs = profiling.calls()
    except (ImportError, AttributeError):
        return None
    n = len(ctx.calls)
    return recs[-n:] if n and len(recs) >= n else None


def counter(recs, name):
    """A counter summed over the records."""
    return sum(r["counters"].get(name, 0) for r in recs)


def durations_ms(recs, name):
    """Per call, the summed length of its spans called `name`, in ms."""
    return [sum(t1 - t0 for n, t0, t1 in r["spans"] if n == name) * 1e-6
            for r in recs]


def median_span_ms(ctx, name):
    """Median over the traced calls of the time in spans `name`."""
    recs = records(ctx)
    if recs is None:
        return None
    per = [d for d, r in zip(durations_ms(recs, name), recs)
           if any(s[0] == name for s in r["spans"])]
    return float(np.median(per)) if per else None


def offset_us(ctx, recs):
    """What to add to a record's time (ns / 1e3) to place it on the
    trace's clock: the median, over the traced calls' hand-written
    kernel launches, of the launch's runtime event time less the time
    the record noted for it (the k-th launch of a call in both).  None,
    with a warning on standard error, where a call's launches cannot be
    paired."""
    gaps = []
    for i, (call, rec) in enumerate(zip(ctx.calls, recs)):
        ev = sorted(ctx.launch_ts[k[3]] for k in ctx.in_call(
            ctx.kernels, call) if k[3] in ctx.launch_ts
            and any(n in k[0] for n in HAND_WRITTEN))
        noted = [t for _, t in rec.get("kernel_launches", ())]
        if not ev or len(ev) != len(noted):
            print(f"spans: traced call {i} has {len(ev)} hand-written "
                  f"kernel launches in the trace and {len(noted)} in the "
                  "program's record; its spans are not placed",
                  file=sys.stderr)
            return None
        gaps += [a - t * 1e-3 for a, t in zip(ev, noted)]
    return float(np.median(gaps))


def program_spans(ctx):
    """The traced calls' spans `(name, t0, t1)` on the trace's clock (us),
    each call's `bf.fit` included, sorted by start (outer first); None
    where there are no records or no device events to place them by."""
    recs = records(ctx)
    if recs is None:
        return None
    off = offset_us(ctx, recs)
    if off is None:
        return None
    out = []
    for r in recs:
        out.append(("bf.fit", r["t0"] * 1e-3 + off, r["t1"] * 1e-3 + off))
        out += [(n, t0 * 1e-3 + off, t1 * 1e-3 + off)
                for n, t0, t1 in r["spans"]]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def launched_in(ctx, spans, name):
    """The traced kernels whose runtime launch falls inside a span
    `name` (spans on the trace's clock)."""
    iv = sorted((a, b) for n, a, b in spans if n == name)
    starts = [a for a, _ in iv]
    out = []
    for k in ctx.kernels:
        t = ctx.launch_ts.get(k[3])
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= iv[i][1]:
            out.append(k)
    return out


def overlap_us(intervals, spans):
    """Length of the intervals `(a, b)` that `spans` `(a, b)` cover, each
    a list of disjoint intervals."""
    spans = sorted(spans)
    total, j = 0.0, 0
    for a, b in sorted(intervals):
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            total += max(0.0, min(b, spans[k][1]) - max(a, spans[k][0]))
            k += 1
    return total
