"""Kernels: the dense fit kernel K1's share of its roofline, in %: the
least time for fitting every star of the traced calls against every
padded model, over the device time of the fit kernels launched inside
the program's `bf.likelihood` spans; nothing outside the dense engine.

The least time is a frozen copy of the repository's
`chip_smoke.fit_dense_bound` with `gpubench/counts.py`'s two changes:
each star's pair work counted with its own usable bands, and no
polish re-expansions (`moving` 0, a lower bound).  One launch fits one
batch: it reads the table (3 coefficients x F bands x Mp models) and
its stars' inputs (4F + 3 each) once, writes 11 rows per (star,
model), and takes the per-model term once."""

from gpubench import counts
from gpubench.spans import launched_in, program_spans
from gpubench.tracing import device_seconds

TILE = 512
N_OUT = 11


def launch_work(bands, Mp, F):
    """`(bytes, operations)` of one launch over the stars whose usable
    band counts are `bands`."""
    B = len(bands)
    nbytes = 4 * (3 * F * Mp + N_OUT * B * Mp + B * (4 * F + 3))
    ops = sum(Mp * counts.fit_ops(f)[0] for f in bands)
    return nbytes, ops + Mp * counts.fit_ops(F)[2]


def least_seconds(calls, Mp, F, batch_size):
    """The least time of the calls' launches, one per batch."""
    total = 0.0
    for call in calls:
        bands = list(call["bands"])
        for i in range(0, len(bands), batch_size):
            total += counts.bound(*launch_work(bands[i:i + batch_size],
                                               Mp, F))[0]
    return total


def read(ctx):
    if ctx.engine != "dense" or not ctx.kernels:
        return None
    spans = program_spans(ctx)
    if not spans:
        return None
    ev = [k for k in launched_in(ctx, spans, "bf.likelihood")
          if "fit_kernel" in k[0]]
    if not ev:
        return None
    Mp = -(-ctx.n_model // TILE) * TILE
    least = least_seconds(ctx.calls, Mp, ctx.n_band, ctx.batch_size)
    return 100.0 * least / device_seconds(ev)
